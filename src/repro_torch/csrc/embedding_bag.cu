// Multi-hot embedding bag for Hopper (sm_90a):
//   out[b, j] = sum_h table[idx[b, h], j]
// over a [V, d] float32 table and [n_bags, hot] int32 ids. An id outside
// [0, V) contributes 0 and is never read; the sum is taken in float32,
// from 0, h = 0 .. hot-1 in order, as the plain version and the
// reference's _bag_kernel do.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/embedding_bag.py
// :: embedding_bag_pallas.
//
// What bounds it on an H100: bytes. One call reads the ids once
// (4 * hot bytes a bag), reads each distinct valid row of the table once
// from HBM (4 * d bytes; repeats of a hot row hit L1 or L2), and writes
// 4 * d bytes a bag; the work is one float add per (bag, h, j), far below
// the card's 67 TFLOP/s float32 line. With recsys ids (a few thousand hot
// rows) the kernel is a stream: ids in, sums out.
//
// Design: the Pallas kernel mapped the whole table (plus one appended zero
// row) into one VMEM block and padded the batch to its block size. On
// Hopper a 149 MB table cannot sit in 227 KB of shared memory, so rows are
// gathered through the read-only path (__ldg) and L2; nothing is padded or
// copied. The two streams are staged:
// - Persistent grid: as many blocks as fit on the SMs at once walk the
//   tiles of R bags with stride gridDim.x.
// - Ids in: one producer thread (lane 0 of the block's last warp) copies
//   each tile's R * hot ids (contiguous, R * hot * 4 bytes) into a ring of
//   shared-memory stages with one bulk copy (cp.async.bulk) with an L2
//   evict-first policy, behind full/empty mbarriers, as ell_tiles.cuh does
//   for the ELL tables. The gathered table rows keep the normal policy.
// - Gathers: a consumer thread sums K bags of a tile (K = 8 / C for rows
//   of C <= 8 floats, else 1; bags 32 apart, so a warp's accesses are
//   contiguous). It reads their ids from shared memory and issues the
//   gathers of two rows' C columns of all K bags (8- or 16-byte loads
//   where d and the table's address allow) before it adds any.
// - Sums out: each warp writes its 32·K bags' d sums into its part of a
//   shared output tile (two buffers, alternating), fences them for the
//   async proxy and has one lane store them with one bulk copy
//   (cp.async.bulk.global.shared::cta.bulk_group): full lines, no partial
//   writes. Before a buffer is written again, that lane waits until the
//   bulk copy that last read it has read it (wait_group.read 1).
// - Unstaged: the ragged last tile (fewer than R bags; its byte counts
//   need not be multiples of 16), an ids array that does not start on a
//   16-byte boundary (a view such as idx[3:]), and a plan of 0 stages
//   (tiles too large for shared memory) read their ids with plain loads;
//   without stages the sums are stored with plain stores too. The order of
//   the sum is the same everywhere.
// Ids outside [0, V) (the reference's pad row id == V included) are
// masked before the read.
//
// The tile plan (R bags a tile, S stages, the dynamic shared memory) is
// computed once, in Python (repro_torch.kernels.bag_tile_plan), and passed
// in; the launcher checks it against the same bags-a-thread rule.
//
// Wide rows (d >= 32 floats; the rule is repro_torch.kernels.bag_path):
// the GNNs' message passing gathers rows of 75 to 6,272 floats with bags of
// one id. There a thread a bag walks its row alone (65,536 threads at
// Equiformer-v2's 65,536 × 6,272 chunk, each warp instruction touching 32
// rows 25 KB apart), and the tile plan of a 6,272-float row has no stages.
// So these rows take another kernel, bag_rows_gather: a row is split over
// a warp's lanes (row_slabs.cuh: lane j takes columns j·VEC, (j + 32)·VEC,
// ..., 16-byte loads where d % 4 == 0 and the table and output allow), a
// row wider than a slab over several warps, one warp a (G bags, slab)
// item. Each lane issues the loads of its G bags' U vectors before it adds
// any; the sums are stored with streaming stores. The sum is the same as
// above, from 0, h in order, so both paths give the same bits.

#include <climits>
#include <cstdint>

#include "bulk_copy.cuh"
#include "row_slabs.cuh"

namespace {

constexpr int kMaxThreads = 256;  // consumer threads of a block
constexpr int kMaxStages = 8;
constexpr int kWarp = 32;
constexpr int kHotBatch = 2;      // rows whose gathers are issued together

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&a)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    a[0] = t.x;
    a[1] = t.y;
    a[2] = t.z;
    a[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    a[0] = t.x;
    a[1] = t.y;
  } else {
    a[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* a) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
  } else {
    *p = a[0];
  }
}

// The bags-a-thread rule of the plan (kernels.bag_tile_plan): K bags a
// thread, so that a thread gathers K·C floats of each row at once (C the
// column chunk of d: 1, 2, 4, 8, then 12 or 16).
__host__ __device__ constexpr int bags_per_thread(int chunk) {
  return chunk < 8 ? 8 / chunk : 1;
}

// For i < n_valid (<= K): dst[i·32·d + j] = Σ_h table[ids[i·32·hot + h], j]
// for j < d, the sums of this thread's K bags (ids and dst in shared or
// global memory; its bags are 32 apart, so a warp's accesses of one i are
// contiguous). In chunks of C columns, VEC floats a load (VEC divides d and
// C); for each chunk the gathers of kHotBatch rows of all K bags are
// issued before any of them is added; every column is summed from 0 in h
// order.
template <int VEC, int C, int K>
__device__ __forceinline__ void bag_sums(const int* ids, int hot,
                                         const float* __restrict__ table,
                                         int d, int n_vocab, float* dst,
                                         int n_valid) {
  for (int c0 = 0; c0 < d; c0 += C) {
    float acc[K][C];
#pragma unroll
    for (int i = 0; i < K; ++i) {
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = 0.0f;
    }
    for (int h0 = 0; h0 < hot; h0 += kHotBatch) {
      float v[K][kHotBatch][C];
#pragma unroll
      for (int i = 0; i < K; ++i) {
#pragma unroll
        for (int hb = 0; hb < kHotBatch; ++hb) {
          const int h = h0 + hb;
          const int id = i < n_valid && h < hot ? ids[i * kWarp * hot + h]
                                                 : -1;
          const bool ok =
              static_cast<unsigned>(id) < static_cast<unsigned>(n_vocab);
          const float* row =
              table + static_cast<long long>(ok ? id : 0) * d + c0;
#pragma unroll
          for (int s = 0; s < C; s += VEC) {
            float t[VEC];
            if (ok && c0 + s < d) {
              load_vec<VEC>(row + s, t);
            } else {
#pragma unroll
              for (int e = 0; e < VEC; ++e) t[e] = 0.0f;
            }
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[i][hb][s + e] = t[e];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < K; ++i) {
#pragma unroll
        for (int hb = 0; hb < kHotBatch; ++hb) {
          if (h0 + hb < hot) {
#pragma unroll
            for (int j = 0; j < C; ++j) {
              acc[i][j] = __fadd_rn(acc[i][j], v[i][hb][j]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (i < n_valid) {
#pragma unroll
        for (int s = 0; s < C; s += VEC) {
          if (c0 + s < d) {
            store_vec<VEC>(dst + i * kWarp * d + c0 + s, acc[i] + s);
          }
        }
      }
    }
  }
}

template <int VEC, int C>
__global__ void __launch_bounds__(kMaxThreads + kWarp)
bag_tiles_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                 float* __restrict__ out, long long n_bags, int hot, int d,
                 int n_vocab, int bags_per_tile, int stages) {
  constexpr int K = bags_per_thread(C);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];

  const int n_consumers = blockDim.x - kWarp;  // == bags_per_tile / K
  const int R = bags_per_tile;
  const long long n_full = n_bags / R;
  const long long n_tiles = (n_bags + R - 1) / R;
  const int tile_ids = R * hot;
  const bool stage_ids =
      stages > 0 && (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  const bool stage_out =
      stages > 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  int* s_ids = reinterpret_cast<int*>(smem);
  float* s_out = reinterpret_cast<float*>(smem + stages * tile_ids * 4);

  if (threadIdx.x == 0 && stage_ids) {
    for (int s = 0; s < stages; ++s) {
      bulk::mbar_init(&full[s], 1);
      bulk::mbar_init(&empty[s], n_consumers / kWarp);
    }
    bulk::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= n_consumers) {  // the producer warp
    if (threadIdx.x == n_consumers && stage_ids) {
      const uint32_t bytes = static_cast<uint32_t>(tile_ids) * 4;
      const uint64_t policy = bulk::evict_first_policy();
      int stage = 0;
      uint32_t phase = 0;
      for (long long t = blockIdx.x; t < n_full; t += gridDim.x) {
        bulk::mbar_wait(&empty[stage], phase ^ 1);
        bulk::mbar_expect_tx(&full[stage], bytes);
        bulk::bulk_load(s_ids + stage * tile_ids, idx + t * tile_ids, bytes,
                        &full[stage], policy);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp0 = (tid - lane) * K;  // the warp's first bag in a tile
  const int first = warp0 + lane;      // this thread's first bag in a tile
  int stage = 0;
  uint32_t phase = 0;
  int buf = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long bag0 = t * R;
    if (t < n_full) {
      const int* ids = idx + bag0 * hot;
      if (stage_ids) {
        bulk::mbar_wait(&full[stage], phase);
        ids = s_ids + stage * tile_ids;
      }
      if (stage_out) {
        float* o = s_out + buf * R * d;
        if (lane == 0) bulk::bulk_wait_read<1>();  // o's last store has read it
        __syncwarp();
        bag_sums<VEC, C, K>(ids + first * hot, hot, table, d, n_vocab,
                            o + first * d, K);
        bulk::fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          bulk::bulk_store(out + (bag0 + warp0) * d, o + warp0 * d,
                           static_cast<uint32_t>(kWarp * K * d) * 4);
          bulk::bulk_commit();
        }
        buf ^= 1;
      } else {
        bag_sums<VEC, C, K>(ids + first * hot, hot, table, d, n_vocab,
                            out + (bag0 + first) * d, K);
      }
      if (stage_ids) {
        __syncwarp();
        if (lane == 0) bulk::mbar_arrive(&empty[stage]);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else {  // the ragged last tile: plain loads and stores
      const long long left = n_bags - (bag0 + first);
      const int n_valid =
          left <= 0 ? 0 : left >= K * kWarp ? K : static_cast<int>(
                                                      (left + kWarp - 1) /
                                                      kWarp);
      bag_sums<VEC, C, K>(idx + (bag0 + first) * hot, hot, table, d,
                          n_vocab, out + (bag0 + first) * d, n_valid);
    }
  }
  if (stage_out && lane == 0) bulk::bulk_wait_all();
}

template <int VEC, int C>
int launch(const float* table, const int* idx, float* out, long long n_bags,
           int hot, int d, int n_vocab, int bags_per_tile, int stages,
           int smem_bytes, cudaStream_t stream) {
  const int threads = bags_per_tile / bags_per_thread(C);
  const long long n_tiles = (n_bags + bags_per_tile - 1) / bags_per_tile;
  unsigned grid = 0;
  const cudaError_t e = bulk::persistent_grid<bag_tiles_kernel<VEC, C>>(
      threads + kWarp, smem_bytes, n_tiles, &grid);
  if (e != cudaSuccess) return e;
  bag_tiles_kernel<VEC, C><<<grid, threads + kWarp, smem_bytes, stream>>>(
      table, idx, out, n_bags, hot, d, n_vocab, bags_per_tile, stages);
  return cudaGetLastError();
}

// The widest load (VEC floats) that d, the chunk C and the table's
// address allow, then launch.
template <int C>
int launch_chunk(const float* table, const int* idx, float* out,
                 long long n_bags, int hot, int d, int n_vocab,
                 int bags_per_tile, int stages, int smem_bytes,
                 cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(table);
  if constexpr (C % 4 == 0) {
    if (d % 4 == 0 && a % 16 == 0)
      return launch<4, C>(table, idx, out, n_bags, hot, d, n_vocab,
                          bags_per_tile, stages, smem_bytes, stream);
  }
  if constexpr (C % 2 == 0) {
    if (d % 2 == 0 && a % 8 == 0)
      return launch<2, C>(table, idx, out, n_bags, hot, d, n_vocab,
                          bags_per_tile, stages, smem_bytes, stream);
  }
  return launch<1, C>(table, idx, out, n_bags, hot, d, n_vocab,
                      bags_per_tile, stages, smem_bytes, stream);
}

// Bags a warp item of the wide path: G·U loads in flight a lane.
__host__ __device__ constexpr int rows_bags_per_warp(int u) {
  return u == 1 ? 4 : u <= 3 ? 2 : 1;
}

constexpr int kRowThreads = 256;

// One warp an item: G consecutive bags × one slab of their rows.
template <int VEC, int U>
__global__ void __launch_bounds__(kRowThreads)
bag_rows_gather(const float* __restrict__ table, const int* __restrict__ idx,
                float* __restrict__ out, long long n_bags, int hot, int d,
                int n_vocab, long long n_slabs, long long n_items) {
  constexpr int G = rows_bags_per_warp(U);
  const long long w =
      (static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x) /
      kWarp;
  if (w >= n_items) return;
  const int lane = threadIdx.x % kWarp;
  const long long group = w / n_slabs;
  const int slab = static_cast<int>(w - group * n_slabs);
  const long long bag0 = group * G;
  const int c0 = slab * kWarp * U * VEC + lane * VEC;
  float acc[G][U][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int u = 0; u < U; ++u) slabs::zero<VEC>(acc[g][u]);
  }
  for (int h = 0; h < hot; ++h) {
    float v[G][U][VEC];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const long long bag = bag0 + g;
      const int id = bag < n_bags ? __ldg(idx + bag * hot + h) : -1;
      const bool ok =
          static_cast<unsigned>(id) < static_cast<unsigned>(n_vocab);
      const float* row = table + static_cast<long long>(ok ? id : 0) * d;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c0 + u * kWarp * VEC;
        if (ok && c < d) {
          slabs::load_ro<VEC>(row + c, v[g][u]);
        } else {
          slabs::zero<VEC>(v[g][u]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          acc[g][u][e] = __fadd_rn(acc[g][u][e], v[g][u][e]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const long long bag = bag0 + g;
    if (bag >= n_bags) break;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * kWarp * VEC;
      if (c < d) slabs::store_stream<VEC>(out + bag * d + c, acc[g][u]);
    }
  }
}

template <int VEC, int U>
int launch_rows(const float* table, const int* idx, float* out,
                long long n_bags, int hot, int d, int n_vocab,
                cudaStream_t stream) {
  constexpr int G = rows_bags_per_warp(U);
  const long long n_slabs = slabs::n_slabs(d / VEC, U);
  const long long n_items = (n_bags + G - 1) / G * n_slabs;
  const long long blocks = (n_items + kRowThreads / kWarp - 1) /
                           (kRowThreads / kWarp);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  bag_rows_gather<VEC, U><<<static_cast<unsigned>(blocks), kRowThreads, 0,
                            stream>>>(table, idx, out, n_bags, hot, d,
                                      n_vocab, n_slabs, n_items);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int launch_rows_vec(const float* table, const int* idx, float* out,
                    long long n_bags, int hot, int d, int n_vocab,
                    cudaStream_t stream) {
  switch (slabs::loads_per_lane(d / VEC)) {
    case 1:
      return launch_rows<VEC, 1>(table, idx, out, n_bags, hot, d, n_vocab,
                                 stream);
    case 2:
      return launch_rows<VEC, 2>(table, idx, out, n_bags, hot, d, n_vocab,
                                 stream);
    case 3:
      return launch_rows<VEC, 3>(table, idx, out, n_bags, hot, d, n_vocab,
                                 stream);
    default:
      return launch_rows<VEC, 4>(table, idx, out, n_bags, hot, d, n_vocab,
                                 stream);
  }
}

}  // namespace

// The wide-row path (any d >= 1 works; the wrapper sends d >= 32 here).
extern "C" int repro_embedding_bag_rows_f32(const void* table,
                                            const void* idx, void* out,
                                            long long n_bags, int hot, int d,
                                            int n_vocab, void* stream) {
  if (n_bags <= 0 || hot <= 0 || d <= 0) return 0;
  const float* t = static_cast<const float*>(table);
  const int* i = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = d % 4 == 0 &&
                    ((reinterpret_cast<uintptr_t>(table) |
                      reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  return vec4 ? launch_rows_vec<4>(t, i, o, n_bags, hot, d, n_vocab, s)
              : launch_rows_vec<1>(t, i, o, n_bags, hot, d, n_vocab, s);
}

extern "C" int repro_embedding_bag_f32(const void* table, const void* idx,
                                       void* out, long long n_bags, int hot,
                                       int d, int n_vocab, int bags_per_tile,
                                       int stages, int smem_bytes,
                                       void* stream) {
  if (n_bags <= 0 || hot <= 0 || d <= 0) return 0;
  const int R = bags_per_tile;
  const int chunk = d <= 1 ? 1 : d <= 2 ? 2 : d <= 4 ? 4 : d <= 8 ? 8 : 12;
  const int threads = R / bags_per_thread(chunk);
  const long long tile_bytes = 4ll * R * hot;
  const long long smem = stages > 0 ? stages * tile_bytes + 8ll * R * d : 0;
  if (threads < kWarp || threads > kMaxThreads || threads % kWarp != 0 ||
      R != threads * bags_per_thread(chunk) || stages < 0 ||
      stages > kMaxStages || smem != smem_bytes ||
      static_cast<long long>(R) * hot > INT_MAX / 4 ||
      static_cast<long long>(R) * d > INT_MAX / 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* t = static_cast<const float*>(table);
  const int* i = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BAG_LAUNCH(C) \
  return launch_chunk<C>(t, i, o, n_bags, hot, d, n_vocab, R, stages, \
                         smem_bytes, s)
  if (d <= 1) BAG_LAUNCH(1);
  if (d <= 2) BAG_LAUNCH(2);
  if (d <= 4) BAG_LAUNCH(4);
  if (d <= 8) BAG_LAUNCH(8);
  if (d <= 12) BAG_LAUNCH(12);
  BAG_LAUNCH(16);
#undef BAG_LAUNCH
}
