// The row loop of the port's float ELL kernels (spmv_ell, jacobi) for
// Hopper (sm_90a): TMA-staged row tiles, one consumer thread per row.
//
// Layout: a [n_rows, width] row-major pair of tables, int32 col and
// float32 val, whose slots with a column outside [0, n_cols) are padding.
// Because the tables are row-major, the rows [t·R, (t+1)·R) of tile t are
// one contiguous run of R·width·4 bytes in each table.
//
// Design (what bounds these kernels is bytes: the two tables are read
// once, 8 bytes a slot, against 2 flops a slot):
// - Persistent grid: as many blocks as fit on the SMs at once walk the
//   tiles with stride gridDim.x.
// - Staging: one producer thread (lane 0 of the block's last warp) issues
//   two 1-D bulk copies (cp.async.bulk, the TMA's non-tensor form) per
//   tile, col and val, into a ring of S shared-memory stages; each stage
//   has a "full" mbarrier (completed by the copies' byte count) and an
//   "empty" mbarrier (one arrival per consumer warp). Tiles k+1 … k+S−1
//   are in flight while tile k is consumed, so the stream does not wait
//   on the gathers, and the gathers do not wait on the stream.
// - One consumer thread per row (several rows per thread at small widths,
//   rows t, t+T, t+2T, … so stores stay coalesced). A thread reads its
//   row's slots from shared memory in passes of P (P = min(last_pow2(w),
//   32)) and issues a pass's gathers of x (through L2, __ldg; x does not
//   fit in shared memory) before it adds any of them: P loads in flight
//   per thread, no shuffle.
// - Summation order: the rounded products are added in the order of
//   PyTorch's row sum on the card (row_sum), which the plain version uses:
//   at widths ≤ 128 the kernel and the plain version round alike, which
//   matters for Jacobi, where 1/deg magnifies the rounding of A x at
//   small degrees. The order depends only on the width, so a repeated
//   call is bitwise equal; no atomics, no row is split.
// - Banks: a warp's 32 rows lie w words apart in shared memory, so at
//   even widths their reads of one slot would conflict g-way, g =
//   gcd(w, 32) (32-way at w = 64). From g = 4 up, the g rows that share
//   banks start each pass at g different slots, and a barrel shifter of
//   selects puts the products back in slot order (full_pass,
//   rotation()).
// - The bulk copies carry an L2 evict-first policy, so the streamed
//   tables do not push the gathered x out of L2.
// - The ragged last tile (fewer than R rows; its byte count may not be a
//   multiple of 16) is read with plain loads, in the same order. Width 0
//   stages nothing: every row gets the sum 0. A plan of 0 stages (rows
//   too wide for two stages of a tile in shared memory) reads every tile
//   with plain loads.
// Measured on an H100, the staged stream alone runs near the byte bound;
// the gathers of x (32 unrelated rows' columns per warp load) set the
// pace, and the plan keeps shared memory small so that many consumer
// threads stay resident (PERF.md).
//
// The tile plan (R rows a tile, S stages, the dynamic shared memory) is
// computed once, in Python (repro_torch.kernels.ell_tile_plan), and
// passed in; the launcher checks it.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace ell_tiles {

constexpr int kMaxThreads = 256;   // consumer threads of a block
constexpr int kMaxStages = 8;
constexpr int kWarp = 32;
// a wait longer than this many SM clocks (~10 s) is a broken pipeline:
// trap, so the launch fails instead of hanging the card
constexpr long long kSpinClocks = 1ll << 34;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kSpinClocks) __trap();
  }
}

// An L2 policy that evicts the streamed tables first, so that the
// gathered x (4 MB at n = 2^20) stays in L2 while 160–200 MB of tables
// pass through it.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// Bulk copy of `bytes` (a multiple of 16; both addresses 16-B aligned)
// from global to shared memory, completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// a ? x : y as one selp, in PTX so that the compiler keeps the barrel
// shifter below in registers.
__device__ __forceinline__ float select(bool a, float x, float y) {
  float r;
  asm("{\n.reg .pred q;\nsetp.ne.u32 q, %3, 0;\nselp.f32 %0, %1, %2, q;\n}"
      : "=f"(r)
      : "f"(x), "f"(y), "r"(static_cast<unsigned>(a)));
  return r;
}

// Rotates p right by the bits B, 2B, … (< P) of rot that lie below g:
// p[j] <- p[(j - rot) mod P]. A barrel shifter of selects, unrolled at
// compile time so that p stays in registers.
template <int P, int B>
__device__ __forceinline__ void unrotate(float (&p)[P], int rot, int g) {
  if constexpr (B < P) {
    if (B < g) {  // the same for the whole launch
      const bool on = (rot & B) != 0;
      float t[P];
#pragma unroll
      for (int j = 0; j < P; ++j) t[j] = select(on, p[(j - B) & (P - 1)], p[j]);
#pragma unroll
      for (int j = 0; j < P; ++j) p[j] = t[j];
    }
    unrotate<P, 2 * B>(p, rot, g);
  }
}

// s[j] += s[j + OFF] for j < OFF, then for OFF/2, …, 1: lane 0 ends with
// the tree's sum.
template <int P, int OFF>
__device__ __forceinline__ void tree(float (&s)[P]) {
  if constexpr (OFF > 0) {
#pragma unroll
    for (int j = 0; j < OFF; ++j) s[j] = __fadd_rn(s[j], s[j + OFF]);
    tree<P, OFF / 2>(s);
  }
}

// The rounded product val[k] · x[col[k]], or +0 for a padding slot.
__device__ __forceinline__ float product(const int* c, const float* v, int k,
                                         const float* __restrict__ x,
                                         int n_cols) {
  const int cc = c[k];
  return static_cast<unsigned>(cc) < static_cast<unsigned>(n_cols)
             ? __fmul_rn(v[k], __ldg(x + cc))
             : 0.0f;
}

// p[j] = the product of slot k0 + j, for a pass of P slots that all lie in
// the row. With kRotate the thread reads position j from slot
// k0 + ((j + rot) mod P) and rotates p back afterwards; all P loads and
// gathers are issued before p is used.
template <int P, bool kRotate>
__device__ __forceinline__ void full_pass(const int* c, const float* v,
                                          int k0, int rot, int g,
                                          const float* __restrict__ x,
                                          int n_cols, float (&p)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    p[j] = product(c, v, k0 + (kRotate ? (j + rot) & (P - 1) : j), x, n_cols);
  }
  if constexpr (kRotate) unrotate<P, 1>(p, rot, g);
}

// One row's Σ_k val[k] · x[col[k]] (its slots in shared or global memory)
// in PyTorch's order for a row sum of width w ≤ 4P on the card: P lanes
// (P = min(last_pow2(w), 32)); lane j starts from 0 and adds the rounded
// products of slots j, j+P, j+2P, … left to right (a slot past the row
// adds 0); then a tree with halving offsets adds lane j+off into lane j.
// The read rotation (kRotate, rot, g; see rotation()) changes only which
// slot a thread reads first, never the order of the sum.
template <int P, bool kRotate>
__device__ __forceinline__ float row_sum(const int* c, const float* v,
                                         int width, int rot, int g,
                                         const float* __restrict__ x,
                                         int n_cols) {
  float s[P];
  full_pass<P, kRotate>(c, v, 0, rot, g, x, n_cols, s);
#pragma unroll
  for (int j = 0; j < P; ++j) s[j] = __fadd_rn(0.0f, s[j]);
  for (int k0 = P; k0 < width; k0 += P) {
    float p[P];
    if (k0 + P <= width) {
      full_pass<P, kRotate>(c, v, k0, rot, g, x, n_cols, p);
    } else {  // the row's last, partial pass
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int cc = k0 + j < width ? c[k0 + j] : -1;
        p[j] = static_cast<unsigned>(cc) < static_cast<unsigned>(n_cols)
                   ? __fmul_rn(v[k0 + j], __ldg(x + cc))
                   : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) s[j] = __fadd_rn(s[j], p[j]);
  }
  tree<P, P / 2>(s);
  return s[0];
}

// The bank group of a width, g = gcd(width, 32): the 32 rows of a warp lie
// width words apart, so without a rotation their reads of one slot meet
// g-way bank conflicts (32-way at w = 64, none at odd widths). Rotated
// from g = 4 up (kernels instantiated with kRotate); at g = 2 the
// rotation's index arithmetic and selects cost more than the 2-way
// conflicts it would remove.
__host__ __device__ __forceinline__ int bank_group(int width) {
  const int low = width & -width;  // the lowest set bit of width
  return low < 4 ? 1 : low < 32 ? low : 32;
}

// The read rotation of the row in tile position r: ((r mod 32) · g) / 32,
// below g. The g rows of a warp that would share banks start at g
// different slots, so every read of a full pass is conflict-free (checked
// for every width 1 … 64).
__device__ __forceinline__ int rotation(int row_in_tile, int g) {
  return ((row_in_tile & 31) * g) >> 5;
}

// epi(row, acc) is called once for every row with the row's sum.
template <int P, bool kRotate, class Epi>
__global__ void __launch_bounds__(kMaxThreads + kWarp)
tiles_kernel(const int* __restrict__ col, const float* __restrict__ val,
             const float* __restrict__ x, int n_rows, int width, int n_cols,
             int rows_per_tile, int stages, Epi epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];

  const int n_consumers = blockDim.x - kWarp;
  const int g = bank_group(width);
  const int rows = rows_per_tile;
  const long long tile_slots = static_cast<long long>(rows) * width;
  const bool staged = width > 0 && stages > 0;
  const int n_full = n_rows / rows;
  const int n_tiles = (n_rows + rows - 1) / rows;
  int* s_col = reinterpret_cast<int*>(smem);
  float* s_val = reinterpret_cast<float*>(smem + stages * tile_slots * 4);

  if (threadIdx.x == 0 && staged) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], n_consumers / kWarp);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= n_consumers) {  // the producer warp
    if (threadIdx.x == n_consumers && staged) {
      const uint32_t bytes = static_cast<uint32_t>(tile_slots * 4);
      const uint64_t policy = evict_first_policy();
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_full; t += gridDim.x) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], 2 * bytes);
        const long long off = static_cast<long long>(t) * tile_slots;
        bulk_load(s_col + stage * tile_slots, col + off, bytes, &full[stage],
                  policy);
        bulk_load(s_val + stage * tile_slots, val + off, bytes, &full[stage],
                  policy);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = static_cast<long long>(t) * rows;
    if (staged && t < n_full) {
      mbar_wait(&full[stage], phase);
      const int* c = s_col + stage * tile_slots;
      const float* v = s_val + stage * tile_slots;
      for (int r = tid; r < rows; r += n_consumers) {
        const int o = r * width;
        epi(row0 + r, row_sum<P, kRotate>(c + o, v + o, width,
                                          rotation(r, g), g, x, n_cols));
      }
      __syncwarp();
      if (tid % kWarp == 0) mbar_arrive(&empty[stage]);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    } else {  // the ragged last tile, width 0 or no stages: plain loads
      for (int r = tid; r < rows && row0 + r < n_rows; r += n_consumers) {
        const long long o = (row0 + r) * width;
        epi(row0 + r, width > 0
                          ? row_sum<P, kRotate>(col + o, val + o, width,
                                                rotation(r, g), g, x, n_cols)
                          : 0.0f);
      }
    }
  }
}

// Checks the plan, sets the kernel's shared-memory limit (once per
// instantiation) and launches a persistent grid: the blocks that fit on
// the card at once, at most one per tile. Returns a cudaError_t.
template <int P, bool kRotate, class Epi>
int launch_kernel(const int* col, const float* val, const float* x,
                  int n_rows, int width, int n_cols, int rows_per_tile,
                  int stages, int smem_bytes, Epi epi, cudaStream_t stream) {
  if (n_rows <= 0) return cudaSuccess;
  const int threads =
      rows_per_tile < kMaxThreads ? rows_per_tile : kMaxThreads;
  const long long tile_bytes = static_cast<long long>(rows_per_tile) *
                               width * 8;
  if (rows_per_tile <= 0 || rows_per_tile % threads != 0 ||
      threads % kWarp != 0 || width < 0 ||
      stages < 0 || stages > kMaxStages ||
      smem_bytes != stages * tile_bytes || (width == 0 && stages != 0)) {
    return cudaErrorInvalidValue;
  }
  auto* kern = tiles_kernel<P, kRotate, Epi>;
  static const cudaError_t attr = [&] {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(fa.sharedSizeBytes));
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  // blocks that fit on the card at once, kept for the last (device,
  // block shape) this instantiation was launched with
  static int last_dev = -1, last_threads = -1, last_smem = -1;
  static long long fit = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != last_dev || threads != last_threads || smem_bytes != last_smem) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kern, threads + kWarp, smem_bytes);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    fit = static_cast<long long>(per_sm) * sms;
    last_dev = dev;
    last_threads = threads;
    last_smem = smem_bytes;
  }
  const long long n_tiles = (n_rows + rows_per_tile - 1) / rows_per_tile;
  const unsigned grid = static_cast<unsigned>(n_tiles < fit ? n_tiles : fit);
  kern<<<grid, threads + kWarp, smem_bytes, stream>>>(
      col, val, x, n_rows, width, n_cols, rows_per_tile, stages, epi);
  return cudaGetLastError();
}

// Picks the lane count P = min(last_pow2(width), 32) of row_sum, and the
// read rotation where the width's bank group asks for one, and launches
// (width 0 sums nothing).
template <class Epi>
int launch(const int* col, const float* val, const float* x, int n_rows,
           int width, int n_cols, int rows_per_tile, int stages,
           int smem_bytes, Epi epi, cudaStream_t stream) {
#define ELL_TILES_LAUNCH(P, R)                                           \
  return launch_kernel<P, R>(col, val, x, n_rows, width, n_cols,         \
                             rows_per_tile, stages, smem_bytes, epi, stream)
  if (width < 2) ELL_TILES_LAUNCH(1, false);
  if (width < 4) ELL_TILES_LAUNCH(2, false);
  const bool rotate = bank_group(width) > 1;
  if (width < 8) {
    if (rotate) ELL_TILES_LAUNCH(4, true);
    ELL_TILES_LAUNCH(4, false);
  }
  if (width < 16) {
    if (rotate) ELL_TILES_LAUNCH(8, true);
    ELL_TILES_LAUNCH(8, false);
  }
  if (width < 32) {
    if (rotate) ELL_TILES_LAUNCH(16, true);
    ELL_TILES_LAUNCH(16, false);
  }
  if (rotate) ELL_TILES_LAUNCH(32, true);
  ELL_TILES_LAUNCH(32, false);
#undef ELL_TILES_LAUNCH
}

}  // namespace ell_tiles
