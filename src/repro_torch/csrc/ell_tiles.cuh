// The row loop of the port's ELL kernels (spmv_ell, jacobi, agg_vote) for
// Hopper (sm_90a): TMA-staged row tiles, one consumer thread per row.
//
// Layout: a [n_rows, width] row-major pair of tables, int32 col and a
// 4-byte payload (float32 val for the float kernels, int32 sq for
// agg_vote), whose slots with a column outside [0, n_cols) are padding.
// Because the tables are row-major, the rows [t·R, (t+1)·R) of tile t are
// one contiguous run of R·width·4 bytes in each table. What a row
// computes is a template parameter (Row): SumRow below for the float
// kernels, the vote's ⊕ in agg_vote.cu.
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
//   per thread, no shuffle. (The float kernels; agg_vote's row is alike.)
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
//
// The k-column form (block_tiles_kernel, the float kernels on row-major
// [n, k] blocks: what jax.vmap over a column axis makes of the one-vector
// TPU kernels, spmv_ell_pallas and jacobi_step_pallas) stages the same
// tiles once for all k columns. A unit of work is a (row, group of C
// contiguous columns), C = 4 where k % 4 == 0; T threads of a warp split
// the row's P lanes of row_sum between them, so that a thread holds at
// most 16 partial sums (its plan: repro_torch.kernels.
// ell_block_tile_plan, one unit a consumer thread where a tile allows).
// What bounds it is bytes: the tables once, X once and the result once,
// and a (row, slot) gathers one 32-byte sector of X at k = 8 (a float4
// for each of two threads), the sector the one-vector kernel fetches from
// L2 for its 4 bytes. But X is k times the one-vector kernel's x: on an
// H100 the gathers mostly hit L2 at 2^20 rows and k = 4 (X 16 MB) and
// mostly miss it at k = 8 (32 MB), a sector of HBM each, which sets the
// pace there (PERF.md). So X is gathered under an L2 evict-last policy,
// and the tables (evict-first bulk copies) and the result (streaming
// stores) pass by it. The tree's
// offsets >= T add inside a thread and those < T by shuffles, the same
// additions in the same order as row_sum's, so column j of a block is
// bitwise the one-vector kernel's sum of X[:, j]. No read rotation: the T
// threads of a unit read consecutive slots, and at k = 8 the rows a warp
// holds meet at most 2-way bank conflicts at the widths 8, 19, 34 and 64
// (none at 19).

#pragma once

#include <type_traits>

#include "bulk_copy.cuh"

namespace ell_tiles {

constexpr int kMaxThreads = 256;   // consumer threads of a block
constexpr int kMaxStages = 8;
constexpr int kWarp = 32;

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

// The gathers of x at a column id cc: x[cc] of one vector (VecGather), or
// X[cc, j] of column j of a row-major [n_cols, k] block (BlockGather, x
// pointing at X + j): a row's k lanes then read k contiguous floats.
struct VecGather {
  const float* __restrict__ x;
  __device__ __forceinline__ float operator()(int cc) const {
    return __ldg(x + cc);
  }
};

struct BlockGather {
  const float* __restrict__ x;
  int k;
  __device__ __forceinline__ float operator()(int cc) const {
    return __ldg(x + static_cast<long long>(cc) * k);
  }
};

// The rounded product val[k] · x[col[k]], or +0 for a padding slot.
template <class G>
__device__ __forceinline__ float product(const int* c, const float* v, int k,
                                         const G& x, int n_cols) {
  const int cc = c[k];
  return static_cast<unsigned>(cc) < static_cast<unsigned>(n_cols)
             ? __fmul_rn(v[k], x(cc))
             : 0.0f;
}

// p[j] = the product of slot k0 + j, for a pass of P slots that all lie in
// the row. With kRotate the thread reads position j from slot
// k0 + ((j + rot) mod P) and rotates p back afterwards; all P loads and
// gathers are issued before p is used.
template <int P, bool kRotate, class G>
__device__ __forceinline__ void full_pass(const int* c, const float* v,
                                          int k0, int rot, int g, const G& x,
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
template <int P, bool kRotate, class G>
__device__ __forceinline__ float row_sum(const int* c, const float* v,
                                         int width, int rot, int g,
                                         const G& x, int n_cols) {
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
                   ? __fmul_rn(v[k0 + j], x(cc))
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

// The float kernels' per-row work: the row's Σ val · x[col] in PyTorch's
// order (row_sum), read with the rotation that the width's bank group
// asks for. Width 0 sums nothing.
template <int P, bool kRotate>
struct SumRow {
  using Val = float;
  const float* x;
  int n_cols;
  int g;  // bank_group(width)
  __device__ __forceinline__ float operator()(const int* c, const float* v,
                                              int width, int r) const {
    return row_sum<P, kRotate>(c, v, width, rotation(r, g), g,
                               VecGather{x}, n_cols);
  }
  __device__ __forceinline__ static float identity() { return 0.0f; }
};

// The k-column form's per-(row, column) work: column j of the row's
// Σ val · X[col, j], in row_sum's order, so that column j of a block is
// bitwise the one-vector sum of X[:, j]. The rotation is the one-vector
// kernel's: a warp's rows are a 32/lanes-row window of its 32 rows.
template <int P, bool kRotate>
struct BlockSumRow {
  const float* x;  // X, row-major [n_cols, k]
  int k;
  int n_cols;
  int g;  // bank_group(width)
  __device__ __forceinline__ float operator()(const int* c, const float* v,
                                              int width, int r,
                                              int j) const {
    return row_sum<P, kRotate>(c, v, width, rotation(r, g), g,
                               BlockGather{x + j, k}, n_cols);
  }
};

// A Row whose work depends on the row's index in the whole table (the
// graph-batched vote: the graph a row of a stacked table belongs to)
// declares kGlobalRow = true and takes that index as a fifth argument;
// the other rows see only their tile position.
template <class Row, class = void>
struct wants_global_row : std::false_type {};
template <class Row>
struct wants_global_row<Row, std::void_t<decltype(Row::kGlobalRow)>>
    : std::integral_constant<bool, Row::kGlobalRow> {};

template <class Row>
__device__ __forceinline__ auto call_row(const Row& row, const int* c,
                                         const typename Row::Val* v,
                                         int width, int r, long long grow) {
  if constexpr (wants_global_row<Row>::value) {
    return row(c, v, width, r, grow);
  } else {
    return row(c, v, width, r);
  }
}

// The unstaged rows' call of row(): not inlined, so that the kernel holds
// one inlined copy of the unrolled row loop, the staged path's. With both
// copies inlined, jacobi at width 34 and both kernels at width 64 ran 2–11 %
// slower on an H100 (PERF.md).
template <class Row>
__device__ __noinline__ auto unstaged_row(const Row& row, const int* c,
                                          const typename Row::Val* v,
                                          int width, int r, long long grow) {
  return call_row(row, c, v, width, r, grow);
}

// The producer's loop (one thread): the full tiles of this block, two bulk
// copies each (col, val) into the ring of stages.
template <class Val>
__device__ __forceinline__ void produce(const int* __restrict__ col,
                                        const Val* __restrict__ val,
                                        int* s_col, Val* s_val,
                                        uint64_t* full, uint64_t* empty,
                                        long long tile_slots, int stages,
                                        int n_full) {
  const uint32_t bytes = static_cast<uint32_t>(tile_slots * 4);
  const uint64_t policy = bulk::evict_first_policy();
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < n_full; t += gridDim.x) {
    bulk::mbar_wait(&empty[stage], phase ^ 1);
    bulk::mbar_expect_tx(&full[stage], 2 * bytes);
    const long long off = static_cast<long long>(t) * tile_slots;
    bulk::bulk_load(s_col + stage * tile_slots, col + off, bytes,
                    &full[stage], policy);
    bulk::bulk_load(s_val + stage * tile_slots, val + off, bytes,
                    &full[stage], policy);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// row(c, v, width, r) is a row's result from its slots c[0 .. width) and
// v[0 .. width) (in shared memory for a staged tile, in global memory
// otherwise), r its position in its tile; Row::identity() is a row's
// result at width 0. epi(row, result) is called once for every row.
template <class Row, class Epi>
__global__ void __launch_bounds__(kMaxThreads + kWarp)
tiles_kernel(const int* __restrict__ col,
             const typename Row::Val* __restrict__ val, int n_rows,
             int width, int rows_per_tile, int stages, Row row, Epi epi) {
  using Val = typename Row::Val;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];

  const int n_consumers = blockDim.x - kWarp;
  const int rows = rows_per_tile;
  const long long tile_slots = static_cast<long long>(rows) * width;
  const bool staged = width > 0 && stages > 0;
  const int n_full = n_rows / rows;
  const int n_tiles = (n_rows + rows - 1) / rows;
  int* s_col = reinterpret_cast<int*>(smem);
  Val* s_val = reinterpret_cast<Val*>(smem + stages * tile_slots * 4);

  if (threadIdx.x == 0 && staged) {
    for (int s = 0; s < stages; ++s) {
      bulk::mbar_init(&full[s], 1);
      bulk::mbar_init(&empty[s], n_consumers / kWarp);
    }
    bulk::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= n_consumers) {  // the producer warp
    if (threadIdx.x == n_consumers && staged) {
      produce(col, val, s_col, s_val, full, empty, tile_slots, stages,
              n_full);
    }
    return;
  }

  const int tid = threadIdx.x;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = static_cast<long long>(t) * rows;
    if (staged && t < n_full) {
      bulk::mbar_wait(&full[stage], phase);
      const int* c = s_col + stage * tile_slots;
      const Val* v = s_val + stage * tile_slots;
      for (int r = tid; r < rows; r += n_consumers) {
        const int o = r * width;
        epi(row0 + r, call_row(row, c + o, v + o, width, r, row0 + r));
      }
      __syncwarp();
      if (tid % kWarp == 0) bulk::mbar_arrive(&empty[stage]);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    } else {  // the ragged last tile, width 0 or no stages: plain loads
      for (int r = tid; r < rows && row0 + r < n_rows; r += n_consumers) {
        const long long o = (row0 + r) * width;
        epi(row0 + r,
            width > 0 ? unstaged_row(row, col + o, val + o, width, r,
                                     row0 + r)
                      : Row::identity());
      }
    }
  }
}

// Checks the plan and launches a persistent grid: the blocks that fit on
// the card at once, at most one per tile. Returns a cudaError_t.
template <class Row, class Epi>
int launch_kernel(const int* col, const typename Row::Val* val, int n_rows,
                  int width, int rows_per_tile, int stages, int smem_bytes,
                  Row row, Epi epi, cudaStream_t stream) {
  static_assert(sizeof(typename Row::Val) == 4, "4-byte table slots");
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
  const long long n_tiles = (n_rows + rows_per_tile - 1) / rows_per_tile;
  unsigned grid = 0;
  const cudaError_t e = bulk::persistent_grid<tiles_kernel<Row, Epi>>(
      threads + kWarp, smem_bytes, n_tiles, &grid);
  if (e != cudaSuccess) return e;
  tiles_kernel<Row, Epi><<<grid, threads + kWarp, smem_bytes, stream>>>(
      col, val, n_rows, width, rows_per_tile, stages, row, epi);
  return cudaGetLastError();
}

// Calls launch(std::integral_constant<int, P>{}) with the lane count
// P = min(last_pow2(width), 32) of a row's passes.
template <class Launch>
int dispatch_width(int width, Launch&& launch) {
  if (width < 2) return launch(std::integral_constant<int, 1>{});
  if (width < 4) return launch(std::integral_constant<int, 2>{});
  if (width < 8) return launch(std::integral_constant<int, 4>{});
  if (width < 16) return launch(std::integral_constant<int, 8>{});
  if (width < 32) return launch(std::integral_constant<int, 16>{});
  return launch(std::integral_constant<int, 32>{});
}

// The float kernels: picks the lane count of row_sum, and the read
// rotation where the width's bank group asks for one (from P = 4 up), and
// launches (width 0 sums nothing).
template <class Epi>
int launch(const int* col, const float* val, const float* x, int n_rows,
           int width, int n_cols, int rows_per_tile, int stages,
           int smem_bytes, Epi epi, cudaStream_t stream) {
  const int g = bank_group(width);
  return dispatch_width(width, [&](auto lanes) {
    constexpr int P = decltype(lanes)::value;
    if constexpr (P >= 4) {
      if (g > 1) {
        return launch_kernel(col, val, n_rows, width, rows_per_tile, stages,
                             smem_bytes, SumRow<P, true>{x, n_cols, g}, epi,
                             stream);
      }
    }
    return launch_kernel(col, val, n_rows, width, rows_per_tile, stages,
                         smem_bytes, SumRow<P, false>{x, n_cols, g}, epi,
                         stream);
  });
}

// ---------------------------------------------------------------------------
// The k-column form: X and the result are row-major [n, k] blocks (what
// jax.vmap over a column axis makes of the one-vector TPU kernels). The
// tables are staged exactly as above (produce(), the same ring), once for
// all k columns. The unit of work is a (row, column group): C contiguous
// columns j0 .. j0+C of one row, C = block_cols(k), owned by T threads of
// one warp (block_unit_threads) that split the row's P lanes of row_sum:
// thread t holds lanes t, t+T, t+2T, … (N = P/T of them) and adds each
// lane's slots left to right, as row_sum's lane does; the halving tree
// then runs its offsets >= T inside the thread and its offsets < T by
// shuffles. The additions are row_sum's, in its order, so column j of a
// block is bitwise the one-vector kernel's sum of X[:, j]. A thread reads
// each of its slots from shared memory once for its C columns and gathers
// X[col, j0 .. j0+C) with one vector load; the T threads of a unit read
// consecutive slots (distinct banks). X is gathered under an L2
// evict-last policy and the result stored as streaming (evict-first), so
// that X stays in L2 while the tables and the result pass through it.

constexpr int kBlockPartials = 16;  // N·C, the partial sums of a thread

// C, the columns of a unit: 4 where k % 4 == 0 (X's and Y's rows are then
// 16-byte aligned), 2 where k is even, else 1.
__host__ __device__ constexpr int block_cols(int k) {
  return k % 4 == 0 ? 4 : k % 2 == 0 ? 2 : 1;
}

// T, the threads of a unit: the fewest (a power of two dividing P) that
// keep a thread's N·C partial sums within kBlockPartials.
__host__ __device__ constexpr int block_unit_threads(int P, int C) {
  return P * C > kBlockPartials ? P * C / kBlockPartials : 1;
}

template <int C>
struct Cols {
  float v[C];
};

// C contiguous floats at p (4·C-byte aligned) through the read-only path,
// with the L2 policy `policy` (bulk::evict_last_policy() for X). Volatile:
// a padding slot's load sits under a branch and must not be hoisted.
template <int C>
__device__ __forceinline__ void load_cols(const float* p, uint64_t policy,
                                          float (&o)[C]) {
  if constexpr (C == 4) {
    asm volatile(
        "ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
        : "=f"(o[0]), "=f"(o[1]), "=f"(o[2]), "=f"(o[3])
        : "l"(p), "l"(policy));
  } else if constexpr (C == 2) {
    asm volatile(
        "ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;"
        : "=f"(o[0]), "=f"(o[1])
        : "l"(p), "l"(policy));
  } else {
    asm volatile(
        "ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
        : "=f"(o[0])
        : "l"(p), "l"(policy));
  }
}

// C contiguous floats at p (4·C-byte aligned) read once (streaming).
template <int C>
__device__ __forceinline__ void stream_cols(const float* p, float (&o)[C]) {
  if constexpr (C == 4) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w;
  } else if constexpr (C == 2) {
    const float2 a = __ldcs(reinterpret_cast<const float2*>(p));
    o[0] = a.x, o[1] = a.y;
  } else {
    o[0] = __ldcs(p);
  }
}

// C contiguous floats to p (4·C-byte aligned), one streaming store.
template <int C>
__device__ __forceinline__ void store_cols(float* p, const float (&o)[C]) {
  if constexpr (C == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(o[0], o[1], o[2], o[3]));
  } else if constexpr (C == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(o[0], o[1]));
  } else {
    __stcs(p, o[0]);
  }
}

// p[q] = the rounded product val[s] · X[col[s], j0 + q] of slot s, or +0
// for a padding slot (product() for each of C columns); x points at
// X + j0, a row-major [n_cols, k] block. A padding slot gathers nothing.
template <int C>
__device__ __forceinline__ void block_products(const int* c, const float* v,
                                               int s, const float* x, int k,
                                               int n_cols, uint64_t policy,
                                               float (&p)[C]) {
  const int cc = c[s];
  const bool real = static_cast<unsigned>(cc) < static_cast<unsigned>(n_cols);
  float g[C];
#pragma unroll
  for (int q = 0; q < C; ++q) g[q] = 0.0f;
  if (real) load_cols<C>(x + static_cast<long long>(cc) * k, policy, g);
  const float vs = v[s];
#pragma unroll
  for (int q = 0; q < C; ++q) p[q] = real ? __fmul_rn(vs, g[q]) : 0.0f;
}

// s[i] += s[i + OFF] for i < OFF, then for OFF/2, …, 1, in each column:
// tree() on a thread's N lanes of C columns.
template <int N, int C, int OFF>
__device__ __forceinline__ void tree_cols(float (&s)[N][C]) {
  if constexpr (OFF > 0) {
#pragma unroll
    for (int i = 0; i < OFF; ++i) {
#pragma unroll
      for (int q = 0; q < C; ++q) s[i][q] = __fadd_rn(s[i][q], s[i + OFF][q]);
    }
    tree_cols<N, C, OFF / 2>(s);
  }
}

// One unit's sums: thread t (of the unit's T, lanes t, t+T, … of row_sum's
// P) adds its lanes' rounded products in row_sum's order: each lane from
// +0, its slots lane, lane+P, lane+2P, … left to right (a slot past the
// row adds 0); then the tree, offsets P/2 … T in the thread, T/2 … 1 by
// shuffles within the unit's lanes of the warp (mask). The C sums end in
// thread t = 0. All T threads call it together.
template <int P, int T, int C>
__device__ __forceinline__ Cols<C> unit_sum(const int* c, const float* v,
                                            int width, int t, const float* x,
                                            int k, int n_cols, uint64_t policy,
                                            unsigned mask) {
  constexpr int N = P / T;
  float s[N][C];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    block_products<C>(c, v, t + i * T, x, k, n_cols, policy, s[i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int q = 0; q < C; ++q) s[i][q] = __fadd_rn(0.0f, s[i][q]);
  }
  for (int k0 = P; k0 < width; k0 += P) {
    float p[N][C];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int slot = k0 + t + i * T;
      if (slot < width) {
        block_products<C>(c, v, slot, x, k, n_cols, policy, p[i]);
      } else {
#pragma unroll
        for (int q = 0; q < C; ++q) p[i][q] = 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int q = 0; q < C; ++q) s[i][q] = __fadd_rn(s[i][q], p[i][q]);
    }
  }
  tree_cols<N, C, N / 2>(s);
  Cols<C> out;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    float a = s[0][q];
#pragma unroll
    for (int off = T / 2; off > 0; off /= 2) {
      a = __fadd_rn(a, __shfl_down_sync(mask, a, off, T));
    }
    out.v[q] = a;
  }
  return out;
}

// The lanes of this thread's unit in its warp: T aligned lanes.
template <int T>
__device__ __forceinline__ unsigned unit_mask() {
  if constexpr (T == kWarp) {
    return 0xffffffffu;
  } else {
    return ((1u << T) - 1u) << (threadIdx.x & (kWarp - T));
  }
}

// Thread i of the consumers is thread t = i mod T of unit i / T, then of
// unit i / T + (consumers / T), …; unit u of a tile is its row u / G,
// columns (u mod G)·C … (G = k / C column groups), so a warp's units are
// a run of its rows' column groups and their stores one contiguous run.
// epi(row, j0, sums, policy) is called once for every unit, by its thread
// t = 0. Both paths inline unit_sum (an out-of-line call for the unstaged
// rows, as unstaged_row, spilled registers of the staged loop here).
template <int P, int T, int C, class Epi>
__global__ void __launch_bounds__(kMaxThreads + kWarp)
block_tiles_kernel(const int* __restrict__ col,
                   const float* __restrict__ val,
                   const float* __restrict__ x, int n_rows, int width,
                   int n_cols, int k, int rows_per_tile, int stages,
                   Epi epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];

  const int n_consumers = blockDim.x - kWarp;
  const int rows = rows_per_tile;
  const long long tile_slots = static_cast<long long>(rows) * width;
  const bool staged = width > 0 && stages > 0;
  const int n_full = n_rows / rows;
  const int n_tiles = (n_rows + rows - 1) / rows;
  int* s_col = reinterpret_cast<int*>(smem);
  float* s_val = reinterpret_cast<float*>(smem + stages * tile_slots * 4);

  if (threadIdx.x == 0 && staged) {
    for (int s = 0; s < stages; ++s) {
      bulk::mbar_init(&full[s], 1);
      bulk::mbar_init(&empty[s], n_consumers / kWarp);
    }
    bulk::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= n_consumers) {  // the producer warp
    if (threadIdx.x == n_consumers && staged) {
      produce(col, val, s_col, s_val, full, empty, tile_slots, stages,
              n_full);
    }
    return;
  }

  const int groups = k / C;
  const int units = rows * groups;
  const int t = threadIdx.x & (T - 1);
  const int first = threadIdx.x / T;
  const int step = n_consumers / T;
  const unsigned mask = unit_mask<T>();
  const uint64_t policy = bulk::evict_last_policy();
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * rows;
    if (staged && tile < n_full) {
      bulk::mbar_wait(&full[stage], phase);
      const int* c = s_col + stage * tile_slots;
      const float* v = s_val + stage * tile_slots;
      for (int u = first; u < units; u += step) {
        const int r = u / groups;
        const int j0 = (u - r * groups) * C;
        const int o = r * width;
        const Cols<C> sums = unit_sum<P, T, C>(c + o, v + o, width, t,
                                               x + j0, k, n_cols, policy,
                                               mask);
        if (t == 0) epi(row0 + r, j0, sums, policy);
      }
      __syncwarp();
      if (threadIdx.x % kWarp == 0) bulk::mbar_arrive(&empty[stage]);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    } else {  // the ragged last tile, width 0 or no stages: plain loads
      for (int u = first; u < units; u += step) {
        const int r = u / groups;
        if (row0 + r >= n_rows) break;
        const int j0 = (u - r * groups) * C;
        Cols<C> sums{};
        if (width > 0) {
          const long long o = (row0 + r) * width;
          sums = unit_sum<P, T, C>(col + o, val + o, width, t, x + j0, k,
                                   n_cols, policy, mask);
        }
        if (t == 0) epi(row0 + r, j0, sums, policy);
      }
    }
  }
}

// Checks the plan (repro_torch.kernels.ell_block_tile_plan: rows a tile, a
// multiple of 4 so that every tile's bulk copies are 16-byte multiples;
// stages; shared bytes; C; T; consumer threads, the tile's units' threads
// rounded up to warps, at most kMaxThreads) and launches the k-column form
// on a persistent grid.
template <int P, int C, class Epi>
int launch_block_kernel(const int* col, const float* val, const float* x,
                        int n_rows, int width, int n_cols, int k,
                        int rows_per_tile, int stages, int smem_bytes,
                        int cols, int unit_threads, int threads, Epi epi,
                        cudaStream_t stream) {
  constexpr int T = block_unit_threads(P, C);
  const long long tile_threads = static_cast<long long>(rows_per_tile) *
                                 (k / C) * T;        // one a unit's thread
  const long long warps = (tile_threads + kWarp - 1) / kWarp * kWarp;
  const long long want = warps < kMaxThreads ? warps : kMaxThreads;
  const long long tile_bytes = static_cast<long long>(rows_per_tile) *
                               width * 8;
  if (cols != C || unit_threads != T || rows_per_tile <= 0 ||
      rows_per_tile % 4 != 0 || threads != want || width < 0 ||
      stages < 0 || stages > kMaxStages || smem_bytes != stages * tile_bytes ||
      (width == 0 && stages != 0) ||
      reinterpret_cast<uintptr_t>(x) % (4 * C) != 0) {
    return cudaErrorInvalidValue;
  }
  const long long n_tiles = (n_rows + rows_per_tile - 1) / rows_per_tile;
  unsigned grid = 0;
  const cudaError_t e =
      bulk::persistent_grid<block_tiles_kernel<P, T, C, Epi>>(
          threads + kWarp, smem_bytes, n_tiles, &grid);
  if (e != cudaSuccess) return e;
  block_tiles_kernel<P, T, C, Epi>
      <<<grid, threads + kWarp, smem_bytes, stream>>>(
          col, val, x, n_rows, width, n_cols, k, rows_per_tile, stages, epi);
  return cudaGetLastError();
}

// The float kernels' k-column form over X of [n_cols, k]: picks the lane
// count P of row_sum (dispatch_width) and the unit's columns C from k, and
// launches (width 0 sums nothing).
template <class Epi>
int launch_block(const int* col, const float* val, const float* x,
                 int n_rows, int width, int n_cols, int k, int rows_per_tile,
                 int stages, int smem_bytes, int cols, int unit_threads,
                 int threads, Epi epi, cudaStream_t stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (k < 1) return cudaErrorInvalidValue;
  return dispatch_width(width, [&](auto lanes) {
    constexpr int P = decltype(lanes)::value;
    switch (block_cols(k)) {
      case 4:
        return launch_block_kernel<P, 4>(col, val, x, n_rows, width, n_cols,
                                         k, rows_per_tile, stages, smem_bytes,
                                         cols, unit_threads, threads, epi,
                                         stream);
      case 2:
        return launch_block_kernel<P, 2>(col, val, x, n_rows, width, n_cols,
                                         k, rows_per_tile, stages, smem_bytes,
                                         cols, unit_threads, threads, epi,
                                         stream);
      default:
        return launch_block_kernel<P, 1>(col, val, x, n_rows, width, n_cols,
                                         k, rows_per_tile, stages, smem_bytes,
                                         cols, unit_threads, threads, epi,
                                         stream);
    }
  });
}

}  // namespace ell_tiles
