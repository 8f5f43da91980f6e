// ELL SpMV for Hopper (sm_90a): y[r] = sum_w val[r, w] * x[col[r, w]].
//
// Replaces the TPU kernel src/repro/kernels/spmv_ell/spmv_ell.py ::
// spmv_ell_pallas. Slots with col outside [0, n_cols) are padding and are
// skipped; the sum is taken in float32.
//
// What bounds it on an H100: bytes. Each call reads the [n_rows, width]
// col (int32) and val (float32) tables once, gathers x, and writes y:
// about 8 * n_rows * width + 4 * (n_cols + n_rows) bytes against no more
// than 2 flops per slot, far below the card's 67 TFLOP/s float32 line.
// Reaching that bound takes memory-level parallelism: about 3 MB in
// flight across the card at 3.35 TB/s.
//
// Design: the Pallas kernel kept all of x in VMEM; at n = 2^20 that is
// 4 MB, far over the 227 KB of shared memory a block may use, so x is
// gathered through L2 instead. The tables stream into shared memory by
// bulk copies (TMA) a tile ahead of the rows being summed, and each
// thread sums one row with its gathers issued in passes, so neither the
// stream nor the gathers wait on the other (ell_tiles.cuh). The store of
// y is coalesced. Staged this way the stream alone runs near the byte
// bound; the gathers of x are what is left (PERF.md).
//
// The k-column form (repro_spmv_ell_block_f32) replaces the same TPU
// kernel under jax.vmap over a column axis (src/repro/sparse/matvec.py ::
// level_spmm, src/repro/core/krylov.py :: pcg_block(exact_columns=False),
// src/repro/dist/solver.py :: _block_ops): Y[r, j] = sum_w val[r, w] *
// X[col[r, w], j] for row-major X [n_cols, k], Y [n_rows, k]. Its bound is
// bytes too: 8 * n_rows * width + 4 * k * (n_cols + n_rows), the tables
// read once for all k columns. A (row, slot) gathers X's row col[r, w]:
// at k = 8 one 32-byte sector, the sector that the one-vector kernel
// fetches from L2 for its 4 bytes, so k columns cost about the gathers of
// one one-vector launch while X stays in L2 (gathered under an evict-last
// policy, the result stored as a stream); where X outgrows L2 (32 MB at
// 2^20 rows, k = 8), a gather costs a sector of HBM. A thread owns a
// (row, group of C = 4, 2 or 1 contiguous columns) and T threads split
// the row's slot lanes (ell_tiles.cuh, "k-column form"): each slot is
// read from shared memory once for C columns, gathered as one float4 /
// float2, and stored with one vector store by the unit's first thread.
// Each column is summed with row_sum's additions in row_sum's order (the
// tree's small offsets by shuffles), so it is bitwise the one-vector
// kernel's.

#include "ell_tiles.cuh"

namespace {

struct StoreRow {
  float* y;
  __device__ __forceinline__ void operator()(long long r, float acc) const {
    y[r] = acc;
  }
};

// Y[r, j0 .. j0+C) of a row-major [n_rows, k] block, one streaming vector
// store: a warp's units store one contiguous run.
struct StoreBlock {
  float* y;
  int k;
  template <int C>
  __device__ __forceinline__ void operator()(long long r, int j0,
                                             const ell_tiles::Cols<C>& acc,
                                             uint64_t) const {
    ell_tiles::store_cols<C>(y + r * k + j0, acc.v);
  }
};

}  // namespace

extern "C" int repro_spmv_ell_f32(const void* col, const void* val,
                                  const void* x, void* y, int n_rows,
                                  int width, int n_cols, int rows_per_tile,
                                  int stages, int smem_bytes, void* stream) {
  return ell_tiles::launch(
      static_cast<const int*>(col), static_cast<const float*>(val),
      static_cast<const float*>(x), n_rows, width, n_cols, rows_per_tile,
      stages, smem_bytes, StoreRow{static_cast<float*>(y)},
      static_cast<cudaStream_t>(stream));
}

// The k-column form: Y = A_ell X for row-major X [n_cols, k] and Y
// [n_rows, k] (the TPU kernel under jax.vmap over the column axis), on the
// plan of repro_torch.kernels.ell_block_tile_plan(width, k).
extern "C" int repro_spmv_ell_block_f32(const void* col, const void* val,
                                        const void* x, void* y, int n_rows,
                                        int width, int n_cols, int k,
                                        int rows_per_tile, int stages,
                                        int smem_bytes, int cols,
                                        int unit_threads, int threads,
                                        void* stream) {
  if (reinterpret_cast<uintptr_t>(y) % (4 * ell_tiles::block_cols(k)) != 0) {
    return cudaErrorInvalidValue;
  }
  return ell_tiles::launch_block(
      static_cast<const int*>(col), static_cast<const float*>(val),
      static_cast<const float*>(x), n_rows, width, n_cols, k, rows_per_tile,
      stages, smem_bytes, cols, unit_threads, threads,
      StoreBlock{static_cast<float*>(y), k},
      static_cast<cudaStream_t>(stream));
}
