// Fused weighted-Jacobi sweep for Hopper (sm_90a) on a square ELL system:
//   out = x + omega * inv * (b - (deg * x - A_ell x)),
//   inv = 1 / deg where deg > 0, else 0 (such rows return x unchanged).
//
// Replaces the TPU kernel src/repro/kernels/jacobi/jacobi.py ::
// jacobi_step_pallas.
//
// What bounds it on an H100: bytes. One sweep reads the col/val tables
// (8 bytes a slot), gathers x, reads x, b and deg for its own row and
// writes out: about 8 * n * width + 16 * n bytes for 2 flops a slot.
//
// Design: the row sums are spmv_ell.cu's (the TMA-staged tiles of
// ell_tiles.cuh), and the thread that owns a row applies the
// residual/update epilogue to it, reading x, b and deg and writing out
// with coalesced accesses, so a sweep is one pass instead of an SpMV plus
// three elementwise passes. The output is a new buffer: other rows still
// read x while a row writes its update, so the sweep never runs in
// place. The epilogue uses the _rn intrinsics to keep the plain version's
// rounding order (no contraction into fused multiply-adds). Width 0 still
// applies the epilogue, with A_ell x = 0.
//
// The k-column form (repro_jacobi_block_f32) replaces the same TPU kernel
// under jax.vmap over a column axis (the smoothers of the V-cycle that
// src/repro/core/krylov.py :: pcg_block(exact_columns=False) and
// src/repro/dist/solver.py :: _block_ops vmap): every column of row-major
// X, B [n, k] swept at once. Bound by bytes: 8 * n * width + 12 * k * n
// (X, B read, out written) + 4 * n (deg); a (row, slot) gathers one
// 32-byte sector of X at k = 8, the sector the one-vector sweep fetches
// for its 4 bytes, from L2 while X stays there (evict-last; B and out
// stream past it), from HBM where X outgrows it. The row sums are
// spmv_ell.cu's k-column ones (a thread a (row, group of C contiguous
// columns), T threads a row's slot lanes; ell_tiles.cuh), and the unit's
// first thread applies the epilogue to its C columns: X and B read and
// out written as C-vectors, deg read and inv computed once. Each
// column's sum has row_sum's additions in row_sum's order and its
// epilogue the one-vector sweep's _rn operations in their order, so each
// column is bitwise the one-vector sweep.

#include "ell_tiles.cuh"

namespace {

struct JacobiRow {
  const float* x;
  const float* b;
  const float* deg;
  float* out;
  float omega;
  __device__ __forceinline__ void operator()(long long r, float acc) const {
    const float xr = __ldg(x + r);
    const float d = __ldg(deg + r);
    const float res = __fsub_rn(__ldg(b + r), __fsub_rn(__fmul_rn(d, xr), acc));
    const float inv = d > 0.0f ? __fdiv_rn(1.0f, fmaxf(d, 1e-30f)) : 0.0f;
    out[r] = __fadd_rn(xr, __fmul_rn(__fmul_rn(omega, inv), res));
  }
};

// The same epilogue on C columns j0 .. j0+C of row r of row-major [n, k]
// blocks X, B and out (C-vector loads and one store; X under the gathers'
// L2 policy, B read and out written as streams); deg and inv are per row,
// read and computed once.
struct JacobiBlock {
  const float* x;
  const float* b;
  const float* deg;
  float* out;
  float omega;
  int k;
  template <int C>
  __device__ __forceinline__ void operator()(long long r, int j0,
                                             const ell_tiles::Cols<C>& acc,
                                             uint64_t policy) const {
    const long long i = r * k + j0;
    float xr[C], br[C], o[C];
    ell_tiles::load_cols<C>(x + i, policy, xr);
    ell_tiles::stream_cols<C>(b + i, br);
    const float d = __ldg(deg + r);
    const float inv = d > 0.0f ? __fdiv_rn(1.0f, fmaxf(d, 1e-30f)) : 0.0f;
    const float w = __fmul_rn(omega, inv);
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const float res =
          __fsub_rn(br[q], __fsub_rn(__fmul_rn(d, xr[q]), acc.v[q]));
      o[q] = __fadd_rn(xr[q], __fmul_rn(w, res));
    }
    ell_tiles::store_cols<C>(out + i, o);
  }
};

}  // namespace

extern "C" int repro_jacobi_f32(const void* col, const void* val,
                                const void* x, const void* b, const void* deg,
                                void* out, int n, int width, float omega,
                                int rows_per_tile, int stages, int smem_bytes,
                                void* stream) {
  const float* xx = static_cast<const float*>(x);
  return ell_tiles::launch(
      static_cast<const int*>(col), static_cast<const float*>(val), xx, n,
      width, n, rows_per_tile, stages, smem_bytes,
      JacobiRow{xx, static_cast<const float*>(b),
                static_cast<const float*>(deg), static_cast<float*>(out),
                omega},
      static_cast<cudaStream_t>(stream));
}

// The k-column form: one sweep of every column of row-major X, B [n, k]
// (the TPU kernel under jax.vmap over the column axis), on the plan of
// repro_torch.kernels.ell_block_tile_plan(width, k).
extern "C" int repro_jacobi_block_f32(const void* col, const void* val,
                                      const void* x, const void* b,
                                      const void* deg, void* out, int n,
                                      int width, int k, float omega,
                                      int rows_per_tile, int stages,
                                      int smem_bytes, int cols,
                                      int unit_threads, int threads,
                                      void* stream) {
  const uintptr_t align = 4 * ell_tiles::block_cols(k);
  if ((reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(out)) %
          align != 0) {
    return cudaErrorInvalidValue;
  }
  const float* xx = static_cast<const float*>(x);
  return ell_tiles::launch_block(
      static_cast<const int*>(col), static_cast<const float*>(val), xx, n,
      width, n, k, rows_per_tile, stages, smem_bytes, cols, unit_threads,
      threads,
      JacobiBlock{xx, static_cast<const float*>(b),
                  static_cast<const float*>(deg), static_cast<float*>(out),
                  omega, k},
      static_cast<cudaStream_t>(stream));
}
