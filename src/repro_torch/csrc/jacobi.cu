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
// (X, B read, out written) + 4 * n (deg). The tables are staged once for
// all columns and a row's lanes gather X[col, :] as k contiguous floats
// (spmv_ell.cu, ell_tiles.cuh); the epilogue reads X and B and writes out
// as a warp's contiguous runs. Each column is bitwise the one-vector sweep.

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

// The same epilogue on row-major [n, k] blocks X, B and out; deg and inv
// are per row. A warp's lanes read and write its rows' k contiguous
// floats.
struct JacobiBlock {
  const float* x;
  const float* b;
  const float* deg;
  float* out;
  float omega;
  int k;
  __device__ __forceinline__ void operator()(long long r, int j,
                                             float acc) const {
    const long long i = r * k + j;
    const float xr = __ldg(x + i);
    const float d = __ldg(deg + r);
    const float res = __fsub_rn(__ldg(b + i), __fsub_rn(__fmul_rn(d, xr), acc));
    const float inv = d > 0.0f ? __fdiv_rn(1.0f, fmaxf(d, 1e-30f)) : 0.0f;
    out[i] = __fadd_rn(xr, __fmul_rn(__fmul_rn(omega, inv), res));
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
// (the TPU kernel under jax.vmap over the column axis).
extern "C" int repro_jacobi_block_f32(const void* col, const void* val,
                                      const void* x, const void* b,
                                      const void* deg, void* out, int n,
                                      int width, int k, float omega,
                                      int rows_per_tile, int stages,
                                      int smem_bytes, void* stream) {
  const float* xx = static_cast<const float*>(x);
  return ell_tiles::launch_block(
      static_cast<const int*>(col), static_cast<const float*>(val), xx, n,
      width, n, k, rows_per_tile, stages, smem_bytes,
      JacobiBlock{xx, static_cast<const float*>(b),
                  static_cast<const float*>(deg), static_cast<float*>(out),
                  omega, k},
      static_cast<cudaStream_t>(stream));
}
