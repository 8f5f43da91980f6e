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
// Design: the SpMV is spmv_ell.cu's (the row loop of ell_rows.cuh), and
// lane 0 of each group applies the residual/update epilogue, so a sweep
// is one pass instead of an SpMV plus three elementwise passes. The
// output is a new buffer: other rows still read x while a row writes its
// update, so the sweep never runs in place. The epilogue uses the _rn
// intrinsics to keep the plain version's rounding order (no contraction
// into fused multiply-adds).

#include "ell_rows.cuh"

namespace {

template <int G>
__global__ void __launch_bounds__(ell_rows::kBlock)
jacobi_kernel(const int* __restrict__ col, const float* __restrict__ val,
              const float* __restrict__ x, const float* __restrict__ b,
              const float* __restrict__ deg, float* __restrict__ out,
              int n, int width, float omega) {
  const ell_rows::RowGroup<G> g;
  float acc = 0.0f;
  ell_rows::for_each_slot<G>(col, g, n, width, n, [&](long long i, int c) {
    acc += __ldg(val + i) * __ldg(x + c);
  });
  ell_rows::merge_lanes<G>(acc, [](float& a, float o) { a += o; });
  if (g.lane == 0 && g.row < n) {
    const float xr = x[g.row];
    const float d = deg[g.row];
    const float r = __fsub_rn(b[g.row], __fsub_rn(__fmul_rn(d, xr), acc));
    const float inv = d > 0.0f ? __fdiv_rn(1.0f, fmaxf(d, 1e-30f)) : 0.0f;
    out[g.row] = __fadd_rn(xr, __fmul_rn(__fmul_rn(omega, inv), r));
  }
}

}  // namespace

extern "C" int repro_jacobi_f32(const void* col, const void* val,
                                const void* x, const void* b, const void* deg,
                                void* out, int n, int width, float omega,
                                void* stream) {
  const int* c = static_cast<const int*>(col);
  const float* v = static_cast<const float*>(val);
  const float* xx = static_cast<const float*>(x);
  const float* bb = static_cast<const float*>(b);
  const float* d = static_cast<const float*>(deg);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ell_rows::dispatch_width(n, width, [&](auto group, unsigned grid) {
    constexpr int G = decltype(group)::value;
    jacobi_kernel<G><<<grid, ell_rows::kBlock, 0, s>>>(c, v, xx, bb, d, o, n,
                                                       width, omega);
  });
  return static_cast<int>(cudaGetLastError());
}
