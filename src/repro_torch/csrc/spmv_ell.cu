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
//
// Design: the Pallas kernel kept all of x in VMEM; at n = 2^20 that is
// 4 MB, far over the 227 KB of shared memory a block may use, so x is
// gathered through L2 instead. The row loop (G lanes per row, coalesced
// table reads, in-kernel masking, shuffle butterfly) is ell_rows.cuh's.

#include "ell_rows.cuh"

namespace {

template <int G>
__global__ void __launch_bounds__(ell_rows::kBlock)
spmv_ell_kernel(const int* __restrict__ col, const float* __restrict__ val,
                const float* __restrict__ x, float* __restrict__ y,
                int n_rows, int width, int n_cols) {
  const ell_rows::RowGroup<G> g;
  float acc = 0.0f;
  ell_rows::for_each_slot<G>(col, g, n_rows, width, n_cols,
                             [&](long long i, int c) {
                               acc += __ldg(val + i) * __ldg(x + c);
                             });
  ell_rows::merge_lanes<G>(acc, [](float& a, float o) { a += o; });
  if (g.lane == 0 && g.row < n_rows) y[g.row] = acc;
}

}  // namespace

extern "C" int repro_spmv_ell_f32(const void* col, const void* val,
                                  const void* x, void* y, int n_rows,
                                  int width, int n_cols, void* stream) {
  const int* c = static_cast<const int*>(col);
  const float* v = static_cast<const float*>(val);
  const float* xx = static_cast<const float*>(x);
  float* yy = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ell_rows::dispatch_width(n_rows, width, [&](auto group, unsigned grid) {
    constexpr int G = decltype(group)::value;
    spmv_ell_kernel<G><<<grid, ell_rows::kBlock, 0, s>>>(c, v, xx, yy, n_rows,
                                                         width, n_cols);
  });
  return static_cast<int>(cudaGetLastError());
}
