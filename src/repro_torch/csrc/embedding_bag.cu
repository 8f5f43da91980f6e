// Multi-hot embedding bag for Hopper (sm_90a):
//   out[b, j] = sum_h table[idx[b, h], j]
// over a [V, d] float32 table and [n_bags, hot] int32 ids. An id outside
// [0, V) contributes 0 and is never read; the sum is taken in float32,
// h = 0 .. hot-1 in order, as the reference's _bag_kernel does.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/embedding_bag.py
// :: embedding_bag_pallas.
//
// What bounds it on an H100: bytes. One call reads the ids once
// (4 * hot bytes a bag), reads each distinct valid row of the table once
// from HBM (4 * d bytes; repeats of a hot row hit L2), and writes
// 4 * d bytes a bag; the work is one float add per (bag, h, j), far below
// the card's 67 TFLOP/s float32 line.
//
// Design: the Pallas kernel mapped the whole table (plus one appended zero
// row) into one VMEM block and padded the batch to its block size. On
// Hopper a 149 MB table cannot sit in 227 KB of shared memory, so rows are
// gathered through L2 and the read-only path (__ldg); the Zipf-like ids of
// recsys traffic keep the hot rows there. Nothing is padded or copied:
// invalid ids (the reference's pad row id == V included) are masked before
// the read, and the ragged last tile is masked by its bag count. A block
// owns kBags consecutive bags, i.e. kBags * d consecutive outputs, and its
// threads walk them with stride kBlock: neighbouring threads write
// neighbouring floats (coalesced stores) and read neighbouring floats of
// the same 4*d-byte row, which need not be 16-byte aligned (d = 10 gives
// 40-byte rows). d = 1 is then one thread per bag. Bag and row offsets are
// 64-bit; the in-tile index is 32-bit, so its division by d stays cheap.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kBlock = 256;
constexpr int kBags = 256;

__global__ void __launch_bounds__(kBlock)
embedding_bag_kernel(const float* __restrict__ table,
                     const int* __restrict__ idx, float* __restrict__ out,
                     long long n_bags, int hot, int d, int n_vocab) {
  const long long bag0 = static_cast<long long>(blockIdx.x) * kBags;
  const long long left = n_bags - bag0;
  const int nb = left < kBags ? static_cast<int>(left) : kBags;
  const unsigned n_el = static_cast<unsigned>(nb) * static_cast<unsigned>(d);
  const unsigned ud = static_cast<unsigned>(d);
  const int* ids0 = idx + bag0 * hot;
  float* out0 = out + bag0 * d;
  for (unsigned l = threadIdx.x; l < n_el; l += kBlock) {
    const unsigned lb = l / ud;
    const unsigned j = l - lb * ud;
    const int* ids = ids0 + static_cast<long long>(lb) * hot;
    float acc = 0.0f;
    for (int h = 0; h < hot; ++h) {
      const int id = __ldg(ids + h);
      if (id >= 0 && id < n_vocab)
        acc += __ldg(table + static_cast<long long>(id) * d + j);
    }
    out0[l] = acc;
  }
}

}  // namespace

extern "C" int repro_embedding_bag_f32(const void* table, const void* idx,
                                       void* out, long long n_bags, int hot,
                                       int d, int n_vocab, void* stream) {
  if (n_bags <= 0 || hot <= 0 || d <= 0) return 0;
  if (d > INT_MAX / kBags) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (n_bags + kBags - 1) / kBags;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  embedding_bag_kernel<<<static_cast<unsigned>(grid), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx),
      static_cast<float*>(out), n_bags, hot, d, n_vocab);
  return static_cast<int>(cudaGetLastError());
}
