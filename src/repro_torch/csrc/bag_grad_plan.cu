// The embedding-bag backward's plan on the card (sm_90a): the slots of an
// [n_bags, hot] int32 id batch sorted by id, stably, as two int32 arrays:
//   sorted_ids[i] = key of the i-th slot in sorted order, where the key of
//                   an id in [0, V) is the id and of any other id V;
//   rows[i]       = that slot's bag (its g_out row, slot / hot).
// Bit for bit what kernels.embedding_bag.ops.bag_grad_plan_ref computes
// with torch.sort (a stable sort has one result). Built once a batch and
// shared by DeepFM's two tables (csrc/embedding_bag_backward.cu reads it).
//
// Replaces no TPU kernel: the reference differentiates jnp.take, whose
// scatter-add XLA sorts internally; the port's plan was a stable
// torch.sort of the keyed ids with int64 slot indices, then two passes
// for the rows.
//
// What bounds it on an H100: bytes. The function reads 4 bytes of ids and
// writes 8 bytes (id and row) a slot. A radix sort makes a pass over keys
// and values per 8-bit digit: torch.sort sorts all 32 bits of an int32 key
// with int64 values (4 passes of 12 bytes a slot, read and written), where
// the keys here need only ceil(log2(V + 1)) bits (22 at DeepFM's V =
// 3,729,408: 3 passes) and the values are int32 (8 bytes a slot).
//
// Design: bag_grad_keys writes each slot's key and row in one pass over
// the ids; then CUB's DeviceRadixSort::SortPairs (the CUDA toolkit's
// headers; stable, onesweep) over bits [0, ceil(log2(V + 1))) of the
// unsigned keys, into sorted_ids and rows. CUB is compiled into this file
// under the namespace repro_bag_plan, so its kernels' names tell them
// apart from PyTorch's own sorts in a profile.

#define CUB_WRAPPED_NAMESPACE repro_bag_plan
#define THRUST_WRAPPED_NAMESPACE repro_bag_plan

#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bag_grad_keys(const int* __restrict__ idx, int n, int hot, int n_vocab,
              unsigned* __restrict__ keys, int* __restrict__ rows) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const int id = idx[i];
    keys[i] = static_cast<unsigned>(id) < static_cast<unsigned>(n_vocab)
                  ? static_cast<unsigned>(id)
                  : static_cast<unsigned>(n_vocab);
    rows[i] = static_cast<int>(i / hot);
  }
}

int end_bit(int n_vocab) {   // bits that hold every key, V included
  int bits = 0;
  while (bits < 32 && (static_cast<unsigned>(n_vocab) >> bits) != 0) ++bits;
  return bits;
}

}  // namespace

// With temp == nullptr: writes the temporary bytes the sort needs to
// *temp_bytes and launches nothing. Else: keys_in and rows_in are scratch
// of n_slots int32 each, temp holds *temp_bytes bytes; writes sorted_ids
// and rows (n_slots int32 each).
extern "C" int repro_bag_grad_plan_i32(const void* idx, long long n_slots,
                                       int hot, int n_vocab, void* keys_in,
                                       void* rows_in, void* sorted_ids,
                                       void* rows, void* temp,
                                       long long* temp_bytes, void* stream) {
  if (n_slots < 0 || n_slots > INT_MAX || hot <= 0 || n_vocab <= 0 ||
      n_vocab == INT_MAX || temp_bytes == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = static_cast<int>(n_slots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t bytes = temp == nullptr ? 0 : static_cast<size_t>(*temp_bytes);
  unsigned* k_in = static_cast<unsigned*>(keys_in);
  int* r_in = static_cast<int*>(rows_in);
  if (temp == nullptr) {
    const cudaError_t e = repro_bag_plan::cub::DeviceRadixSort::SortPairs(
        nullptr, bytes, k_in, static_cast<unsigned*>(sorted_ids), r_in,
        static_cast<int*>(rows), n, 0, end_bit(n_vocab), s);
    *temp_bytes = static_cast<long long>(bytes);
    return static_cast<int>(e);
  }
  if (n == 0) return 0;
  int blocks = 0, sms = 0, dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 8 * sms) blocks = 8 * sms;
  bag_grad_keys<<<blocks, kThreads, 0, s>>>(static_cast<const int*>(idx), n,
                                             hot, n_vocab, k_in, r_in);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = repro_bag_plan::cub::DeviceRadixSort::SortPairs(
      temp, bytes, k_in, static_cast<unsigned*>(sorted_ids), r_in,
      static_cast<int*>(rows), n, 0, end_bit(n_vocab), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
