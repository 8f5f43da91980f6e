// The bulk-copy pipeline primitives of the port's Hopper (sm_90a) kernels:
// mbarrier phases, 1-D bulk copies (cp.async.bulk, the TMA's non-tensor
// form) between global and shared memory, L2 evict-first and evict-last
// policies, and the persistent grid that the staged kernels launch.
//
// Users: ell_tiles.cuh (spmv_ell, jacobi, agg_vote) stages its row tiles
// with bulk_load; embedding_bag.cu stages its id tiles with bulk_load and
// writes its output tiles with bulk_store.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace bulk {

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

// Makes the barriers' initialisation visible to the bulk copies.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// An L2 policy that evicts a streamed array first, so that what the
// kernel gathers (a vector, a table's hot rows) stays in L2 while the
// stream passes through it.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// An L2 policy that evicts a gathered array last, so that the gathers'
// lines outlive what streams past them (the ELL kernels' k-column form:
// X, gathered at random rows, has to stay in L2 while the tables and the
// result pass through it).
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
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

// Orders this thread's plain writes to shared memory before later bulk
// copies out of it (the async proxy); each writing thread fences, then
// the threads synchronise, then one thread issues bulk_store.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Bulk copy of `bytes` (a multiple of 16; both addresses 16-B aligned)
// from shared to global memory, in this thread's current bulk group;
// bulk_commit closes the group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's bulk groups still read their
// shared-memory source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until all of this thread's bulk groups have completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The persistent grid of kernel kKern: sets its dynamic shared-memory
// limit to what the card allows (once), and returns in *grid the blocks of
// `threads` threads and `smem_bytes` dynamic shared memory that fit on the
// card at once, at most n_tiles (one block per tile at most). Returns a
// cudaError_t.
template <auto kKern>
cudaError_t persistent_grid(int threads, int smem_bytes, long long n_tiles,
                            unsigned* grid) {
  static const cudaError_t attr = [] {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kKern);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kKern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(fa.sharedSizeBytes));
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  // blocks that fit on the card at once, kept for the last (device,
  // block shape) this kernel was launched with
  static int last_dev = -1, last_threads = -1, last_smem = -1;
  static long long fit = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != last_dev || threads != last_threads || smem_bytes != last_smem) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKern,
                                                        threads, smem_bytes);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    fit = static_cast<long long>(per_sm) * sms;
    last_dev = dev;
    last_threads = threads;
    last_smem = smem_bytes;
  }
  *grid = static_cast<unsigned>(n_tiles < fit ? n_tiles : fit);
  return cudaSuccess;
}

}  // namespace bulk
