// A row of d floats split over a warp's lanes: the wide-row paths of the
// bag gather (embedding_bag.cu) and its scatter (embedding_bag_backward.cu)
// for rows of d >= 32 floats (kernels.bag_path).
//
// Lane j of a warp takes columns j·VEC, (j + 32)·VEC, ... of the row in
// loads of VEC floats: VEC = 4 (16-byte loads) where d % 4 == 0 and every
// row the kernel reads or writes starts on a 16-byte boundary, else VEC = 1.
// A warp's load is then 32·VEC contiguous floats whatever d is. A slab is
// U such loads a lane (32·U·VEC columns, U = 1..4, the least that covers
// the row up to 4); a row of more columns takes several slabs, each a warp
// of its own, so a wide row is spread over several warps.

#pragma once

#include <cuda_runtime.h>

namespace slabs {

constexpr int kWarp = 32;
constexpr int kMaxU = 4;

// The loads a lane takes in a slab for rows of n_vec vectors.
__host__ __device__ constexpr int loads_per_lane(int n_vec) {
  return n_vec <= kWarp ? 1 : n_vec <= 2 * kWarp ? 2
                        : n_vec <= 3 * kWarp ? 3 : kMaxU;
}

__host__ __device__ constexpr long long n_slabs(int n_vec, int u) {
  return (n_vec + kWarp * u - 1) / (kWarp * u);
}

template <int VEC>
__device__ __forceinline__ void zero(float (&a)[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) a[e] = 0.0f;
}

// Through the read-only path: data no thread of the launch writes.
template <int VEC>
__device__ __forceinline__ void load_ro(const float* p, float (&a)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    a[0] = t.x;
    a[1] = t.y;
    a[2] = t.z;
    a[3] = t.w;
  } else {
    a[0] = __ldg(p);
  }
}

// A plain load: data this launch also writes (a running sum).
template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&a)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    a[0] = t.x;
    a[1] = t.y;
    a[2] = t.z;
    a[3] = t.w;
  } else {
    a[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&a)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
    *p = a[0];
  }
}

// A streaming store (evict-first): rows no later access of the launch
// reads, in outputs larger than L2.
template <int VEC>
__device__ __forceinline__ void store_stream(float* p, const float (&a)[VEC]) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
  } else {
    __stcs(p, a[0]);
  }
}

}  // namespace slabs
