// The row loop of the port's integer ELL kernel, agg_vote, for Hopper
// (sm_90a). The float kernels (spmv_ell, jacobi) moved to the TMA-staged,
// one-thread-per-row tiles of ell_tiles.cuh; this header now serves
// agg_vote alone, unchanged in behaviour.
//
// Layout: a [n_rows, width] table, row-major, whose slots with a column
// outside [0, n_cols) are padding. A group of G lanes (G the power of two
// >= width, at most 32) shares one row: the lanes of a warp read
// neighbouring slots of neighbouring rows, so the table streams are
// coalesced, and the gathers of the column's data go through L2 and the
// read-only path (__ldg), since a vector of 2^20 entries does not fit in
// shared memory. The ragged row edge is masked here: no padding rows and
// no sentinel slot appended to the gathered vector.
//
// A kernel supplies what it does per real slot and how two lanes' partial
// results merge; the merge runs as a shuffle butterfly, after which every
// lane of the group holds the row's result.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace ell_rows {

constexpr int kBlock = 256;

// The lane of this thread in its group, and the group's row.
template <int G>
struct RowGroup {
  int lane;
  long long row;
  __device__ __forceinline__ RowGroup()
      : lane(threadIdx.x % G),
        row(static_cast<long long>(blockIdx.x) * (kBlock / G) +
            threadIdx.x / G) {}
};

// Calls slot(i, c) for this lane's slots i (flat index into the table) of
// the group's row whose column c lies in [0, n_cols).
template <int G, class Slot>
__device__ __forceinline__ void for_each_slot(const int* __restrict__ col,
                                              const RowGroup<G>& g,
                                              int n_rows, int width,
                                              int n_cols, Slot&& slot) {
  if (g.row >= n_rows) return;
  const long long base = g.row * width;
  for (int w = g.lane; w < width; w += G) {
    const int c = __ldg(col + base + w);
    if (static_cast<unsigned>(c) < static_cast<unsigned>(n_cols)) {
      slot(base + w, c);
    }
  }
}

__device__ __forceinline__ float shfl_xor(float v, int off) {
  return __shfl_xor_sync(0xffffffffu, v, off);
}

__device__ __forceinline__ int2 shfl_xor(int2 v, int off) {
  return make_int2(__shfl_xor_sync(0xffffffffu, v.x, off),
                   __shfl_xor_sync(0xffffffffu, v.y, off));
}

// merge(acc, other) over the G lanes of the group. Every lane of the warp
// must reach it: rows past the edge merge their identity.
template <int G, class T, class Merge>
__device__ __forceinline__ void merge_lanes(T& acc, Merge&& merge) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    merge(acc, shfl_xor(acc, off));
  }
}

inline unsigned grid_for(int n_rows, int g) {
  const int rows_per_block = kBlock / g;
  return static_cast<unsigned>((n_rows + rows_per_block - 1) /
                               rows_per_block);
}

// Calls launch(std::integral_constant<int, G>{}, grid) with the group size
// for `width`; nothing when there are no rows.
template <class Launch>
void dispatch_width(int n_rows, int width, Launch&& launch) {
  if (n_rows <= 0) return;
  if (width <= 1) {
    launch(std::integral_constant<int, 1>{}, grid_for(n_rows, 1));
  } else if (width <= 2) {
    launch(std::integral_constant<int, 2>{}, grid_for(n_rows, 2));
  } else if (width <= 4) {
    launch(std::integral_constant<int, 4>{}, grid_for(n_rows, 4));
  } else if (width <= 8) {
    launch(std::integral_constant<int, 8>{}, grid_for(n_rows, 8));
  } else if (width <= 16) {
    launch(std::integral_constant<int, 16>{}, grid_for(n_rows, 16));
  } else {
    launch(std::integral_constant<int, 32>{}, grid_for(n_rows, 32));
  }
}

}  // namespace ell_rows
