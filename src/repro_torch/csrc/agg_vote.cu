// Fused Alg 2 vote reduction for Hopper (sm_90a).
//
// Per ELL row r, over the slots w with a real neighbour c = col[r, w]
// (0 <= c < n_cols) whose state s = state[c] is not Decided:
//   key = s * (levels + 2) + sq[r, w]
// and the row returns (max key, min c among the slots attaining it). A row
// with no such slot returns the identity (INT32_MIN, INT32_MAX).
//
// Replaces the TPU kernel src/repro/kernels/agg_vote/agg_vote.py ::
// vote_reduce_pallas.
//
// What bounds it on an H100: bytes. One round reads the int32 col and sq
// tables once (8 bytes a slot), gathers state, and writes two int32 per
// row; the integer work is a multiply-add and two compares a slot.
//
// Design: the row loop of ell_rows.cuh, with state gathered through L2.
// Each lane keeps a running lexicographic best (key, id) with the
// reference's update rule (larger key, or equal key and smaller id), and
// the butterfly merges the lanes with the same rule. The merge is exact
// because the integer ⊕ is associative and commutative: the result is
// bit-exact whatever the lane split. Padding and Decided neighbours are
// tested in the kernel (on the gathered state, not only on col), so no
// sentinel slot is appended to state and no padding rows are added.

#include <climits>

#include "ell_rows.cuh"

namespace {

// best = (key, id); the reference's update rule
__device__ __forceinline__ void lex_merge(int2& best, int2 kv) {
  if (kv.x > best.x || (kv.x == best.x && kv.y < best.y)) best = kv;
}

template <int G>
__global__ void __launch_bounds__(ell_rows::kBlock)
vote_kernel(const int* __restrict__ col, const int* __restrict__ sq,
            const int* __restrict__ state, int* __restrict__ best_key,
            int* __restrict__ best_id, int n_rows, int width, int n_cols,
            int levels, int decided) {
  const ell_rows::RowGroup<G> g;
  int2 best = make_int2(INT_MIN, INT_MAX);
  ell_rows::for_each_slot<G>(col, g, n_rows, width, n_cols,
                             [&](long long i, int c) {
                               const int s = __ldg(state + c);
                               if (s != decided) {
                                 lex_merge(best, make_int2(
                                     s * (levels + 2) + __ldg(sq + i), c));
                               }
                             });
  ell_rows::merge_lanes<G>(best, [](int2& a, int2 o) { lex_merge(a, o); });
  if (g.lane == 0 && g.row < n_rows) {
    best_key[g.row] = best.x;
    best_id[g.row] = best.y;
  }
}

}  // namespace

extern "C" int repro_agg_vote_i32(const void* col, const void* sq,
                                  const void* state, void* best_key,
                                  void* best_id, int n_rows, int width,
                                  int n_cols, int levels, int decided,
                                  void* stream) {
  const int* c = static_cast<const int*>(col);
  const int* q = static_cast<const int*>(sq);
  const int* st = static_cast<const int*>(state);
  int* k = static_cast<int*>(best_key);
  int* i = static_cast<int*>(best_id);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ell_rows::dispatch_width(n_rows, width, [&](auto group, unsigned grid) {
    constexpr int G = decltype(group)::value;
    vote_kernel<G><<<grid, ell_rows::kBlock, 0, s>>>(
        c, q, st, k, i, n_rows, width, n_cols, levels, decided);
  });
  return static_cast<int>(cudaGetLastError());
}
