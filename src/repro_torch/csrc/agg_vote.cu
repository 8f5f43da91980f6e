// Fused Alg 2 vote reduction for Hopper (sm_90a).
//
// Per ELL row r, over the slots w with a real neighbour c = col[r, w]
// (0 <= c < n_cols) whose state s = state[c] is not Decided:
//   key = s * (levels + 2) + sq[r, w]
// and the row returns (max key, min c among the slots attaining it). A row
// with no such slot returns the identity (INT32_MIN, INT32_MAX).
//
// Replaces the TPU kernel src/repro/kernels/agg_vote/agg_vote.py ::
// vote_reduce_pallas, and (repro_agg_vote_batched_i32, StackedVote below)
// what jax.vmap over a group of graphs makes of it in the batched setup
// (src/repro/core/setup_step.py _batch_program): one launch over G graphs'
// stacked tables, each row reduced over its own graph's state.
//
// What bounds it on an H100: bytes. One round reads the int32 col and sq
// tables once (8 bytes a slot), gathers state, and writes two int32 per
// row; the integer work is a multiply-add and two compares a slot.
//
// Design: the TMA-staged row tiles of ell_tiles.cuh, with sq in the place
// of val (4 bytes a slot, so the float kernels' tile plan applies as it
// is). One consumer thread per row reads a pass of P slots from shared
// memory and issues all P gathers of state (2.8 MB at 699,024 rows; it
// stays in L2) before it merges any of them, keeping the lexicographic
// best in registers with the reference's rule (larger key, or equal key
// and smaller id). The ⊕ is associative and commutative, so a row may
// start at any slot: the thread at tile position r starts each pass at
// rotation(r, g) and wraps around, which spreads a warp's shared-memory
// reads over the banks (at width 8 the rows are 8 words apart) with no
// shifter back, and the result is bit-exact whatever the order. Padding
// and Decided neighbours are tested in the kernel (on the gathered state,
// not only on col), so no sentinel slot is appended to state and no
// padding rows are added.

#include <climits>

#include "ell_tiles.cuh"

namespace {

// best = (key, id); the reference's update rule
__device__ __forceinline__ void lex_merge(int2& best, int2 kv) {
  if (kv.x > best.x || (kv.x == best.x && kv.y < best.y)) best = kv;
}

template <int P>
struct VoteRow {
  using Val = int;
  const int* state;
  int n_cols;
  int levels;
  int decided;
  int g;  // ell_tiles::bank_group(width)
  __device__ __forceinline__ int2 operator()(const int* c, const int* q,
                                             int width, int r) const {
    const int rot = ell_tiles::rotation(r, g);  // < g <= P
    int2 best = identity();
    for (int k0 = 0; k0 < width; k0 += P) {
      int cc[P], qq[P], s[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int k = k0 + ((j + rot) & (P - 1));
        cc[j] = k < width ? c[k] : -1;
        qq[j] = k < width ? q[k] : 0;
        s[j] = static_cast<unsigned>(cc[j]) < static_cast<unsigned>(n_cols)
                   ? __ldg(state + cc[j])
                   : decided;
      }
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (s[j] != decided) {
          lex_merge(best, make_int2(s[j] * (levels + 2) + qq[j], cc[j]));
        }
      }
    }
    return best;
  }
  __device__ __forceinline__ static int2 identity() {
    return make_int2(INT_MIN, INT_MAX);
  }
};

// The graph-batched form: the tables are G graphs' [rows_per_graph, width]
// tables stacked ([G·rows_per_graph, width], each graph's own column ids)
// and state is [G, n_cols]. A row finds its graph as row / rows_per_graph
// and reduces over that graph's state, as VoteRow does for one graph; the
// ids it returns are its graph's own. (What jax.vmap over a graph axis
// makes of vote_reduce_pallas: one launch for the group.)
template <int P>
struct StackedVote {
  using Val = int;
  static constexpr bool kGlobalRow = true;
  const int* state;
  int rows_per_graph;
  int n_cols;
  int levels;
  int decided;
  int g;  // ell_tiles::bank_group(width)
  __device__ __forceinline__ int2 operator()(const int* c, const int* q,
                                             int width, int r,
                                             long long row) const {
    // the stacked row count fits int32 (the wrapper checks it)
    const int graph = static_cast<int>(row) / rows_per_graph;
    const int* st = state + static_cast<long long>(graph) * n_cols;
    return VoteRow<P>{st, n_cols, levels, decided, g}(c, q, width, r);
  }
  __device__ __forceinline__ static int2 identity() {
    return VoteRow<P>::identity();
  }
};

struct StoreVote {
  int* best_key;
  int* best_id;
  __device__ __forceinline__ void operator()(long long r, int2 best) const {
    best_key[r] = best.x;
    best_id[r] = best.y;
  }
};

}  // namespace

extern "C" int repro_agg_vote_i32(const void* col, const void* sq,
                                  const void* state, void* best_key,
                                  void* best_id, int n_rows, int width,
                                  int n_cols, int levels, int decided,
                                  int rows_per_tile, int stages,
                                  int smem_bytes, void* stream) {
  const int* c = static_cast<const int*>(col);
  const int* q = static_cast<const int*>(sq);
  const int* st = static_cast<const int*>(state);
  const StoreVote epi{static_cast<int*>(best_key), static_cast<int*>(best_id)};
  const int g = ell_tiles::bank_group(width);
  return ell_tiles::dispatch_width(width, [&](auto lanes) {
    constexpr int P = decltype(lanes)::value;
    return ell_tiles::launch_kernel(
        c, q, n_rows, width, rows_per_tile, stages, smem_bytes,
        VoteRow<P>{st, n_cols, levels, decided, g}, epi,
        static_cast<cudaStream_t>(stream));
  });
}

extern "C" int repro_agg_vote_batched_i32(const void* col, const void* sq,
                                          const void* state, void* best_key,
                                          void* best_id, int n_graphs,
                                          int rows_per_graph, int width,
                                          int n_cols, int levels, int decided,
                                          int rows_per_tile, int stages,
                                          int smem_bytes, void* stream) {
  const int* c = static_cast<const int*>(col);
  const int* q = static_cast<const int*>(sq);
  const int* st = static_cast<const int*>(state);
  const StoreVote epi{static_cast<int*>(best_key), static_cast<int*>(best_id)};
  const int g = ell_tiles::bank_group(width);
  const long long n_rows = static_cast<long long>(n_graphs) * rows_per_graph;
  if (n_graphs < 0 || rows_per_graph < 0 || n_rows > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  return ell_tiles::dispatch_width(width, [&](auto lanes) {
    constexpr int P = decltype(lanes)::value;
    return ell_tiles::launch_kernel(
        c, q, static_cast<int>(n_rows), width, rows_per_tile, stages,
        smem_bytes,
        StackedVote<P>{st, rows_per_graph, n_cols, levels, decided, g},
        epi, static_cast<cudaStream_t>(stream));
  });
}
