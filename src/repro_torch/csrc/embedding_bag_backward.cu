// Gradient of the multi-hot embedding bag with respect to its table, for
// Hopper (sm_90a):
//   g_table[v, j] = sum over the slots (b, h) with idx[b, h] == v of
//                   g_out[b, j]
// over [n_bags, d] float32 output gradients and [n_bags, hot] int32 ids;
// rows that no valid id touches stay 0 (the wrapper zeroes g_table), ids
// outside [0, V) contribute nothing.
//
// Replaces no TPU kernel: the reference differentiates the jnp.take
// composition of src/repro/models/recsys/embedding.py (XLA's scatter-add),
// not embedding_bag_pallas, so the JAX package has no backward kernel. The
// port needs one because its forward is csrc/embedding_bag.cu on the card,
// and the plain alternative (index_add_) is a float atomic whose order
// changes from launch to launch, which would break the training runner's
// bitwise replay.
//
// Deterministic: the same inputs give the same bits on every launch. The
// wrapper sorts the slots by id, stably (torch.sort; ids outside [0, V)
// are keyed V and sort last), so each id's slots form one run of the
// sorted array, in slot order. Then two passes, each summing in a fixed
// order:
// - bag_grad_pieces: the sorted array is cut into pieces of kPiece slots;
//   one thread per (piece, column) sums each run's part in the piece, in
//   slot order from 0. A run that lies inside the piece is written to its
//   row at once. A part that meets the piece's edge and whose run goes on
//   beyond it goes to the piece's partials: slot 0 for the part that
//   begins the piece (its run began in an earlier piece), slot 1 for the
//   part that ends it.
// - bag_grad_runs: one thread per (piece, column) whose last run starts in
//   the piece and goes on past it sums that run's partials in piece order
//   (its slot 1, then the slot 0 of each later piece that the run reaches)
//   and writes the row once.
// Cutting every run into pieces keeps the skew of recsys ids balanced:
// with recsys_batch_stream's Zipf-like ids, row 0 of each field takes
// about 47 % of the field's slots (≈ 61,000 at B = 65,536), which one
// thread a run would sum alone.
//
// What bounds it on an H100: bytes. It reads the sorted ids and the slot
// order (4 + 8 bytes a slot), gathers a row of g_out for each slot (4 * d
// bytes; the d threads of a piece read one row together), and writes each
// touched row once; the zeroed [V, d] output is the function's largest
// stream. The adds are one a (slot, column). Each thread issues the loads
// of kBatch slots before it adds any of them, so a thread has kBatch
// gathers in flight instead of one.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPiece = 128;   // sorted slots a piece
constexpr int kBatch = 8;     // slots (or partials) whose loads go together
constexpr int kThreads = 256;

__device__ __forceinline__ bool valid_id(int id, int n_vocab) {
  return static_cast<unsigned>(id) < static_cast<unsigned>(n_vocab);
}

// Write the part [seg, end) of the run of `id` in the piece [a, b): to its
// row if the run lies inside the piece, else to the piece's partials.
__device__ __forceinline__ void flush(int id, float acc, long long seg,
                                      long long end, long long a,
                                      long long b, int prev, int next,
                                      long long c, int j, int d,
                                      float* __restrict__ g_table,
                                      float* __restrict__ partial) {
  const bool head = seg == a && prev == id;
  const bool tail = end == b && next == id;
  if (!head && !tail) {
    g_table[static_cast<long long>(id) * d + j] = acc;
  } else {
    partial[(c * 2 + (head ? 0 : 1)) * d + j] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
bag_grad_pieces(const int* __restrict__ sorted_ids,
                const long long* __restrict__ order,
                const float* __restrict__ g_out, float* __restrict__ g_table,
                float* __restrict__ partial, long long n_slots, int hot,
                int d, int n_vocab, long long n_pieces) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long c = t / d;
  const int j = static_cast<int>(t % d);
  if (c >= n_pieces) return;
  const long long a = c * kPiece;
  const long long b = a + kPiece < n_slots ? a + kPiece : n_slots;
  const int prev = a > 0 ? sorted_ids[a - 1] : -1;
  const int next = b < n_slots ? sorted_ids[b] : -1;
  int cur = -1;
  long long seg = a;
  float acc = 0.0f;
  for (long long i0 = a; i0 < b; i0 += kBatch) {
    int id[kBatch];
    long long slot[kBatch];
    float g[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      id[k] = i0 + k < b ? sorted_ids[i0 + k] : n_vocab;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      slot[k] = valid_id(id[k], n_vocab) ? order[i0 + k] : 0;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      g[k] = valid_id(id[k], n_vocab)
                 ? __ldg(g_out + (slot[k] / hot) * d + j)
                 : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const long long i = i0 + k;
      if (i >= b || !valid_id(id[k], n_vocab)) {
        // past the piece, or the ids outside [0, V), which sort last
        if (cur >= 0) {
          flush(cur, acc, seg, i < b ? i : b, a, b, prev, next, c, j, d,
                g_table, partial);
        }
        return;
      }
      if (id[k] != cur) {
        if (cur >= 0) {
          flush(cur, acc, seg, i, a, b, prev, next, c, j, d, g_table,
                partial);
        }
        cur = id[k];
        seg = i;
        acc = 0.0f;
      }
      acc = __fadd_rn(acc, g[k]);
    }
  }
  if (cur >= 0) {
    flush(cur, acc, seg, b, a, b, prev, next, c, j, d, g_table, partial);
  }
}

__global__ void __launch_bounds__(kThreads)
bag_grad_runs(const int* __restrict__ sorted_ids,
              const float* __restrict__ partial, float* __restrict__ g_table,
              long long n_slots, int d, int n_vocab, long long n_pieces) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long c = t / d;
  const int j = static_cast<int>(t % d);
  if (c >= n_pieces) return;
  const long long a = c * kPiece;
  const long long b = a + kPiece;
  if (b >= n_slots) return;  // no run goes on past the last piece
  const int id = sorted_ids[b - 1];
  if (!valid_id(id, n_vocab) || sorted_ids[b] != id) return;
  if (a > 0 && sorted_ids[a - 1] == id && sorted_ids[a] == id) {
    return;  // the run began in an earlier piece, which sums it
  }
  float acc = partial[(c * 2 + 1) * d + j];
  for (long long k0 = c + 1; k0 < n_pieces; k0 += kBatch) {
    int first[kBatch];
    float p[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      first[u] = k0 + u < n_pieces ? sorted_ids[(k0 + u) * kPiece] : -1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      // a piece whose first id is not the run's wrote no slot 0 for it:
      // its value is read but never added
      p[u] = k0 + u < n_pieces ? partial[((k0 + u) * 2) * d + j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (first[u] != id) {
        g_table[static_cast<long long>(id) * d + j] = acc;
        return;
      }
      acc = __fadd_rn(acc, p[u]);
    }
  }
  g_table[static_cast<long long>(id) * d + j] = acc;
}

}  // namespace

extern "C" int repro_embedding_bag_backward_f32(
    const void* sorted_ids, const void* order, const void* g_out,
    void* g_table, void* partial, long long n_slots, int hot, int d,
    int n_vocab, long long n_pieces, void* stream) {
  if (n_slots <= 0 || d <= 0) return 0;
  if (hot <= 0 || n_vocab <= 0 ||
      n_pieces != (n_slots + kPiece - 1) / kPiece) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads = n_pieces * d;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(sorted_ids);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(g_table);
  bag_grad_pieces<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      ids, static_cast<const long long*>(order),
      static_cast<const float*>(g_out), out, part, n_slots, hot, d, n_vocab,
      n_pieces);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bag_grad_runs<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      ids, part, out, n_slots, d, n_vocab, n_pieces);
  return static_cast<int>(cudaGetLastError());
}
