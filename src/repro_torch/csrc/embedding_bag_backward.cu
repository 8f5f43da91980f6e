// Gradient of the multi-hot embedding bag with respect to its table, for
// Hopper (sm_90a):
//   g_table[v, j] = sum over the slots (b, h) with idx[b, h] == v of
//                   g_out[b, j]
// over [n_bags, d] float32 output gradients and [n_bags, hot] int32 ids,
// into a [V, d] float32 g_table of which every row is written exactly once:
// a touched row with its sum, every other row with zeros (the wrapper
// allocates it with torch.empty). Ids outside [0, V) contribute nothing.
//
// Replaces no TPU kernel: the reference differentiates the jnp.take
// composition of src/repro/models/recsys/embedding.py (XLA's scatter-add),
// not embedding_bag_pallas, so the JAX package has no backward kernel. The
// port needs one because its forward is csrc/embedding_bag.cu on the card,
// and the plain alternative (index_add_) is a float atomic whose order
// changes from launch to launch, which would break the training runner's
// bitwise replay.
//
// Input: the batch's plan (csrc/bag_grad_plan.cu), built once a batch and
// shared by DeepFM's two tables: the slots sorted by id, stably (ids
// outside [0, V) keyed V, so they sort last), as int32 ids, and for each
// sorted slot its g_out row (slot / hot) as int32. Each id's slots form
// one run of the sorted array, in slot order.
//
// What bounds it on an H100: bytes. The function must read the ids
// (4 bytes a slot) and g_out (4·d a bag) and write the [V, d] output once;
// at DeepFM's train shape (5.1 M slots, V = 3.7 M, d = 10) the output is
// the largest stream (149 MB). In practice the gathers of g_out rows cost
// most: in the order of the sorted ids they are random, each 40-byte row
// costs two or three 32-byte sectors, and a bag's row is read once for
// each of its slots (g_out, 102 MB, does not fit the 50 MB L2). The adds
// are one a (slot, column), far below the float32 line.
//
// Design, two launches:
// - bag_grad_chunks: the sorted slots are cut into chunks of kChunk = 256,
//   one a warp, and each lane takes 8 consecutive slots: it reads their
//   ids and rows with 16-byte loads, gathers their g_out rows (DT columns
//   in registers: d = 1 is specialised, other widths run in tiles of 8
//   columns; the gathers of 4 rows, or all 8 at d = 1, are issued before
//   any is added) and adds them in slot order, a run at a time. At d = 10
//   (chunk_sums_d10) five lanes share a slot instead, two columns each, so
//   that one load instruction reads six whole rows: a lane reading a
//   40-byte row of its own touches a cache line of its own, and on an H100
//   those line lookups, not the bytes, bounded the pass. A run that begins and ends in the
//   lane's slots is written at once. The lanes' last runs then go through
//   one segmented inclusive scan over the lanes (shuffles, segments from
//   the ballot of the lanes where a run begins), whose value at a run's
//   last lane is the run's sum in the chunk; a lane's first run that began
//   in an earlier lane adds the scan's value of the lane before. So a
//   chunk costs one scan of DT columns, and the adds are one a (slot,
//   column). The part of a run that meets the chunk's edge goes to the
//   chunk's partials: slot 0 for the part that begins the chunk (its run
//   began earlier), slot 1 for the part that ends it. So the Zipf hot rows
//   (about 61,500 slots on each field's row 0 at B = 65,536) are spread
//   over some 240 warps. Where a part is written, its id's bit is set in a
//   bitmap of touched rows (an integer atomicOr; the launcher clears the
//   bitmap, V / 8 bytes, first).
// - bag_grad_finish, warps of two kinds. One a chunk: if the chunk's last
//   run begins in it and goes on past it, the warp sums the run's partials
//   (its slot 1, then the slot 0 of each later chunk the run reaches:
//   lanes over chunks, then a butterfly over the lanes) and writes the
//   row. One a tile of 2^tile_log2 rows (4096 floats, from 32 to 1024
//   rows): the tile's untouched rows are zeroed, with 16-byte stores where
//   four floats are all untouched. So there is no zero fill before the
//   kernel, and gaps between touched rows, which reach 750,000 rows (30 MB
//   at d = 10) in the Zipf tail, are zeroed by many warps, while the long
//   runs' partials are summed.
// The order of every sum depends on the ids and kChunk only, never on
// timing, so every launch gives the same bits; there are no float atomics
// (the bitmap's integer ORs give the same bits in any order).
//
// Wide rows (d >= 32 floats; the rule is repro_torch.kernels.bag_path):
// the GNNs' scatters of edge messages, 75 to 6,272 floats a row. On the
// path above a lane walks 8 slots and 8 columns at a time, so Equiformer-v2's
// chunk of 65,536 slots at d = 6,272 is 256 warps making 784 column passes
// each, and d = 128 runs 16 passes of scalar gathers. These rows take two
// other launches, over the same plan:
// - bag_rows_sums: the sorted slots in blocks of kSeg = 32, one warp a
//   (block, slab) item, lanes over the slab's columns (row_slabs.cuh:
//   16-byte loads where d % 4 == 0 and g_out and the output allow). The
//   warp takes the runs that begin in its block and sums each in slot
//   order from 0 (the gathers of 8 / U slots issued before any is added),
//   then writes the run's row. A run longer than kSeg (a hub: BA stand-ins
//   have runs of thousands of slots) is split at its block edges, points
//   fixed by the ids alone: each block it covers sums its part into the
//   block's partials (slot 1: the part that begins the run, slot 0: a part
//   that goes on from an earlier block), so no warp walks a hub alone. A
//   run is read from the ids around the block (32 behind, 64 ahead, one a
//   lane, then ballots): a run that began earlier and is no hub belongs to
//   the block where it began.
// - bag_rows_finish, warps of two kinds. One a (block, slab): if a hub
//   begins in the block, it sums the hub's partials from 0 in block order
//   and writes the row. One a (tile of rows, slab): the tile's untouched
//   rows are zeroed with streaming stores (the touched-row bitmap as
//   above).
// Every slot is summed by exactly one warp a slab and every row written
// once. The accumulate form (accumulate = 1): out is a running sum, and
// each touched row becomes out[v] + s_v, s_v the same sum as the form that
// writes it, so the bits equal a write followed by an add; an untouched row
// is neither read nor written, and there is no bitmap or zero pass. That
// lets a caller that sums edge chunks (Equiformer-v2) add each chunk into
// its running sum without an [V, d] result a chunk.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "row_slabs.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 256;              // sorted slots a warp
constexpr int kPer = kChunk / kWarp;     // consecutive slots a lane
constexpr int kWarps = 4;                // warps a block
constexpr int kMaxTileRows = 1024;

struct Args {
  const int* ids;       // [n_slots] sorted keys: ids in [0, V), then V
  const int* rows;      // [n_slots] the g_out row of each sorted slot
  const float* g_out;   // [n_bags, d]
  float* g_table;       // [V, d]
  float* partial;       // [n_chunks, 2, d]
  unsigned* touched;    // [ceil(V / 32)] a bit a row
  long long n_slots, n_chunks;
  int d, n_vocab, tile_log2, n_tiles;
};

// The lane's kPer sorted slots from s0: ids (V past the last slot) and
// rows; two 16-byte loads of each where the slots are whole and aligned.
__device__ __forceinline__ void lane_slots(const Args& a, long long s0,
                                           int (&id)[kPer], int (&row)[kPer]) {
  const int* ip = a.ids + s0;
  const int* rp = a.rows + s0;
  if (s0 + kPer <= a.n_slots &&
      ((reinterpret_cast<uintptr_t>(ip) | reinterpret_cast<uintptr_t>(rp)) &
       15) == 0) {
#pragma unroll
    for (int h = 0; h < kPer / 4; ++h) {
      const int4 i4 = __ldg(reinterpret_cast<const int4*>(ip) + h);
      const int4 r4 = __ldg(reinterpret_cast<const int4*>(rp) + h);
      id[4 * h] = i4.x;
      id[4 * h + 1] = i4.y;
      id[4 * h + 2] = i4.z;
      id[4 * h + 3] = i4.w;
      row[4 * h] = r4.x;
      row[4 * h + 1] = r4.y;
      row[4 * h + 2] = r4.z;
      row[4 * h + 3] = r4.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool in = s0 + j < a.n_slots;
      id[j] = in ? __ldg(ip + j) : a.n_vocab;
      row[j] = in ? __ldg(rp + j) : 0;
    }
  }
}

// Columns [c0, c0 + DT) of g_out's row `row` (0 where !ok or past d).
template <int DT, bool EXACT>
__device__ __forceinline__ void load_row(const Args& a, int row, int c0,
                                         bool ok, float (&v)[DT]) {
  const float* p = a.g_out + static_cast<long long>(row) * a.d + c0;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    v[j] = ok && (EXACT || c0 + j < a.d) ? __ldg(p + j) : 0.0f;
  }
}

// The sum v (columns [c0, c0 + DT)) of the part of run `id` in chunk c
// that ends at this lane: to the run's row, or, where the part meets the
// chunk's edge, to the chunk's partials (slot 0: the part begins the chunk
// and its run began earlier; slot 1: the part ends the chunk and its run
// goes on). Marks the row touched.
template <int DT, bool EXACT>
__device__ __forceinline__ void write_part(const Args& a, long long c, int c0,
                                           int id, bool head, bool tail,
                                           const float (&v)[DT]) {
  float* dst = !head && !tail
                   ? a.g_table + static_cast<long long>(id) * a.d + c0
                   : a.partial + (c * 2 + (head ? 0 : 1)) * a.d + c0;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    if (EXACT || c0 + j < a.d) dst[j] = v[j];
  }
  if (c0 == 0) atomicOr(a.touched + (id >> 5), 1u << (id & 31));
}

// The sums of chunk c (one warp, a lane 8 slots).
template <int DT, bool EXACT>
__device__ void chunk_sums(const Args& a, long long c, int lane) {
  constexpr int G = DT == 1 ? kPer : 4;   // rows whose gathers go together
  const int V = a.n_vocab;
  const long long c_first = c * kChunk;
  const long long c_end =
      c_first + kChunk < a.n_slots ? c_first + kChunk : a.n_slots;
  int id[kPer], row[kPer];
  lane_slots(a, c_first + kPer * lane, id, row);
  const int prev = c_first > 0 ? a.ids[c_first - 1] : -1;
  const int next = c_end < a.n_slots ? a.ids[c_end] : -1;
  const int first = __shfl_sync(kFull, id[0], 0);
  // my head run (id h) and tail run (id t); whole: one run in my slots
  const int h = id[0], t = id[kPer - 1];
  const int up_t = __shfl_up_sync(kFull, t, 1);
  const int down_h = __shfl_down_sync(kFull, h, 1);
  const int before = lane == 0 ? prev : up_t;
  const int after = lane == kWarp - 1 ? next : down_h;
  const bool whole = h == t;
  const bool cont = h == before;
  // the scan's segments: a lane starts one unless it is a whole lane
  // that continues the run before it
  const unsigned heads = __ballot_sync(kFull, lane == 0 || !(whole && cont));
  const unsigned upto = lane == kWarp - 1 ? kFull : (2u << lane) - 1u;
  const int lo = 31 - __clz(heads & upto);
  const bool h_valid = static_cast<unsigned>(h) < static_cast<unsigned>(V);
  const bool t_valid = static_cast<unsigned>(t) < static_cast<unsigned>(V);

  for (int c0 = 0; c0 < a.d; c0 += DT) {
    float head[DT], acc[DT];
#pragma unroll
    for (int j = 0; j < DT; ++j) head[j] = acc[j] = 0.0f;
    // my slots in order: the head run's part, whole runs (written at
    // once: they lie inside the chunk), the tail run's part in acc
    int cur = h;
    bool broke = false;
#pragma unroll
    for (int j0 = 0; j0 < kPer; j0 += G) {
      float v[G][DT];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const bool ok = static_cast<unsigned>(id[j0 + g]) <
                        static_cast<unsigned>(V);
        load_row<DT, EXACT>(a, ok ? row[j0 + g] : 0, c0, ok, v[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (id[j0 + g] != cur) {
          if (!broke) {
#pragma unroll
            for (int j = 0; j < DT; ++j) head[j] = acc[j];
            broke = true;
          } else if (static_cast<unsigned>(cur) < static_cast<unsigned>(V)) {
            write_part<DT, EXACT>(a, c, c0, cur, false, false, acc);
          }
          cur = id[j0 + g];
#pragma unroll
          for (int j = 0; j < DT; ++j) acc[j] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < DT; ++j) acc[j] = __fadd_rn(acc[j], v[g][j]);
      }
    }
    // segmented inclusive scan of the tail parts over the lanes: acc is
    // then the sum of my tail run's parts from the lane where it began
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const float x = __shfl_up_sync(kFull, acc[j], off);
        if (lane - off >= lo) acc[j] = __fadd_rn(x, acc[j]);
      }
    }
    float up[DT];
#pragma unroll
    for (int j = 0; j < DT; ++j) up[j] = __shfl_up_sync(kFull, acc[j], 1);
    if (!whole && h_valid) {   // my head run ends in my slots
      if (cont && lane > 0) {
#pragma unroll
        for (int j = 0; j < DT; ++j) head[j] = __fadd_rn(up[j], head[j]);
      }
      write_part<DT, EXACT>(a, c, c0, h, h == first && prev == h,
                                 false, head);
    }
    if (t_valid && (after != t || lane == kWarp - 1)) {   // my tail run
      write_part<DT, EXACT>(a, c, c0, t, t == first && prev == t,
                                 lane == kWarp - 1 && next == t, acc);
    }
  }
}

// Zero the untouched rows of tile t (one warp): its bitmap words staged in
// `words`, then 16-byte stores where four floats are all untouched.
template <int DT, bool EXACT>
__device__ void zero_tile(const Args& a, long long t, unsigned* words,
                          int lane) {
  const int d = EXACT ? DT : a.d;
  const long long r0 = t << a.tile_log2;
  const int rows = static_cast<int>(
      (1ll << a.tile_log2) < a.n_vocab - r0 ? (1ll << a.tile_log2)
                                            : a.n_vocab - r0);
  if (lane < (rows + 31) / 32) words[lane] = a.touched[(r0 >> 5) + lane];
  __syncwarp();
  float* base = a.g_table + r0 * d;
  const int n = rows * d;
  const int n4 = n / 4;
  for (int m = lane; m < n4; m += kWarp) {
    unsigned hit = 0;   // bit e: float 4m + e lies in a touched row
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (4 * m + e) / d;
      hit |= ((words[r >> 5] >> (r & 31)) & 1u) << e;
    }
    if (hit == 0) {
      reinterpret_cast<float4*>(base)[m] = make_float4(0.0f, 0.0f, 0.0f,
                                                       0.0f);
    } else if (hit != 15) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!((hit >> e) & 1u)) base[4 * m + e] = 0.0f;
      }
    }
  }
  for (int f = 4 * n4 + lane; f < n; f += kWarp) {
    const int r = f / d;
    if (!((words[r >> 5] >> (r & 31)) & 1u)) base[f] = 0.0f;
  }
}

// Copy the chunk's n (<= kChunk) ints from src into the warp's shared
// dst, `fill` past n: 16-byte loads for a whole aligned chunk.
__device__ __forceinline__ void stage(int* dst, const int* src, int n,
                                      int fill, int lane) {
  if (n == kChunk && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll
    for (int k = lane; k < kChunk / 4; k += kWarp) {
      reinterpret_cast<int4*>(dst)[k] =
          __ldg(reinterpret_cast<const int4*>(src) + k);
    }
  } else {
    for (int k = lane; k < kChunk; k += kWarp) {
      dst[k] = k < n ? __ldg(src + k) : fill;
    }
  }
}

// The sums of chunk c at d = 10 (one warp; ALIGNED: g_out 8-byte aligned,
// read with 8-byte loads, else with 4-byte ones in the same order).
// The lanes go in 6 groups of kGW = 5 (lanes 30 and 31 idle), each lane
// two columns: a group reads a slot's 40-byte row with one 8-byte load a
// lane, so a load instruction reads 6 rows (each lane reading a whole row
// of its own touches up to 32 cache lines an instruction: on an H100 that
// bounded chunk_sums at d = 10). Group g takes the chunk's slots [256·g/6,
// 256·(g+1)/6) from shared memory and walks them as a lane of chunk_sums
// walks its 8; the groups' last runs then go through one segmented scan
// over the groups.
constexpr int kGW = 5;
constexpr int kGroups = kWarp / kGW;

__device__ __forceinline__ void write_pair(const Args& a, long long c,
                                           int id, bool head, bool tail,
                                           int k, float2 v) {
  float* dst = !head && !tail ? a.g_table + static_cast<long long>(id) * 10
                              : a.partial + (c * 2 + (head ? 0 : 1)) * 10;
  reinterpret_cast<float2*>(dst)[k] = v;
  if (k == 0) atomicOr(a.touched + (id >> 5), 1u << (id & 31));
}

template <bool ALIGNED>
__device__ void chunk_sums_d10(const Args& a, long long c, int lane,
                               int* sid, int* srow) {
  constexpr int B = 8;   // slots whose gathers go together
  const int V = a.n_vocab;
  const long long c_first = c * kChunk;
  const int len = static_cast<int>(
      a.n_slots - c_first < kChunk ? a.n_slots - c_first : kChunk);
  stage(sid, a.ids + c_first, len, V, lane);
  stage(srow, a.rows + c_first, len, 0, lane);
  __syncwarp();
  const int prev = c_first > 0 ? a.ids[c_first - 1] : -1;
  const int next = c_first + len < a.n_slots ? a.ids[c_first + len] : -1;
  const int first = sid[0];
  const int g = lane / kGW, k = lane % kGW;
  const bool active = g < kGroups;
  const bool last_g = g == kGroups - 1;
  const int s_lo = active ? g * kChunk / kGroups : kChunk;
  const int s_hi = active ? (g + 1) * kChunk / kGroups : kChunk;
  const int h = active ? sid[s_lo] : V, t = active ? sid[s_hi - 1] : V;
  const int up_t = __shfl_up_sync(kFull, t, kGW);
  const int down_h = __shfl_down_sync(kFull, h, kGW);
  const int before = g == 0 ? prev : up_t;
  const int after = last_g ? next : down_h;
  const bool whole = h == t;
  const bool cont = h == before;
  // the groups' scan segments, by the bit of each group's lane 0
  const unsigned heads = __ballot_sync(
      kFull, active && k == 0 && (g == 0 || !(whole && cont)));
  const unsigned upto = lane == kWarp - 1 ? kFull : (2u << lane) - 1u;
  const int lo = (31 - __clz((heads & upto) | 1u)) / kGW;

  float2 head = make_float2(0.0f, 0.0f), acc = head;
  int cur = h;
  bool broke = false;
  for (int s0 = s_lo; s0 < s_hi; s0 += B) {
    int id[B];
    float2 v[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int s = s0 + b < s_hi ? s0 + b : s_hi - 1;
      id[b] = sid[s];
      const bool ok = s0 + b < s_hi &&
                      static_cast<unsigned>(id[b]) < static_cast<unsigned>(V);
      const float* p = a.g_out + static_cast<long long>(srow[s]) * 10 + 2 * k;
      if constexpr (ALIGNED) {
        v[b] = ok ? __ldg(reinterpret_cast<const float2*>(p))
                  : make_float2(0.0f, 0.0f);
      } else {
        v[b] = ok ? make_float2(__ldg(p), __ldg(p + 1))
                  : make_float2(0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (s0 + b >= s_hi) break;
      if (id[b] != cur) {
        if (!broke) {
          head = acc;
          broke = true;
        } else if (static_cast<unsigned>(cur) < static_cast<unsigned>(V)) {
          write_pair(a, c, cur, false, false, k, acc);
        }
        cur = id[b];
        acc = make_float2(0.0f, 0.0f);
      }
      acc.x = __fadd_rn(acc.x, v[b].x);
      acc.y = __fadd_rn(acc.y, v[b].y);
    }
  }
#pragma unroll
  for (int off = 1; off < kGroups; off <<= 1) {
    const float x = __shfl_up_sync(kFull, acc.x, off * kGW);
    const float y = __shfl_up_sync(kFull, acc.y, off * kGW);
    if (g - off >= lo) {
      acc.x = __fadd_rn(x, acc.x);
      acc.y = __fadd_rn(y, acc.y);
    }
  }
  const float ux = __shfl_up_sync(kFull, acc.x, kGW);
  const float uy = __shfl_up_sync(kFull, acc.y, kGW);
  if (!active) return;
  if (!whole && static_cast<unsigned>(h) < static_cast<unsigned>(V)) {
    if (cont && g > 0) {
      head.x = __fadd_rn(ux, head.x);
      head.y = __fadd_rn(uy, head.y);
    }
    write_pair(a, c, h, h == first && prev == h, false, k, head);
  }
  if (static_cast<unsigned>(t) < static_cast<unsigned>(V) &&
      (after != t || last_g)) {
    write_pair(a, c, t, t == first && prev == t, last_g && next == t, k,
               acc);
  }
}

// d = 10 (ALIGNED or not) by chunk_sums_d10, other widths by chunk_sums.
template <int DT, bool EXACT, bool ALIGNED>
__global__ void __launch_bounds__(kWarps * kWarp)
bag_grad_chunks(const Args a) {
  constexpr bool kD10 = EXACT && DT == 10;
  __shared__ __align__(16) int s_ids[kWarps][kD10 ? kChunk : 1];
  __shared__ __align__(16) int s_rows[kWarps][kD10 ? kChunk : 1];
  const int w = threadIdx.x / kWarp;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps + w;
  if (c >= a.n_chunks) return;
  if constexpr (kD10) {
    chunk_sums_d10<ALIGNED>(a, c, threadIdx.x % kWarp, s_ids[w], s_rows[w]);
  } else {
    chunk_sums<DT, EXACT>(a, c, threadIdx.x % kWarp);
  }
}

// The run that begins in chunk c and goes on past it: its partials in
// chunk order (slot 1 of c, then slot 0 of each chunk the run reaches),
// written to its row (one warp). The partials of a round of 32 chunks
// are loaded with their first ids, then masked.
template <int DT, bool EXACT>
__device__ void finish_run(const Args& a, long long c, int lane) {
  if (c + 1 >= a.n_chunks) return;
  const long long c_first = c * kChunk, c_end = c_first + kChunk;
  const int id = a.ids[c_end - 1];
  if (static_cast<unsigned>(id) >= static_cast<unsigned>(a.n_vocab) ||
      a.ids[c_end] != id) {
    return;
  }
  if (c > 0 && a.ids[c_first] == id && a.ids[c_first - 1] == id) return;
  const int d = a.d;
  for (int c0 = 0; c0 < d; c0 += DT) {
    float acc[DT];
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[j] = 0.0f;
    for (long long k0 = c + 1;; k0 += kWarp) {
      const long long k = k0 + lane < a.n_chunks ? k0 + lane : c;
      const float* p = a.partial + k * 2 * d + c0;
      float v[DT];
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        v[j] = EXACT || c0 + j < d ? p[j] : 0.0f;
      }
      const bool in = k != c && a.ids[k * kChunk] == id;
      if (in) {
#pragma unroll
        for (int j = 0; j < DT; ++j) acc[j] = __fadd_rn(acc[j], v[j]);
      }
      if (__ballot_sync(kFull, in) != kFull) break;
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[j] = __fadd_rn(acc[j], __shfl_xor_sync(kFull, acc[j], off));
      }
    }
    if (lane == 0) {
      const float* t = a.partial + (c * 2 + 1) * d + c0;
      float* dst = a.g_table + static_cast<long long>(id) * d + c0;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        if (EXACT || c0 + j < d) dst[j] = __fadd_rn(t[j], acc[j]);
      }
    }
  }
}

// Warps [0, run_warps): one a chunk (finish_run); then one a tile of rows
// (zero_tile).
template <int DT, bool EXACT>
__global__ void __launch_bounds__(kWarps * kWarp)
bag_grad_finish(const Args a, long long run_warps) {
  __shared__ unsigned s_words[kWarps][kWarp];
  const int lane = threadIdx.x % kWarp;
  const int wb = threadIdx.x / kWarp;
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + wb;
  if (w < run_warps) {
    finish_run<DT, EXACT>(a, w, lane);
  } else if (w - run_warps < a.n_tiles) {
    zero_tile<DT, EXACT>(a, w - run_warps, s_words[wb], lane);
  }
}

template <int DT, bool EXACT, bool ALIGNED>
int launch(const Args& a, cudaStream_t s) {
  const long long run_blocks = (a.n_chunks + kWarps - 1) / kWarps;
  const long long tile_blocks = (a.n_tiles + kWarps - 1LL) / kWarps;
  if (run_blocks + tile_blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bag_grad_chunks<DT, EXACT, ALIGNED>
      <<<static_cast<unsigned>(run_blocks), kWarps * kWarp, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bag_grad_finish<DT, EXACT>
      <<<static_cast<unsigned>(run_blocks + tile_blocks), kWarps * kWarp, 0,
         s>>>(a, run_blocks * kWarps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the wide-row path
// ---------------------------------------------------------------------------

constexpr int kSeg = 32;        // slots a block; a run longer is a hub
constexpr int kRowWarps = 4;    // warps a thread block
constexpr int kMaxRowTileLog2 = 6;
static_assert(kSeg == kWarp, "a block's ids are read one a lane");

struct RowArgs {
  const int* ids;       // [n_slots] sorted keys: ids in [0, V), then V
  const int* rows;      // [n_slots] the g_out row of each sorted slot
  const float* g_out;   // [n_bags, d]
  float* out;           // [V, d]
  float* partial;       // [n_blocks, 2, d]
  unsigned* touched;    // [ceil(V / 32)] a bit a row (not accumulate)
  long long n_slots, n_blocks, n_slabs, n_tiles;
  int d, n_vocab, tile_log2;
};

// Slots summed together: the gathers of kBatch slots' U vectors are
// issued before any of them is added.
template <int U>
__host__ __device__ constexpr int row_batch() {
  return U == 1 ? 8 : U == 2 ? 4 : 2;
}

// acc = Σ (from 0, in slot order) of the g_out rows of the slots at
// offsets [q0, q1) from the block's first slot (q1 <= 64), in this lane's
// columns of the slab (c0: its first). row_x and row_y hold, one a lane,
// the rows of offsets [0, 32) and [32, 64).
template <int VEC, int U>
__device__ __forceinline__ void walk(const RowArgs& a, int row_x, int row_y,
                                     int q0, int q1, int c0,
                                     float (&acc)[U][VEC]) {
  constexpr int B = row_batch<U>();
#pragma unroll
  for (int u = 0; u < U; ++u) slabs::zero<VEC>(acc[u]);
  for (int q = q0; q < q1; q += B) {
    float v[B][U][VEC];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const int qk = q + k;
      const int rx = __shfl_sync(kFull, row_x, qk & (kWarp - 1));
      const int ry = __shfl_sync(kFull, row_y, qk & (kWarp - 1));
      const float* p =
          a.g_out + static_cast<long long>(qk < kWarp ? rx : ry) * a.d;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c0 + u * kWarp * VEC;
        if (qk < q1 && c < a.d) {
          slabs::load_ro<VEC>(p + c, v[k][u]);
        } else {
          slabs::zero<VEC>(v[k][u]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < B; ++k) {
      if (q + k < q1) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            acc[u][e] = __fadd_rn(acc[u][e], v[k][u][e]);
          }
        }
      }
    }
  }
}

// Row `id` of the output: acc (or, in the accumulate form, out + acc).
template <int VEC, int U, bool ACC>
__device__ __forceinline__ void put_row(const RowArgs& a, int id, int c0,
                                        const float (&acc)[U][VEC]) {
  float* dst = a.out + static_cast<long long>(id) * a.d;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = c0 + u * kWarp * VEC;
    if (c >= a.d) continue;
    if constexpr (ACC) {
      float old[VEC], sum[VEC];
      slabs::load<VEC>(dst + c, old);
#pragma unroll
      for (int e = 0; e < VEC; ++e) sum[e] = __fadd_rn(old[e], acc[u][e]);
      slabs::store<VEC>(dst + c, sum);
    } else {
      slabs::store<VEC>(dst + c, acc[u]);
    }
  }
}

template <int VEC, int U>
__device__ __forceinline__ void put_partial(const RowArgs& a, long long slot,
                                            int c0,
                                            const float (&acc)[U][VEC]) {
  float* dst = a.partial + slot * a.d;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = c0 + u * kWarp * VEC;
    if (c < a.d) slabs::store<VEC>(dst + c, acc[u]);
  }
}

// The runs that begin in block b, in this warp's slab (see the header).
template <int VEC, int U, bool ACC>
__global__ void __launch_bounds__(kRowWarps * kWarp)
bag_rows_sums(const RowArgs a) {
  const long long w =
      static_cast<long long>(blockIdx.x) * kRowWarps + threadIdx.x / kWarp;
  if (w >= a.n_blocks * a.n_slabs) return;
  const int lane = threadIdx.x % kWarp;
  const long long b = w / a.n_slabs;
  const int slab = static_cast<int>(w - b * a.n_slabs);
  const int c0 = slab * kWarp * U * VEC + lane * VEC;
  const int V = a.n_vocab;
  const long long s0 = b * kSeg;
  // the ids of offsets [-32, 0), [0, 32) and [32, 64) from s0, one a lane:
  // -1 before the first slot, V past the last (both no valid id)
  const long long sa = s0 - kWarp + lane, sx = s0 + lane,
                  sy = s0 + kWarp + lane;
  const int id_a = sa >= 0 ? __ldg(a.ids + sa) : -1;
  const int id_x = sx < a.n_slots ? __ldg(a.ids + sx) : V;
  const int id_y = sy < a.n_slots ? __ldg(a.ids + sy) : V;
  const int row_x = sx < a.n_slots ? __ldg(a.rows + sx) : 0;
  const int row_y = sy < a.n_slots ? __ldg(a.rows + sy) : 0;
  const bool mark = !ACC && slab == 0 && lane == 0;
  float acc[U][VEC];
  int p = 0;   // the offset of the next run to take
  const int first = __shfl_sync(kFull, id_x, 0);
  if (static_cast<unsigned>(first) >= static_cast<unsigned>(V)) return;
  if (__shfl_sync(kFull, id_a, kWarp - 1) == first) {
    // the run of the block's first slot began earlier: its slots behind
    // (up to 32) and ahead (up to 64) say whether it is a hub
    const int back = __popc(__ballot_sync(kFull, id_a == first));
    const int fwd = __popc(__ballot_sync(kFull, id_x == first)) +
                    __popc(__ballot_sync(kFull, id_y == first));
    p = fwd < kSeg ? fwd : kSeg;
    if (back + fwd > kSeg) {     // a hub: this block's part, partial 0
      walk<VEC, U>(a, row_x, row_y, 0, p, c0, acc);
      put_partial<VEC, U>(a, 2 * b, c0, acc);
    }
  }
  while (p < kSeg) {
    const int id = __shfl_sync(kFull, id_x, p);
    if (static_cast<unsigned>(id) >= static_cast<unsigned>(V)) break;
    // the run's slots in offsets [p, 64): all of it, or more than kSeg
    const int len = __popc(__ballot_sync(kFull, id_x == id)) +
                    __popc(__ballot_sync(kFull, id_y == id));
    if (mark) atomicOr(a.touched + (id >> 5), 1u << (id & 31));
    if (len > kSeg) {            // a hub begins here: partial 1
      walk<VEC, U>(a, row_x, row_y, p, kSeg, c0, acc);
      put_partial<VEC, U>(a, 2 * b + 1, c0, acc);
      break;
    }
    walk<VEC, U>(a, row_x, row_y, p, p + len, c0, acc);
    put_row<VEC, U, ACC>(a, id, c0, acc);
    p += len;
  }
}

// Warps [0, n_blocks · n_slabs): a hub that begins in the block, its
// partials summed from 0 in block order (the continuing blocks found 32 at
// a time, one a lane; the loads of kBatch partials issued before any is
// added). Then, unless ACC, one warp a (tile of 2^tile_log2 rows, slab):
// its untouched rows zeroed.
template <int VEC, int U, bool ACC>
__global__ void __launch_bounds__(kRowWarps * kWarp)
bag_rows_finish(const RowArgs a) {
  constexpr int B = row_batch<U>();
  const long long w =
      static_cast<long long>(blockIdx.x) * kRowWarps + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long n_fin = a.n_blocks * a.n_slabs;
  const int V = a.n_vocab;
  if (w < n_fin) {
    const long long b = w / a.n_slabs;
    const int slab = static_cast<int>(w - b * a.n_slabs);
    const int c0 = slab * kWarp * U * VEC + lane * VEC;
    const long long s = b * kSeg + lane;
    const int id = s < a.n_slots ? __ldg(a.ids + s) : V;
    const int prev = s > 0 && s < a.n_slots ? __ldg(a.ids + s - 1) : -1;
    const int ahead = s + kSeg < a.n_slots ? __ldg(a.ids + s + kSeg) : V;
    const unsigned hubs = __ballot_sync(
        kFull, static_cast<unsigned>(id) < static_cast<unsigned>(V) &&
                   prev != id && ahead == id);
    if (hubs == 0) return;       // at most one: a hub is longer than kSeg
    const int hub = __shfl_sync(kFull, id, __ffs(hubs) - 1);
    float acc[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) slabs::zero<VEC>(acc[u]);
    // partial 1 of block b, then partial 0 of each block the hub goes on in
    for (long long b1 = b;; b1 += kWarp) {
      const long long bl = b1 + 1 + lane;
      const int n_more = __popc(__ballot_sync(
          kFull, bl < a.n_blocks && __ldg(a.ids + bl * kSeg) == hub));
      const int n = (b1 == b) + n_more;
      for (int k0 = 0; k0 < n; k0 += B) {
        float v[B][U][VEC];
#pragma unroll
        for (int k = 0; k < B; ++k) {
          const int j = k0 + k;  // j-th partial of this round
          const long long slot =
              b1 == b ? (j == 0 ? 2 * b + 1 : 2 * (b + j))
                      : 2 * (b1 + 1 + j);
          const float* p = a.partial + slot * a.d;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int c = c0 + u * kWarp * VEC;
            if (j < n && c < a.d) {
              slabs::load_ro<VEC>(p + c, v[k][u]);
            } else {
              slabs::zero<VEC>(v[k][u]);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < B; ++k) {
          if (k0 + k < n) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) {
                acc[u][e] = __fadd_rn(acc[u][e], v[k][u][e]);
              }
            }
          }
        }
      }
      if (n_more < kWarp) break;
    }
    put_row<VEC, U, ACC>(a, hub, c0, acc);
    return;
  }
  if constexpr (!ACC) {
    const long long z = w - n_fin;
    if (z >= a.n_tiles * a.n_slabs) return;
    const long long t = z / a.n_slabs;
    const int slab = static_cast<int>(z - t * a.n_slabs);
    const int c0 = slab * kWarp * U * VEC + lane * VEC;
    const long long r0 = t << a.tile_log2;
    const long long r1 = r0 + (1ll << a.tile_log2) < V
                             ? r0 + (1ll << a.tile_log2) : V;
    float zeros[VEC];
    slabs::zero<VEC>(zeros);
    for (long long r = r0; r < r1; ++r) {
      if ((__ldg(a.touched + (r >> 5)) >> (r & 31)) & 1u) continue;
      float* dst = a.out + r * a.d;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c0 + u * kWarp * VEC;
        if (c < a.d) slabs::store_stream<VEC>(dst + c, zeros);
      }
    }
  }
}

template <int VEC, int U, bool ACC>
int launch_rows(const RowArgs& a, cudaStream_t s) {
  const long long fin_warps = a.n_blocks * a.n_slabs;
  const long long zero_warps = ACC ? 0 : a.n_tiles * a.n_slabs;
  const long long sum_blocks = (fin_warps + kRowWarps - 1) / kRowWarps;
  const long long fin_blocks =
      (fin_warps + zero_warps + kRowWarps - 1) / kRowWarps;
  if (fin_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  bag_rows_sums<VEC, U, ACC>
      <<<static_cast<unsigned>(sum_blocks), kRowWarps * kWarp, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bag_rows_finish<VEC, U, ACC>
      <<<static_cast<unsigned>(fin_blocks), kRowWarps * kWarp, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC, bool ACC>
int launch_rows_u(const RowArgs& a, cudaStream_t s) {
  switch (slabs::loads_per_lane(a.d / VEC)) {
    case 1:
      return launch_rows<VEC, 1, ACC>(a, s);
    case 2:
      return launch_rows<VEC, 2, ACC>(a, s);
    case 3:
      return launch_rows<VEC, 3, ACC>(a, s);
    default:
      return launch_rows<VEC, 4, ACC>(a, s);
  }
}

}  // namespace

// The wide-row path (any d >= 1 works; the wrapper sends d >= 32 here, and
// every accumulate call). scratch: the blocks' partials (n_blocks * 2 * d
// floats, n_blocks = ceil(n_slots / seg)), then at the next 16-byte
// boundary the bitmap of touched rows (ceil(V / 32) words; unused by the
// accumulate form); the wrapper computes its size with the same rule
// (kernels.embedding_bag.ops.bag_wide_layout). Zero tiles of 2^tile_log2
// rows (0..6). out must be 4-byte aligned; 16-byte alignment (with g_out's
// and d % 4 == 0) allows the 16-byte loads.
extern "C" int repro_embedding_bag_backward_rows_f32(
    const void* sorted_ids, const void* rows, const void* g_out, void* out,
    void* scratch, long long scratch_bytes, long long n_slots, int d,
    int n_vocab, int seg, int tile_log2, int accumulate, void* stream) {
  if (n_slots <= 0 || d <= 0) return 0;
  if (seg != kSeg || n_vocab <= 0 || tile_log2 < 0 ||
      tile_log2 > kMaxRowTileLog2 ||
      (reinterpret_cast<uintptr_t>(out) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_blocks = (n_slots + kSeg - 1) / kSeg;
  const long long n_words = (static_cast<long long>(n_vocab) + 31) / 32;
  const long long words_at = (n_blocks * 2 * d * 4 + 15) / 16 * 16;
  if (scratch_bytes < words_at + 4 * n_words) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec4 = d % 4 == 0 &&
                    ((reinterpret_cast<uintptr_t>(g_out) |
                      reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int n_vec = vec4 ? d / 4 : d;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  RowArgs a{static_cast<const int*>(sorted_ids), static_cast<const int*>(rows),
            static_cast<const float*>(g_out), static_cast<float*>(out),
            reinterpret_cast<float*>(base),
            reinterpret_cast<unsigned*>(base + words_at), n_slots, n_blocks,
            slabs::n_slabs(n_vec, slabs::loads_per_lane(n_vec)),
            (static_cast<long long>(n_vocab) + (1ll << tile_log2) - 1) >>
                tile_log2,
            d, n_vocab, tile_log2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (accumulate) {
    return vec4 ? launch_rows_u<4, true>(a, s) : launch_rows_u<1, true>(a, s);
  }
  const cudaError_t e = cudaMemsetAsync(a.touched, 0, 4 * n_words, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return vec4 ? launch_rows_u<4, false>(a, s) : launch_rows_u<1, false>(a, s);
}

// scratch: the chunks' partials (n_chunks * 2 * d floats), then at the
// next 16-byte boundary the bitmap of touched rows (ceil(V / 32) words);
// the wrapper computes its size with the same rule
// (kernels.embedding_bag.ops.bag_grad_layout). g_table must be 16-byte
// aligned.
extern "C" int repro_embedding_bag_backward_f32(
    const void* sorted_ids, const void* rows, const void* g_out,
    void* g_table, void* scratch, long long scratch_bytes, long long n_slots,
    int d, int n_vocab, int chunk, int tile_log2, void* stream) {
  if (n_slots <= 0 || d <= 0) return 0;
  if (chunk != kChunk || n_vocab <= 0 || tile_log2 < 5 ||
      (1 << tile_log2) > kMaxTileRows ||
      (reinterpret_cast<uintptr_t>(g_table) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0 ||
      static_cast<long long>(kMaxTileRows) * d > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_chunks = (n_slots + kChunk - 1) / kChunk;
  const long long n_tiles =
      (static_cast<long long>(n_vocab) + (1ll << tile_log2) - 1) >> tile_log2;
  const long long n_words = (static_cast<long long>(n_vocab) + 31) / 32;
  const long long words_at = (n_chunks * 2 * d * 4 + 15) / 16 * 16;
  if (scratch_bytes < words_at + 4 * n_words) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned char* base = static_cast<unsigned char*>(scratch);
  Args a{static_cast<const int*>(sorted_ids), static_cast<const int*>(rows),
         static_cast<const float*>(g_out), static_cast<float*>(g_table),
         reinterpret_cast<float*>(base),
         reinterpret_cast<unsigned*>(base + words_at), n_slots, n_chunks, d,
         n_vocab, tile_log2, static_cast<int>(n_tiles)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(a.touched, 0, 4 * n_words, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (d == 1) return launch<1, true, false>(a, s);
  if (d == 10) {
    return (reinterpret_cast<uintptr_t>(g_out) & 7) == 0
               ? launch<10, true, true>(a, s)
               : launch<10, true, false>(a, s);
  }
  return launch<8, false, false>(a, s);
}
