// Fused sparse-gradient scatter + L2 decay + Adam update (ops/fused_adam.py),
// hand-written for Hopper, and its variant that also gathers the next
// batch's rows out of the updated table.
//
// Replaces: anime_recommendations_tpu/ops/fused_adam.py::_fused_adam_kernel
// with its stochastic rounding _sr_store (bf16 moments) -> fused_adam (its
// has_dense branch -> fused_adam with a dense gradient), and
// ::_fused_adam_gather_kernel -> fused_adam_gather.
//
// What it computes, for a table W [n, d] f32 and moments mu, nu [n, d] (f32,
// or bf16 when they are stored in half the bytes), given the batch's row ids
// sorted ascending (int32 [B]) and their gradients in the same order (f32
// [B, d]):
//   dscat  = sum of the gradient rows whose id == r    (exact f32, see below)
//   dscat  = dscat + dense[r]          (only with a dense gradient [n, d])
//   g      = dscat + 2*l2*W
//   mu'    = b1*mu + (1-b1)*g ;  nu' = b2*nu + (1-b2)*g*g   (f32 math)
//   W'     = W - lr*(mu'/bc1)/(sqrt(nu'/bc2) + eps)       (in place)
//   sumsq  = sum of W^2 before the update, one partial per block
// fused_adam_gather also writes rows_out[p] = W'[next_id] for every next-
// batch id, at the id's own position p (rows of ids outside [0, n) are 0).
// Every operation is an explicitly rounded f32 intrinsic, in the order the
// plain torch version (_sparse_adam_update_plain) applies its tensor ops, so
// the two agree bit for bit wherever their dscat sums agree.
//
// The order of dscat: the sorted positions are cut into tiles of kTile. A
// row whose run of equal ids lies in one tile sums it from 0 in position
// order (as index_add_ over sorted ids on one thread does: rows hit at most
// once are bit-equal to the plain version). A run crossing tile edges is
// summed per tile, each segment from 0 in position order, and the segment
// sums are added from 0 in tile order; past kLongParts tiles in at most
// kChain chunks of consecutive tiles, each chunk from 0, then the chunk sums
// from 0 (ops/fused_adam.run_sums_in_tile_order writes the same order in
// torch ops). Either way dscat is a fixed function of the sorted ids: the
// same bits run to run.
//
// bf16 moments: with stochastic rounding (sr != 0) the f32 value's bits get
// 16 random low bits added and are truncated, as _sr_store does:
//   bits = (f32_bits + (rand & 0xFFFF)) & 0xFFFF0000
// The TPU's in-kernel PRNG cannot be reproduced here, so rand is a stateless
// hash of (step, moment, row, column), mix32 below, written identically in
// the plain version. Without sr a bf16 moment is rounded to nearest even.
//
// Bound on the H100: memory. One call reads and writes W, mu and nu once
// (6 x 46.9 MB for the 91,641 x 128 f32 user table; 4 x 46.9 MB with bf16
// moments) plus the batch's gradient rows, and does ~20 flops per element.
// A dense gradient (the routed trainer's overflow rounds) adds one read of
// one more [n, d] f32 table. The gather adds its output (5.1 MB for 10,000
// next rows of 128), stored from the registers that hold the updated rows.
//
// What else bounds it: skewed ids. Training batches are skewed (about 70 %
// of a 10,000-id anime batch falls on the first 32 rows), and a row's run
// of equal ids is a serial chain of adds. Summed by the row's own block, the
// hottest run (thousands of gradient rows) sets the kernel's time; copied by
// that block, the hottest next row's copies (one dependent load and store
// each) do the same. The design bounds both chains by a tile of kTile = 32
// sorted positions, one per lane of a warp:
//   * fused_adam_tiles_kernel (entry fused_adam_tiles), first, a warp per
//     tile and slot: only the segments of runs that cross the tile's edges
//     (at most two, its first and its last run) are summed, into tile_sums
//     [2 * tiles, d] (slot 0 the first run's, slot 1 the last run's; a tile
//     of one run crossing both edges fills slot 0 alone), kPipe loads in
//     flight. The same warps write each update block's slice of the sorted
//     ids (starts) and of the sorted next ids (gstarts), from the ids they
//     hold: no searchsorted on the host's side. A tile with no crossing run
//     costs one load a lane;
//   * the update, one block per 32 table rows, 256 threads, a thread per
//     float4 of a row (a warp covers one 128-wide row): warp 0 finds the
//     rows' runs in the block's slice (a slice of at most 32 ids is one load
//     and 33 ballots, a longer one a binary search a lane), then each thread
//     sums its run (kSumPipe loads in flight): a run in one tile from the
//     gradient rows (at most kTile), a longer one from its tile sums (its
//     "parts", one float4 per tile) in tile order. A run of more than
//     kLongParts parts (a row hit more than ~1,000 times) is summed by the
//     whole block first: its parts in at most kChain chunks side by side,
//     each chunk's sum written over its first part's slot, which only this
//     run reads; then its threads add the chunk sums. So no thread's chain is
//     longer than a tile of gradient rows or kLongParts tile sums, whatever
//     the skew; no float atomics. kSumPipe stays small and kMinBlocks keeps
//     4 blocks on an SM: registers, not loads in flight, set how many blocks
//     an SM holds, and one block's loads hide another's math;
//   * the dense float4 is loaded before the run's sum and added after it
//     (the plain version's order), and the dense kernel issues W, mu and nu
//     with it: four loads a thread hide the sum;
//   * the table is not padded: every read and write is bounded at row n, and
//     ids outside [0, n) lie outside every block's slice (and every tile sum);
//   * the update is one device function (adam_block) that every variant
//     runs, so fused_adam_gather's tables equal fused_adam's bit for bit;
//   * the gather: the sorted next ids (nids, with their original positions
//     norder) are cut into tiles of kTile as well, and warp 1 finds the
//     rows' next-id runs. A next row whose copies lie in one tile is copied
//     by the threads that updated it: each updated float4, still in
//     registers, is stored to each copy's position (no table read, no
//     barrier). The copies of a run crossing tile edges, and the zero rows of
//     ids outside [0, n), go to fused_adam_copies_kernel (entry
//     fused_adam_copies), launched after the update, a warp per tile: each
//     lane loads its float4 of the tile's first and last row once and the
//     warp stores them to their copies, a row at a time. No warp stores more
//     than kTile copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;         // table rows per update block: one per lane
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;     // update blocks an SM must hold: <= 64 registers
constexpr int kSumPipe = 4;       // float4 loads in flight in an update thread's sum
constexpr int kPipe = 16;         // the same in the first pass
constexpr int kLongParts = 32;    // a run of more tile sums ("parts") is chunked:
constexpr int kChain = 8;         // its parts added in at most this many chunks
constexpr int kTile = 32;         // sorted positions per tile: one per lane of a warp
constexpr int kPassWarps = 8;     // warps per block of the two passes
constexpr int kPassThreads = 32 * kPassWarps;
constexpr unsigned kAll = 0xffffffffu;
static_assert(kTile == 32 && kRows == 32, "a warp holds a tile's ids, and a block's rows");

struct Scalars {
  float lr, bc1, bc2, eps, l2, b1, b2;
};

// Stateless 32-bit mixer; both multipliers are odd and below 2^31, so the
// plain version can run it exactly in int64.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x2c1b3c6du;
  x ^= x >> 16;
  return x;
}

// A moment float4's stored bits, kept as loaded until the update needs
// them (bf16: 2 registers, not 4), and its f32 values.
__device__ __forceinline__ float4 load_moment(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ uint2 load_moment(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ float4 moment_values(float4 v) { return v; }

__device__ __forceinline__ float4 moment_values(uint2 raw) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename M>
using MomentBits = decltype(load_moment(static_cast<const M*>(nullptr)));

__device__ __forceinline__ void store_moment(float* p, float4 v, bool, uint32_t) {
  *reinterpret_cast<float4*>(p) = v;
}

// bf16 bits of x: stochastic rounding with random bits ``rand``, or nearest.
__device__ __forceinline__ uint32_t bf16_bits(float x, bool sr, uint32_t rand) {
  if (sr) return ((__float_as_uint(x) + (rand & 0xFFFFu)) & 0xFFFF0000u) >> 16;
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// ``key`` is the row's hash; column j of the float4 gets mix32(key + col + j).
__device__ __forceinline__ void store_moment(__nv_bfloat16* p, float4 v, bool sr,
                                             uint32_t key_col) {
  uint2 raw;
  raw.x = bf16_bits(v.x, sr, mix32(key_col)) | (bf16_bits(v.y, sr, mix32(key_col + 1u)) << 16);
  raw.y = bf16_bits(v.z, sr, mix32(key_col + 2u)) | (bf16_bits(v.w, sr, mix32(key_col + 3u)) << 16);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void adam(float dscat, float& w, float& m, float& v,
                                     const Scalars& s, float two_l2, float omb1,
                                     float omb2) {
  const float g = __fadd_rn(dscat, __fmul_rn(w, two_l2));
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(g, omb1));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(__fmul_rn(g, g), omb2));
  const float upd = __fdiv_rn(__fdiv_rn(m, s.bc1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps));
  w = __fsub_rn(w, __fmul_rn(upd, s.lr));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Coherent: bypasses L1, for data other threads of the kernel wrote.
__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

// acc + p[0] + p[stride] + ... (count float4s), added in that order, P
// loads in flight (kCoherent: through L2 only).
template <int P, bool kCoherent = false>
__device__ __forceinline__ float4 sum_in_order(float4 acc, const float* p, size_t stride,
                                               int count) {
  for (int j = 0; j < count; j += P) {
    const int m = min(P, count - j);
    float4 v[P];
#pragma unroll
    for (int u = 0; u < P; ++u)
      if (u < m) v[u] = kCoherent ? ldcg4(p + (size_t)(j + u) * stride)
                                  : ldg4(p + (size_t)(j + u) * stride);
#pragma unroll
    for (int u = 0; u < P; ++u)
      if (u < m) acc = add4(acc, v[u]);
  }
  return acc;
}

// One tile of sorted ids seen by a warp: lane l holds position p0 + l.
struct TileView {
  int p0, p1;        // the tile's positions [p0, p1)
  bool in_tile;      // this lane's position is one
  int id;            // its id (0 past p1)
  int before;        // the id at p0 - 1 (0 for the first tile)
  int first, last;   // the tile's first and last id
  bool left, right;  // its first run began in an earlier tile; its last goes on
};

// Reads tile ``tile`` of the ``b`` sorted ids: one load a lane, both
// neighbours' ids broadcast, in one round trip. Warp-uniform but in_tile, id.
__device__ __forceinline__ TileView view_tile(const int32_t* ids, int b, int tile, int lane) {
  TileView v;
  v.p0 = tile * kTile;
  v.p1 = min(v.p0 + kTile, b);
  v.in_tile = v.p0 + lane < v.p1;
  v.id = v.in_tile ? __ldg(ids + v.p0 + lane) : 0;
  v.before = v.p0 > 0 ? __ldg(ids + v.p0 - 1) : 0;
  const int after = v.p1 < b ? __ldg(ids + v.p1) : 0;
  v.first = __shfl_sync(kAll, v.id, 0);
  v.last = __shfl_sync(kAll, v.id, v.p1 - v.p0 - 1);
  v.left = v.p0 > 0 && v.before == v.first;
  v.right = v.p1 < b && after == v.last;
  return v;
}

// First position in [lo, hi) of the sorted ids whose id >= key.
__device__ __forceinline__ int lower_bound(const int32_t* ids, int lo, int hi, int key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ids + mid) < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The update block of an id's row: -1 below the table, nb past it.
__device__ __forceinline__ int row_block(int id, int n, int nb) {
  return id < 0 ? -1 : (id >= n ? nb : id / kRows);
}

// starts[k] = pos for k in (lo, hi], a warp's stores side by side.
__device__ __forceinline__ void fill(int32_t* starts, int lo, int hi, int pos, int lane) {
  for (int k = lo + 1 + lane; k <= hi; k += 32) starts[k] = pos;
}

// The block starts of one tile of sorted ids: starts[k] is the first
// position whose row block is >= k (what searchsorted over the blocks' first
// rows, clamped to n, gives), so each position fills the blocks from its
// predecessor's (exclusive) to its own; the tile holding the last position
// fills the rest, up to nb, with b.
__device__ __forceinline__ void tile_starts(const TileView& v, int b, int n, int nb,
                                            int32_t* starts, int lane) {
  const int up = __shfl_up_sync(kAll, v.id, 1);  // every lane takes part
  const int prev_id = lane == 0 ? v.before : up;
  const int prev = v.p0 + lane == 0 ? -1 : row_block(prev_id, n, nb);
  const int cur = row_block(v.id, n, nb);
  for (unsigned m = __ballot_sync(kAll, v.in_tile && cur > prev); m; m &= m - 1) {
    const int j = __ffs(m) - 1;
    fill(starts, __shfl_sync(kAll, prev, j), __shfl_sync(kAll, cur, j), v.p0 + j, lane);
  }
  if (v.p1 == b) fill(starts, row_block(v.last, n, nb), nb, b, lane);
}

// The first pass (module note). Warps 2t and 2t + 1 take tile t of the
// sorted ids: the first its block starts and the sum of the segment of its
// first run when that run (of an id in [0, n)) began in an earlier tile,
// into slot 2t of tile_sums; the second the sum of the segment of its last
// run when that one goes on and is not the first, into slot 2t + 1. Each
// sum from 0 in position order, kPipe loads in flight. With gstarts, the
// warps after them take a tile of the sorted next ids each and write its
// block starts. An empty list of ids has one tile of none, which fills its
// starts with 0.
__global__ void __launch_bounds__(kPassThreads)
fused_adam_tiles_kernel(const int32_t* __restrict__ ids, const float* __restrict__ grads,
                        float* __restrict__ tile_sums, int32_t* __restrict__ starts, int b,
                        const int32_t* __restrict__ nids, int32_t* __restrict__ gstarts,
                        int n_next, int n, int d) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kPassWarps + (threadIdx.x >> 5);
  const int nb = (n + kRows - 1) / kRows;
  const int id_warps = 2 * max(1, (b + kTile - 1) / kTile);
  if (warp >= id_warps) {  // the next ids' block starts
    const int tile = warp - id_warps;
    if (!gstarts || tile * kTile >= max(n_next, 1)) return;
    if (n_next == 0) return fill(gstarts, -1, nb, 0, lane);
    tile_starts(view_tile(nids, n_next, tile, lane), n_next, n, nb, gstarts, lane);
    return;
  }
  const int tile = warp >> 1;
  const int slot = warp & 1;
  if (b == 0) {
    if (slot == 0) fill(starts, -1, nb, 0, lane);
    return;
  }
  const TileView v = view_tile(ids, b, tile, lane);
  if (slot == 0) tile_starts(v, b, n, nb, starts, lane);
  const bool left = v.left && v.first >= 0 && v.first < n;
  const bool right = v.right && v.last >= 0 && v.last < n && !(left && v.first == v.last);
  if (slot == 0 ? !left : !right) return;  // the same for every lane of the warp
  const int run = slot == 0 ? v.first : v.last;
  const int count = __popc(__ballot_sync(kAll, v.in_tile && v.id == run));
  const int lo = slot == 0 ? v.p0 : v.p1 - count;
  for (int c = lane * 4; c < d; c += 128)
    st4(tile_sums + (size_t)(2 * tile + slot) * d + c,
        sum_in_order<kPipe>(make_float4(0.f, 0.f, 0.f, 0.f), grads + (size_t)lo * d + c, d,
                            count));
}

// Lane r's run [lo, hi) of row row0 + r in the sorted ids' slice [seg_lo,
// seg_hi) (a warp's work). A slice of at most 32 ids is read in one load
// and counted with ballots; a longer one is searched.
__device__ __forceinline__ void find_runs(const int32_t* ids, int seg_lo, int seg_hi, int row0,
                                          int lane, int& lo, int& hi) {
  if (seg_hi - seg_lo <= 32) {
    const bool in = seg_lo + lane < seg_hi;
    const int id = in ? __ldg(ids + seg_lo + lane) : 0;
    lo = hi = seg_lo;
#pragma unroll
    for (int r = 0; r <= 32; ++r) {
      const int below = __popc(__ballot_sync(kAll, in && id < row0 + r));
      if (lane == r) lo += below;
      if (lane == r - 1) hi += below;
    }
    return;
  }
  lo = lower_bound(ids, seg_lo, seg_hi, row0 + lane);
  hi = lower_bound(ids, lo, seg_hi, row0 + lane + 1);
}

// A crossing run's tile sums, in tile order, are its "parts": part 0 is
// slot 1 of its first tile t0, part i > 0 slot 0 of tile t0 + i. The part
// i's slot of tile_sums:
__device__ __forceinline__ size_t part_slot(int t0, int i) {
  return i == 0 ? 2 * (size_t)t0 + 1 : 2 * (size_t)(t0 + i);
}

// Parts a chunk of a run of ``parts`` parts holds: 1 up to kLongParts
// parts, beyond that enough that the run has at most kChain chunks.
__device__ __forceinline__ int chunk_parts(int parts) {
  return parts > kLongParts ? (parts + kChain - 1) / kChain : 1;
}

// A long run's chunks (more than one part each): chunk g's parts [g q,
// min(g q + q, parts)) summed from 0 in order, into part g q's slot, which
// only this run reads. Threads of the block take (chunk, float4) items.
__device__ __forceinline__ void sum_chunks(float* tile_sums, int lo, int hi, int d, int t) {
  const int t0 = lo / kTile;
  const int parts = (hi - 1) / kTile - t0 + 1;
  const int q = chunk_parts(parts);
  const int d4 = d >> 2;
  for (int item = t; item < kChain * d4; item += kThreads) {
    const int g = item / d4;
    const int c = (item - g * d4) * 4;
    const int i0 = g * q;
    if (i0 >= parts) continue;
    const int i1 = min(i0 + q, parts);
    float4 acc = add4(make_float4(0.f, 0.f, 0.f, 0.f), ldg4(tile_sums + part_slot(t0, i0) * d + c));
    acc = sum_in_order<kSumPipe>(acc, tile_sums + part_slot(t0, i0 + 1) * d + c, 2 * (size_t)d,
                                 i1 - i0 - 1);
    st4(tile_sums + part_slot(t0, i0) * d + c, acc);
  }
}

// dscat of one float4 column c of the row whose run is [lo, hi): a run in
// one tile summed from its gradient rows, a crossing one from its parts
// (or, past kChain parts, the chunk sums sum_chunks left) in order.
__device__ __forceinline__ float4 run_sum(const float* grads, const float* tile_sums, int lo,
                                          int hi, int d, int c) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lo >= hi) return zero;
  const int t0 = lo / kTile;
  const int t1 = (hi - 1) / kTile;
  if (t0 == t1) return sum_in_order<kSumPipe>(zero, grads + (size_t)lo * d + c, d, hi - lo);
  const int parts = t1 - t0 + 1;
  const int q = chunk_parts(parts);
  const float* first = tile_sums + part_slot(t0, 0) * d + c;
  const float* rest = tile_sums + part_slot(t0, q) * d + c;
  const size_t stride = 2 * (size_t)q * d;
  const int chunks = (parts + q - 1) / q;
  if (q == 1)
    return sum_in_order<kSumPipe>(add4(zero, ldg4(first)), rest, stride, chunks - 1);
  return sum_in_order<kSumPipe, true>(add4(zero, ldcg4(first)), rest, stride, chunks - 1);
}

// The gather's inputs: sorted next ids, their original positions, each
// block's slice of them, and the output rows.
struct Gather {
  const int32_t* nids;
  const int32_t* norder;
  const int32_t* gstarts;
  float* rows_out;
};

// The update of block blockIdx.x's rows [row0, min(row0 + 32, n)), its sumsq
// partial and (kGather) the copies of its rows whose next-id runs lie in one
// tile. kDense: add dense[row, c..c+3] to each run's sum before the update.
template <typename M, bool kDense, bool kGather>
__device__ __forceinline__ void adam_block(float* __restrict__ w, M* __restrict__ mu,
                                           M* __restrict__ nu, const int32_t* __restrict__ ids,
                                           const float* __restrict__ grads,
                                           const float* __restrict__ dense,
                                           const int32_t* __restrict__ starts,
                                           float* __restrict__ tile_sums,
                                           float* __restrict__ partials, Gather gather, int n,
                                           int d, const Scalars& s, int sr, uint32_t step) {
  __shared__ int run_lo[kRows];
  __shared__ int run_hi[kRows];
  __shared__ int next_lo[kRows];
  __shared__ int next_hi[kRows];
  __shared__ unsigned long_runs;  // rows whose runs have more than kLongParts parts
  __shared__ float warp_sums[kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int row0 = blockIdx.x * kRows;
  const int d4 = d >> 2;
  const int total = min(kRows, n - row0) * d4;  // float4 elements of the block

  // Element e of the block (row e / d4, float4 e % d4) is thread e % 256's.
  // The dense kernel issues an element's W, mu and nu loads with its dense
  // load, before anything waits (the first element's before the run
  // search): 4 loads a thread then hide the sum. K1 and K5 load them after
  // the sum, which keeps them at 64 registers without spilling.
  constexpr bool prefetch = kDense;
  float4 wv, dv;
  MomentBits<M> mv, vv;
  auto load = [&](int e) {
    const int r = e / d4;
    const size_t off = (size_t)(row0 + r) * d + (e - r * d4) * 4;
    wv = *reinterpret_cast<const float4*>(w + off);
    mv = load_moment(mu + off);
    vv = load_moment(nu + off);
  };
  if (prefetch && t < total) load(t);

  if (t < 32) {
    int lo, hi;
    find_runs(ids, starts[blockIdx.x], starts[blockIdx.x + 1], row0, lane, lo, hi);
    run_lo[lane] = lo;
    run_hi[lane] = hi;
    const unsigned longs =
        __ballot_sync(kAll, hi > lo && (hi - 1) / kTile - lo / kTile >= kLongParts);
    if (lane == 0) long_runs = longs;
  } else if (kGather && t < 64) {
    int lo, hi;
    find_runs(gather.nids, gather.gstarts[blockIdx.x], gather.gstarts[blockIdx.x + 1], row0,
              lane, lo, hi);
    next_lo[lane] = lo;
    next_hi[lane] = hi;
  }
  __syncthreads();
  if (long_runs) {  // the same for the whole block: a hot row's chunks, by every thread
    for (unsigned m = long_runs; m; m &= m - 1) {
      const int r = __ffs(m) - 1;
      sum_chunks(tile_sums, run_lo[r], run_hi[r], d, t);
    }
    __syncthreads();  // the chunk sums are read by the rows' own threads
  }

  const float two_l2 = __fmul_rn(2.f, s.l2);
  const float omb1 = __fsub_rn(1.f, s.b1);
  const float omb2 = __fsub_rn(1.f, s.b2);
  const bool use_sr = sr != 0;
  const uint32_t seed_mu = mix32(2u * step);
  const uint32_t seed_nu = mix32(2u * step + 1u);
  float sq = 0.f;
  for (int e = t; e < total; e += kThreads) {
    const int r = e / d4;
    const int row = row0 + r;
    const int c = (e - r * d4) * 4;
    const size_t off = (size_t)row * d + c;
    if (prefetch && e != t) load(e);
    if constexpr (kDense) dv = ldg4(dense + off);  // before the run's sum, added after
    float4 acc = run_sum(grads, tile_sums, run_lo[r], run_hi[r], d, c);
    if constexpr (kDense) acc = add4(acc, dv);
    if (!prefetch) load(e);
    float4 w4 = wv;
    float4 m = moment_values(mv);
    float4 v = moment_values(vv);
    sq = fmaf(w4.x, w4.x, sq);
    sq = fmaf(w4.y, w4.y, sq);
    sq = fmaf(w4.z, w4.z, sq);
    sq = fmaf(w4.w, w4.w, sq);
    adam(acc.x, w4.x, m.x, v.x, s, two_l2, omb1, omb2);
    adam(acc.y, w4.y, m.y, v.y, s, two_l2, omb1, omb2);
    adam(acc.z, w4.z, m.z, v.z, s, two_l2, omb1, omb2);
    adam(acc.w, w4.w, m.w, v.w, s, two_l2, omb1, omb2);
    st4(w + off, w4);
    store_moment(mu + off, m, use_sr, mix32(seed_mu + (uint32_t)row) + (uint32_t)c);
    store_moment(nu + off, v, use_sr, mix32(seed_nu + (uint32_t)row) + (uint32_t)c);
    if constexpr (kGather) {
      // Copies of a run crossing a tile edge are fused_adam_copies_kernel's.
      const int glo = next_lo[r];
      const int ghi = next_hi[r];
      if (glo < ghi && glo / kTile == (ghi - 1) / kTile) {
        for (int j = glo; j < ghi; j += kSumPipe) {
          const int m_ = min(kSumPipe, ghi - j);
          int dst[kSumPipe];
#pragma unroll
          for (int u = 0; u < kSumPipe; ++u)
            if (u < m_) dst[u] = __ldg(gather.norder + j + u);
#pragma unroll
          for (int u = 0; u < kSumPipe; ++u)
            if (u < m_) st4(gather.rows_out + (size_t)dst[u] * d + c, w4);
        }
      }
    }
  }

  // One sumsq partial per block.
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if ((t & 31) == 0) warp_sums[t >> 5] = sq;
  __syncthreads();
  if (t == 0) {
    float total_sq = 0.f;
    for (int i = 0; i < kWarps; ++i) total_sq += warp_sums[i];
    partials[blockIdx.x] = total_sq;
  }
}

template <typename M>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_adam_kernel(float* __restrict__ w, M* __restrict__ mu, M* __restrict__ nu,
                  const int32_t* __restrict__ ids, const float* __restrict__ grads,
                  const int32_t* __restrict__ starts, float* __restrict__ tile_sums,
                  float* __restrict__ partials, int n, int d, Scalars s, int sr,
                  uint32_t step) {
  adam_block<M, false, false>(w, mu, nu, ids, grads, nullptr, starts, tile_sums, partials,
                              Gather{}, n, d, s, sr, step);
}

// The same with a dense gradient: its own kernel, so a profile tells the two apart.
template <typename M>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_adam_dense_kernel(float* __restrict__ w, M* __restrict__ mu, M* __restrict__ nu,
                        const int32_t* __restrict__ ids, const float* __restrict__ grads,
                        const float* __restrict__ dense, const int32_t* __restrict__ starts,
                        float* __restrict__ tile_sums, float* __restrict__ partials,
                        int n, int d, Scalars s, int sr, uint32_t step) {
  adam_block<M, true, false>(w, mu, nu, ids, grads, dense, starts, tile_sums, partials,
                             Gather{}, n, d, s, sr, step);
}

template <typename M>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_adam_gather_kernel(float* __restrict__ w, M* __restrict__ mu, M* __restrict__ nu,
                         const int32_t* __restrict__ ids, const float* __restrict__ grads,
                         const int32_t* __restrict__ starts,
                         float* __restrict__ tile_sums, float* __restrict__ partials,
                         Gather gather, int n, int d, Scalars s, int sr, uint32_t step) {
  adam_block<M, false, true>(w, mu, nu, ids, grads, nullptr, starts, tile_sums, partials,
                             gather, n, d, s, sr, step);
}

// The gather's second pass, a warp per tile of the sorted next ids: the
// copies of its first and last run where they cross the tile's edges (each
// lane loads its float4 of the row once and the warp stores it to each
// copy, a row at a time), and zero rows for ids outside [0, n) (sorted,
// they are a prefix and a suffix of the next ids).
__global__ void __launch_bounds__(kPassThreads)
fused_adam_copies_kernel(const float* __restrict__ w, const int32_t* __restrict__ nids,
                         const int32_t* __restrict__ norder, float* __restrict__ rows_out,
                         int n_next, int n, int d) {
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kPassWarps + (threadIdx.x >> 5);
  if (tile * kTile >= n_next) return;  // the same for every lane of the warp
  const int pos = tile * kTile + lane;
  const int dst = pos < n_next ? __ldg(norder + pos) : 0;  // in flight with the ids
  const TileView v = view_tile(nids, n_next, tile, lane);
  if (!v.left && !v.right && v.first >= 0 && v.last < n) return;
  const bool outside = v.id < 0 || v.id >= n;
  const bool of_head = v.left && v.id == v.first;
  const bool of_tail = v.right && v.id == v.last;
  const unsigned writes = __ballot_sync(kAll, v.in_tile && (outside || of_head || of_tail));
  const bool head_in = v.left && v.first >= 0 && v.first < n;
  const bool tail_in = v.right && v.last >= 0 && v.last < n;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < d; c0 += 128) {
    const int c = c0 + lane * 4;
    const bool col = c < d;
    const float4 head = col && head_in ? ldg4(w + (size_t)v.first * d + c) : zero;
    const float4 tail = col && tail_in ? ldg4(w + (size_t)v.last * d + c) : zero;
    for (unsigned m = writes; m; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const int id = __shfl_sync(kAll, v.id, j);
      const int to = __shfl_sync(kAll, dst, j);
      const bool zero_row = id < 0 || id >= n;
      if (col)
        st4(rows_out + (size_t)to * d + c,
            zero_row ? zero : (v.left && id == v.first ? head : tail));
    }
  }
}

int check_args(int n, int d, int block_rows, int tile, int moment_dtype) {
  if (n <= 0 || d <= 0 || d % 4 != 0 || block_rows != kRows || tile != kTile ||
      (moment_dtype != 0 && moment_dtype != 1))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// The first pass of fused_adam and fused_adam_gather, one launch: ids
// (int32 [b], ascending) and grads (f32 [b, d], same order, 16-byte
// aligned; both may be null when b = 0) are the batch's. tile_sums (f32
// [2 * ceil(b / tile), d], 16-byte aligned) receives the sums of the
// segments of runs that cross a tile's edges (slot 2t the first run's of
// tile t, slot 2t + 1 its last run's; no other slot is written), starts
// (int32 [nb + 1], nb = ceil(n / block_rows)) where each block's rows begin
// in the sorted ids, and gstarts (int32 [nb + 1], or null for none) the
// same in the sorted next ids nids (int32 [n_next], may be null when n_next
// = 0). block_rows and tile must be 32 and d a multiple of 4.
extern "C" int fused_adam_tiles(const int32_t* ids, const float* grads, int b,
                                const int32_t* nids, int n_next, float* tile_sums,
                                int32_t* starts, int32_t* gstarts, int n, int d, int block_rows,
                                int tile, void* stream) {
  if (b < 0 || n_next < 0 || n <= 0 || d <= 0 || d % 4 != 0 || block_rows != kRows ||
      tile != kTile || !starts || (b > 0 && (!ids || !grads || !tile_sums)) ||
      (gstarts && n_next > 0 && !nids))
    return (int)cudaErrorInvalidValue;
  const int warps = 2 * max(1, (b + kTile - 1) / kTile) +
                    (gstarts ? max(1, (n_next + kTile - 1) / kTile) : 0);
  fused_adam_tiles_kernel<<<(warps + kPassWarps - 1) / kPassWarps, kPassThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      ids, grads, tile_sums, starts, b, nids, gstarts, n_next, n, d);
  return (int)cudaGetLastError();
}

// moment_dtype: 0 = float32, 1 = bfloat16 (mu and nu share it). ids (int32
// [B], ascending) and grads (f32 [B, d], same order) may be null when B = 0;
// tile_sums and starts are fused_adam_tiles' outputs for them (tile_sums
// null when B = 0; the kernel overwrites the slots of runs of more than
// kLongParts parts, which only it reads): starts (int32 [nb + 1], nb = ceil(n / block_rows))
// holds where each block's rows [b * block_rows, min((b + 1) * block_rows,
// n)) begin in the sorted ids. dense (f32 [n, d], 16-byte aligned) is added
// to every row's gradient sum, or null for none. partials (f32 [nb])
// receives one sumsq partial per block. block_rows
// must be 32, tile 32 and d a multiple of 4; W, mu, nu and grads must be
// 16-byte aligned (8-byte for bf16 moments). sr != 0 rounds bf16 moments
// stochastically. Updates W, mu and nu in place. Returns a cudaError_t (0 on
// success).
extern "C" int fused_adam(float* w, void* mu, void* nu, int moment_dtype,
                          const int32_t* ids, const float* grads, const float* dense,
                          const int32_t* starts, float* tile_sums, float* partials,
                          int n, int d, int block_rows, int tile, float lr, float bc1,
                          float bc2, float eps, float l2, float b1, float b2, int sr,
                          unsigned int step, void* stream) {
  if (const int err = check_args(n, d, block_rows, tile, moment_dtype)) return err;
  const Scalars s{lr, bc1, bc2, eps, l2, b1, b2};
  const dim3 grid((n + kRows - 1) / kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (moment_dtype == 0) {
    float* m = static_cast<float*>(mu);
    float* v = static_cast<float*>(nu);
    if (dense)
      fused_adam_dense_kernel<float><<<grid, kThreads, 0, st>>>(
          w, m, v, ids, grads, dense, starts, tile_sums, partials, n, d, s, 0, step);
    else
      fused_adam_kernel<float><<<grid, kThreads, 0, st>>>(
          w, m, v, ids, grads, starts, tile_sums, partials, n, d, s, 0, step);
  } else {
    __nv_bfloat16* m = static_cast<__nv_bfloat16*>(mu);
    __nv_bfloat16* v = static_cast<__nv_bfloat16*>(nu);
    if (dense)
      fused_adam_dense_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          w, m, v, ids, grads, dense, starts, tile_sums, partials, n, d, s, sr, step);
    else
      fused_adam_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          w, m, v, ids, grads, starts, tile_sums, partials, n, d, s, sr, step);
  }
  return (int)cudaGetLastError();
}

// fused_adam without a dense gradient, plus rows_out (f32 [n_next, d],
// 16-byte aligned) = W'[next id] for each next id whose run of equal sorted
// next ids lies in one tile (fused_adam_copies writes the others). nids
// (int32 [n_next]) are the next ids sorted ascending, norder (int32
// [n_next]) the original position of each (a stable argsort), gstarts
// (int32 [nb + 1]) fused_adam_tiles' block starts of nids. nids and norder
// may be null when n_next = 0.
extern "C" int fused_adam_gather(float* w, void* mu, void* nu, int moment_dtype,
                                 const int32_t* ids, const float* grads,
                                 const int32_t* starts, float* tile_sums,
                                 float* partials, const int32_t* nids, const int32_t* norder,
                                 const int32_t* gstarts, float* rows_out, int n_next, int n,
                                 int d, int block_rows, int tile, float lr, float bc1,
                                 float bc2, float eps, float l2, float b1, float b2, int sr,
                                 unsigned int step, void* stream) {
  if (const int err = check_args(n, d, block_rows, tile, moment_dtype)) return err;
  if (n_next < 0) return (int)cudaErrorInvalidValue;
  const Scalars s{lr, bc1, bc2, eps, l2, b1, b2};
  const dim3 grid((n + kRows - 1) / kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Gather gather{nids, norder, gstarts, rows_out};
  if (moment_dtype == 0)
    fused_adam_gather_kernel<float><<<grid, kThreads, 0, st>>>(
        w, static_cast<float*>(mu), static_cast<float*>(nu), ids, grads, starts, tile_sums,
        partials, gather, n, d, s, 0, step);
  else
    fused_adam_gather_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        w, static_cast<__nv_bfloat16*>(mu), static_cast<__nv_bfloat16*>(nu), ids, grads,
        starts, tile_sums, partials, gather, n, d, s, sr, step);
  return (int)cudaGetLastError();
}

// The gather's second pass, after fused_adam_gather on the same stream:
// rows_out[norder[j]] = W'[nids[j]] for the positions j of runs of equal
// next ids that cross a tile's edges, and 0 for next ids outside [0, n). No
// other row is written. n_next must be > 0, tile 32 and d a multiple of 4.
extern "C" int fused_adam_copies(const float* w, const int32_t* nids, const int32_t* norder,
                                 float* rows_out, int n_next, int n, int d, int tile,
                                 void* stream) {
  if (n_next <= 0 || n <= 0 || d <= 0 || d % 4 != 0 || tile != kTile)
    return (int)cudaErrorInvalidValue;
  const int tiles = (n_next + kTile - 1) / kTile;
  fused_adam_copies_kernel<<<(tiles + kPassWarps - 1) / kPassWarps, kPassThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(w, nids, norder, rows_out,
                                                                  n_next, n, d);
  return (int)cudaGetLastError();
}
