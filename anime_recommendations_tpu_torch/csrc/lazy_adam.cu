// Row-sparse (lazy) Adam update of a step's embedding tables in one launch
// (ops/lazy_adam.py), hand-written for Hopper.
//
// Replaces no Pallas kernel: the JAX package leaves this update to XLA
// (anime_recommendations_tpu/train/lazy.py: a sort, segment sums and
// scatters). The port ran it as a torch chain of about 40 launches a table
// (ops/lazy_adam._lazy_row_adam_plain: gathers in sorted order, index_add_
// of the runs, three row gathers, ~17 elementwise passes, three
// index_copy_); this kernel is everything after the id sort, for every table
// of a step, in one launch.
//
// What it computes. The caller sorts the step's keys stably (table t's ids
// plus key_offset[t], so the tables' sorted positions follow one another)
// and passes the sorted keys and the sort's order. A run is a maximal range
// of equal sorted keys: one table row r. For each run, with lr, bc1 and bc2
// read from the step's row in device memory:
//   g   = sum over the run's kept positions p of g_rows[order[p]]   (from 0)
//   g'  = g + (2*l2)*w[r]
//   mu' = b1*mu[r] + (1-b1)*g'
//   nu' = b2*nu[r] + (1-b2)*(g'*g')
//   w'  = w[r] + (-lr*(mu'/bc1)) / (sqrt(nu'/bc2) + eps)
// each an explicitly rounded f32 operation in the plain chain's order (no
// FMA contraction; divisions divide), so a row hit once equals the chain bit
// for bit. A run with no kept position (``keep``) leaves its row as it was.
// Each row is read once and written once, by one warp.
//
// The sum. The chain sums a run with index_add_'s atomics, in an order that
// changes from run to run; here the order is fixed: a run's positions in
// sorted order (the batch's order among equal ids: the sort is stable) in
// pieces of at most kChunk positions, each piece summed from 0, the pieces
// added from 0 in order. So a run's sum depends on the data alone, and a
// repeated id's row may differ from the chain's in its last f32 bits.
//
// Bound on the H100: memory. A step reads the gradient rows (B*D*4 bytes a
// table) and reads and writes W, mu and nu of each touched row (24*D bytes a
// row). The KDD-Cup'11 lazy cell's step (B 10,000 a table, D 128, ~18,200
// touched rows of 1.63M) moves 2 x 5.12 MB + ~56 MB: ~20 us at 3.35 TB/s; 16
// f32 operations an element, far below the card's rate.
//
// Design. One warp takes kChunk sorted positions of one table (a chunk; the
// tables' chunks follow one another in the grid), and a run's piece is its
// part of one chunk. A warp finds its run starts with one key load a lane and
// a ballot, then takes each piece in turn: each lane owns 4 columns (float4,
// where D % 4 == 0 and the pointers are 16-byte aligned) or 1, of every 128
// or 32, and sums the piece's gradient rows for them (up to kChunk
// independent loads in flight). A run inside the chunk is updated at once.
// A run that crosses a chunk boundary has one piece in each chunk it
// touches; each piece's warp stores its partial sum (and whether it kept a
// position) in the piece's slot, fences, and counts itself in the run's
// arrival counter; the warp that arrives last adds the slots in chunk order
// and updates the row. So a hot run (Zipf-0.8 items: ~150 of 10,000
// positions for the hottest) is summed by ~19 warps in parallel instead of
// one warp walking 150 rows, and no warp waits on another. Every warp finds
// its run's first and last positions by scanning the sorted keys 32 at a
// time, so its count of pieces is known without a second pass. The arrival
// counters come zeroed from the caller; the slots need no initial value.
// Shared memory: none; atomics: one a crossing piece. Measured on an H100 at
// the lazy cell's shapes (two tables, ~313 blocks of 8 warps): 0.031 ms with
// three blocks an SM, against 0.043 ms with two (the compiler's choice at 92
// to 101 registers: a second wave); chunks of 4, 6, 12 or 16 positions took
// 0.032-0.047 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kMaxTables = 8;
constexpr int kChunk = 8;   // sorted positions a warp takes; CHUNK in ops/lazy_adam.py
constexpr int kWarps = 8;
constexpr int kMinBlocks = 3;   // blocks an SM: at most 85 registers a thread
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

struct Tables {
  float* w[kMaxTables];
  float* m[kMaxTables];
  float* v[kMaxTables];
  const float* g[kMaxTables];
  int rows[kMaxTables];
  int key_offset[kMaxTables];       // table t's keys are its ids + key_offset[t]
  int pos_begin[kMaxTables + 1];    // table t's sorted positions [pos_begin[t], pos_begin[t+1])
  int chunk_begin[kMaxTables + 1];  // and its chunks [chunk_begin[t], chunk_begin[t+1])
  int count;
};

// The scalars fixed for a run, passed by value as the chain's f32 values.
struct Consts {
  float b1, omb1, b2, omb2, eps, l2x2;
};

enum Load { kPlain, kReadOnly, kL2 };

template <int W>
struct Vec {
  float x[W];
};

template <int W, Load L>
__device__ __forceinline__ Vec<W> load(const float* p) {
  Vec<W> r;
  if constexpr (W == 4) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 t = L == kReadOnly ? __ldg(q) : L == kL2 ? __ldcg(q) : *q;
    r.x[0] = t.x;
    r.x[1] = t.y;
    r.x[2] = t.z;
    r.x[3] = t.w;
  } else {
    r.x[0] = L == kReadOnly ? __ldg(p) : L == kL2 ? __ldcg(p) : *p;
  }
  return r;
}

template <int W>
__device__ __forceinline__ void store(float* p, const Vec<W>& r) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r.x[0], r.x[1], r.x[2], r.x[3]);
  else
    *p = r.x[0];
}

template <int W>
__device__ __forceinline__ void add(Vec<W>& acc, const Vec<W>& g) {
#pragma unroll
  for (int j = 0; j < W; ++j) acc.x[j] = __fadd_rn(acc.x[j], g.x[j]);
}

__device__ __forceinline__ void adam(float g, float& w, float& m, float& v, const Consts& c,
                                     float neglr, float bc1, float bc2) {
  g = __fadd_rn(g, __fmul_rn(c.l2x2, w));
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  const float upd = __fdiv_rn(__fmul_rn(neglr, __fdiv_rn(m, bc1)),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), c.eps));
  w = __fadd_rn(w, upd);
}

// This lane's columns of a row of W, mu and nu.
template <int W>
struct Row {
  Vec<W> w, m, v;
};

template <int W>
__device__ __forceinline__ Row<W> read_row(const float* w, const float* m, const float* v,
                                           long long at) {
  return {load<W, kPlain>(w + at), load<W, kPlain>(m + at), load<W, kPlain>(v + at)};
}

// The row's update from the run's gradient sum g, stored back.
template <int W>
__device__ __forceinline__ void write_update(float* w, float* m, float* v, long long at,
                                             Row<W> r, const Vec<W>& g, const Consts& c,
                                             float neglr, float bc1, float bc2) {
#pragma unroll
  for (int j = 0; j < W; ++j) adam(g.x[j], r.w.x[j], r.m.x[j], r.v.x[j], c, neglr, bc1, bc2);
  store<W>(w + at, r.w);
  store<W>(m + at, r.m);
  store<W>(v + at, r.v);
}

// The first sorted position of key k's run, which holds p - 1 (p > begin).
__device__ __forceinline__ int run_first(const int* keys, int begin, int p, int k, int lane) {
  for (int base = p - 1;; base -= 32) {
    const int q = base - lane;
    const unsigned edge = __ballot_sync(kFull, q < begin || __ldg(keys + q) != k);
    if (edge) return base - (__ffs(edge) - 1) + 1;
  }
}

// One past the last sorted position of key k's run, which holds p (p < end).
__device__ __forceinline__ int run_end(const int* keys, int p, int end, int k, int lane) {
  for (int base = p;; base += 32) {
    const int q = base + lane;
    const unsigned edge = __ballot_sync(kFull, q >= end || __ldg(keys + q) != k);
    if (edge) return base + __ffs(edge) - 1;
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lazy_adam_kernel(const Tables a, const int* __restrict__ keys, const long long* __restrict__ order,
                 const unsigned char* __restrict__ keep, float* __restrict__ partial,
                 int* __restrict__ arrivals, int* __restrict__ live,
                 const float* __restrict__ row, const Consts c, int d) {
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (chunk >= a.chunk_begin[a.count]) return;   // the whole warp
  int t = 0;
  while (chunk >= a.chunk_begin[t + 1]) ++t;
  float* const w = a.w[t];
  float* const m = a.m[t];
  float* const v = a.v[t];
  const float* const g = a.g[t];
  const int begin = a.pos_begin[t], end = a.pos_begin[t + 1];
  const int first_chunk = a.chunk_begin[t];
  const int p0 = begin + (chunk - first_chunk) * kChunk;
  const int np = min(kChunk, end - p0);

  // Lane i < np holds sorted position p0 + i: its key, its gradient row and
  // whether it counts. A position whose order falls outside the table's
  // range (only a key outside [0, rows) puts one there) counts for nothing.
  int key = 0, src = 0;
  bool kept = false;
  if (lane < np) {
    key = __ldg(keys + p0 + lane);
    const long long o = __ldg(order + p0 + lane);
    src = static_cast<int>(o - begin);
    kept = o >= begin && o < end && (keep == nullptr || __ldg(keep + o));
  }
  int prev = __shfl_up_sync(kFull, key, 1);
  if (lane == 0 && p0 > begin) prev = __ldg(keys + p0 - 1);
  const bool run_start = lane < np && (p0 + lane == begin || key != prev);
  const unsigned runs = __ballot_sync(kFull, run_start);
  const unsigned kept_mask = __ballot_sync(kFull, kept);
  unsigned pieces = runs | 1u;   // a piece starts at each run start and at the chunk's start
  int srcs[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) srcs[i] = __shfl_sync(kFull, src, i);
  const bool has_next = p0 + np < end;
  const int next = has_next ? __ldg(keys + p0 + np) : 0;
  const float neglr = -__ldg(row), bc1 = __ldg(row + 1), bc2 = __ldg(row + 2);

  while (pieces) {
    const int s = __ffs(pieces) - 1;
    pieces &= pieces - 1;
    const int e = pieces ? __ffs(pieces) - 1 : np;
    const int k = __shfl_sync(kFull, key, s);
    const bool opens = (runs >> s) & 1u;                  // the piece begins its run
    const bool goes_on = e == np && has_next && next == k;  // the run goes past the chunk
    const bool any = (kept_mask & ((1u << e) - 1u) & ~((1u << s) - 1u)) != 0u;
    const int r = k - a.key_offset[t];
    const bool valid = r >= 0 && r < a.rows[t];
    const long long at = static_cast<long long>(r) * d;
    const bool whole = opens && !goes_on;
    const int slot = 2 * chunk + (opens ? 1 : 0);
    const bool now = whole && any && valid;
    for (int c0 = 0; c0 < d; c0 += 32 * W) {
      const int col = c0 + lane * W;
      if (col >= d) continue;
      Row<W> old{};
      if (now) old = read_row<W>(w, m, v, at + col);   // in flight with the gradient rows
      Vec<W> acc{};
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        if (i >= s && i < e && ((kept_mask >> i) & 1u))
          add<W>(acc, load<W, kReadOnly>(g + static_cast<long long>(srcs[i]) * d + col));
      if (!whole)
        store<W>(partial + static_cast<long long>(slot) * d + col, acc);
      else if (now)
        write_update<W>(w, m, v, at + col, old, acc, c, neglr, bc1, bc2);
    }
    if (whole) continue;

    // A piece of a run that crosses a chunk boundary: publish it, count its
    // arrival; the run's last piece to arrive adds them all in chunk order.
    if (lane == 0) live[slot] = any;
    __threadfence();
    __syncwarp();
    const int lo = opens ? p0 + s : run_first(keys, begin, p0, k, lane);
    const int hi = goes_on ? run_end(keys, p0 + np, end, k, lane) : p0 + e;
    const int c_lo = first_chunk + (lo - begin) / kChunk;
    const int c_hi = first_chunk + (hi - 1 - begin) / kChunk;
    int last = 0;
    if (lane == 0) last = atomicAdd(arrivals + c_lo, 1) == c_hi - c_lo;
    if (!__shfl_sync(kFull, last, 0)) continue;
    __threadfence();
    bool alive = false;
    for (int cc = c_lo + lane; cc <= c_hi; cc += 32)
      alive |= __ldcg(live + 2 * cc + (cc == c_lo ? 1 : 0)) != 0;
    if (!__any_sync(kFull, alive) || !valid) continue;
    for (int c0 = 0; c0 < d; c0 += 32 * W) {
      const int col = c0 + lane * W;
      if (col >= d) continue;
      const Row<W> old = read_row<W>(w, m, v, at + col);
      Vec<W> acc{};
#pragma unroll 4
      for (int cc = c_lo; cc <= c_hi; ++cc)
        add<W>(acc, load<W, kL2>(partial + static_cast<long long>(2 * cc + (cc == c_lo ? 1 : 0)) *
                                               d + col));
      write_update<W>(w, m, v, at + col, old, acc, c, neglr, bc1, bc2);
    }
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

// One row-sparse Adam step over ``count`` (1..8) tables of width d. w, mu,
// nu (each [rows[t], d]) and g (the gradient rows, [batch[t], d]) are host
// arrays of ``count`` device pointers, f32, contiguous, 4-byte aligned.
// keys ([P] int32, P = the sum of batch) are the tables' ids, table t's plus
// the sum of rows[< t], sorted stably; order ([P] int64) the sort's order
// (the positions of the concatenated ids); keep ([P] bool in that
// concatenated order) or null. partial ([2 * n_chunks, d] f32) is scratch;
// flags ([3 * n_chunks] int32) must be zero. n_chunks is the sum over the
// tables of ceil(batch[t] / 8). row (f32 [4] in device memory: lr, bc1, bc2
// and the step's bits) is read when the kernel runs; b1, omb1 = 1 - b1, b2,
// omb2 = 1 - b2, eps and l2x2 = 2 * l2 as the plain chain rounds them.
// Updates w, mu and nu in place on ``stream``; nothing is launched when every
// batch is empty. Returns a cudaError_t (0 on success).
extern "C" int lazy_adam(float* const* w, float* const* mu, float* const* nu,
                         const float* const* g, const int* rows, const int* batch, int count,
                         int d, const int* keys, const long long* order,
                         const unsigned char* keep, float* partial, int* flags, int n_chunks,
                         const float* row, float b1, float omb1, float b2, float omb2, float eps,
                         float l2x2, void* stream) {
  if (count < 1 || count > kMaxTables || d < 1 || !w || !mu || !nu || !g || !rows || !batch ||
      !row || !aligned(row, 4) || n_chunks < 0)
    return (int)cudaErrorInvalidValue;
  Tables a{};
  a.count = count;
  long long key_offset = 0, positions = 0, chunks = 0;
  bool vec = d % 4 == 0;
  for (int t = 0; t < count; ++t) {
    if (rows[t] < 0 || batch[t] < 0) return (int)cudaErrorInvalidValue;
    for (const void* ptr : {static_cast<const void*>(w[t]), static_cast<const void*>(mu[t]),
                            static_cast<const void*>(nu[t]), static_cast<const void*>(g[t])}) {
      if (!ptr || !aligned(ptr, 4)) return (int)cudaErrorInvalidValue;
      vec = vec && aligned(ptr, 16);
    }
    a.w[t] = w[t];
    a.m[t] = mu[t];
    a.v[t] = nu[t];
    a.g[t] = g[t];
    a.rows[t] = rows[t];
    a.key_offset[t] = static_cast<int>(key_offset);
    a.pos_begin[t] = static_cast<int>(positions);
    a.chunk_begin[t] = static_cast<int>(chunks);
    key_offset += rows[t];
    positions += batch[t];
    chunks += (batch[t] + kChunk - 1) / kChunk;
    if (key_offset > 0x7fffffffLL || positions > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  a.pos_begin[count] = static_cast<int>(positions);
  a.chunk_begin[count] = static_cast<int>(chunks);
  if (chunks != n_chunks) return (int)cudaErrorInvalidValue;
  if (chunks == 0) return (int)cudaSuccess;
  if (!keys || !order || !partial || !flags || !aligned(keys, 4) || !aligned(order, 8) ||
      !aligned(partial, 4) || !aligned(flags, 4))
    return (int)cudaErrorInvalidValue;
  vec = vec && aligned(partial, 16);
  const Consts c{b1, omb1, b2, omb2, eps, l2x2};
  const unsigned blocks = static_cast<unsigned>((chunks + kWarps - 1) / kWarps);
  int* arrivals = flags;
  int* live = flags + chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    lazy_adam_kernel<4><<<blocks, kThreads, 0, s>>>(a, keys, order, keep, partial, arrivals, live,
                                                    row, c, d);
  else
    lazy_adam_kernel<1><<<blocks, kThreads, 0, s>>>(a, keys, order, keep, partial, arrivals, live,
                                                    row, c, d);
  return (int)cudaGetLastError();
}
