// Stage 1 of the two-stage top-k over an int8 table (ops/quantized.py),
// hand-written for Hopper.
//
// Replaces: anime_recommendations_tpu/ops/topk.py::_packed_topk_kernel with
// quantized=True (reached from ops/quantized.py::quantized_topk), and its
// _extract_groups.
//
// What it computes, for every query q (int8 row, f32 scale qscale[q]) and
// every 512-row group of the int8 table (f32 row scales wscale[row]):
//   acc = <query_q, row>                       exact int32
//   no head:  s2 = float(acc) * wscale + 2 / qscale
//             (= (cos + 2) / qscale: qscale is constant within a query, so
//             it is folded into the bias and the order is the cosine's)
//   head:     s  = float(acc) * qscale * wscale
//             s2 = sigmoid(alpha * s + beta) + 2
//   s2 = -1 where the row is masked, excluded or >= n
//   key = (bits(s2) & ~511) | (row & 511), top_r largest keys per group
// with the output layout of packed_topk.cu: int32 [Q, ceil(n/512) * top_r],
// group g's keys at [g * top_r, (g + 1) * top_r), largest first.
//
// Every float step is one explicitly rounded operation in the order the
// plain torch version (ops/topk.py::_int8_biased_scores) takes them
// (__fmul_rn / __fadd_rn keep nvcc from contracting them into an FMA), and
// acc is exact, so the keys without a head equal the plain version's bit for
// bit on both branches. With a head, expf may differ from torch's by an ulp.
// acc cannot overflow: quantized rows and queries lie in [-127, 127], so
// |acc| <= d * 127^2 (2.06 M at d = 128; below 2^31 up to d ~ 133,000).
//
// Two branches, one rule (ops/topk.py's INT8_MMA_MIN_Q = kMmaMinQ): on an
// H100 (700 W) tools/scan_kernels.py --time sweep timed the tensor cores
// faster than dp4a from 2 queries on, and slower for one (PERF.md).
//
// One query (similar_users, similar_anime, model_recs, ...) is bound by
// bytes: the 91,641 x 128 int8 user table and its row scales are 12.1 MB,
// 3.6 us at 3.35 TB/s. The dp4a kernel serves it: one block per 512-row group,
// 256 threads of 2 rows each; the group's rows staged through shared memory
// 128 dimensions at a time with 16-byte loads; __dp4a into int32; then
// top_r rounds of block-wide max with knock-out.
//
// From kMmaMinQ queries (the batch endpoints) the products grow with Q while
// the bytes do not: 6.0 G int8 operations at Q = 256 over the user table, 3 us
// at the card's 1,979 T int8 tensor-core rate (dp4a on the CUDA cores has a
// small share of it), and the extraction grows with Q too. The tensor-core
// branch (packed_topk_mma_kernel's shape in packed_topk.cu): one block per
// (query tile, 512-row group), the query tiles of a group adjacent in the grid
// so that they share its rows through L2 (the int8 user table fits the 50 MB
// L2: HBM sees it about once); the product on mma.sync.m16n8k32.s8.s8.s32,
// exact int32 sums. The queries are the M side: 4 m16 tiles of a 64-query
// tile, or the one of a 16-query tile (two blocks an SM) where that fills the
// card better (query_tile), staged from the shared query tile scan::kQueryDims
// dimensions at a time. The table rows are the N side: each of 16 warps owns
// 32 rows of the group and loads their B fragments straight from device
// memory, 16 bytes a lane (each table byte read by one thread), the next 64
// dimensions in flight while the current ones multiply. The k index is
// permuted so that a lane's 16 contiguous bytes feed both k32 steps of one
// 64-dimension chunk; A takes the same permutation, and an integer sum does
// not depend on the order of its terms. Where d is not a multiple of 64, the
// lanes whose 16 bytes lie past d take zeros in A and B alike. Epilogue:
// accumulators -> scale, bias or head, mask, exclude -> packed keys in shared
// memory -> one warp per query extracts (scan::warp_top_keys): no block
// barrier per round.
//
// What remains: one 145 KB block of 64 queries per SM, so its staging,
// product, epilogue and extraction run one after another (the non-overlap
// of packed_topk_mma_kernel at Q = 256); at Q = 256 over the user table the
// kernel reaches 0.06 of its bound (PERF.md). The 16-query kernel spills
// ~100 bytes at its 64 registers, and the one-query kernel keeps its block
// barrier per round.

#include "scan_common.cuh"

namespace {

using scan::kGroup;
constexpr int kLaneMask = kGroup - 1;
constexpr int kIntMin = -2147483647 - 1;
constexpr int kMaxSmem = 232448;   // a block's dynamic shared memory on an H100
// Queries from which the tensor-core branch runs (ops/topk.INT8_MMA_MIN_Q).
constexpr int kMmaMinQ = 2;

// s2 of one (query, row) as the plain version forms it, then its packed key.
__device__ __forceinline__ int int8_key(int acc, float ws, float qsc, float bias,
                                        const float* head, bool live, int local) {
  const float a = __int2float_rn(acc);
  float s2;
  if (head != nullptr) {
    const float s = __fmul_rn(__fmul_rn(a, qsc), ws);
    const float z = __fadd_rn(__fmul_rn(head[0], s), head[1]);
    s2 = __fadd_rn(1.f / (1.f + expf(-z)), 2.f);
  } else {
    s2 = __fadd_rn(__fmul_rn(a, ws), bias);
  }
  if (!live) s2 = -1.f;
  return (__float_as_int(s2) & ~kLaneMask) | local;
}

// ---- below kMmaMinQ: __dp4a ----------------------------------------------------

constexpr int kThreads = 256;
constexpr int kRowsPerThread = kGroup / kThreads;  // 2
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;            // table dimensions staged per step (bytes)
constexpr int kStride = kChunk + 16;   // padded smem row stride (bytes)

__device__ __forceinline__ int dot16(const int4 a, const int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

// One block per (group, query).
__global__ void __launch_bounds__(kThreads)
packed_topk_int8_kernel(const int8_t* __restrict__ table,
                        const float* __restrict__ wscale,
                        const int8_t* __restrict__ queries,
                        const float* __restrict__ qscale,
                        const uint8_t* __restrict__ mask,
                        const int32_t* __restrict__ exclude,
                        const float* __restrict__ head, int32_t* __restrict__ out,
                        int n, int d, int top_r) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* qs = reinterpret_cast<int8_t*>(smem);   // [d]
  int8_t* tile = qs + d;                          // [kGroup][kStride]
  __shared__ int red[2][kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = blockIdx.x;
  const int q = blockIdx.y;
  const int row0 = g * kGroup;

  for (int i = t; i < d / 16; i += kThreads)
    reinterpret_cast<int4*>(qs)[i] = __ldg(reinterpret_cast<const int4*>(queries + (size_t)q * d) + i);

  int acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0;

  for (int d0 = 0; d0 < d; d0 += kChunk) {
    const int width = min(kChunk, d - d0);
    const int units = width / 16;           // 16-byte units per row
    __syncthreads();  // previous chunk fully consumed (and qs written)
    for (int u = t; u < kGroup * units; u += kThreads) {
      const int r = u / units;
      const int c = (u - r * units) * 16;
      const int row = row0 + r;
      const int4 v = row < n
          ? __ldg(reinterpret_cast<const int4*>(table + (size_t)row * d + d0 + c))
          : make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(tile + r * kStride + c) = v;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int8_t* trow = tile + (t + r * kThreads) * kStride;
      for (int c = 0; c < width; c += 16)
        acc[r] = dot16(*reinterpret_cast<const int4*>(trow + c),
                       *reinterpret_cast<const int4*>(qs + d0 + c), acc[r]);
    }
  }

  // Scores -> packed keys, kept in registers.
  const int excl = exclude != nullptr ? exclude[q] : -1;
  const float qsc = qscale[q];
  const float bias = __fdiv_rn(2.f, qsc);
  int key[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int local = t + r * kThreads;
    const int row = row0 + local;
    const bool row_ok = row < n && (mask == nullptr || mask[row] != 0);
    const float ws = row < n ? wscale[row] : 0.f;
    key[r] = int8_key(acc[r], ws, qsc, bias, head, row_ok && row != excl, local);
  }

  // top_r rounds of block-wide max with knock-out (keys are unique within a
  // group: the low 9 bits are the lane).
  int32_t* dst = out + ((size_t)q * gridDim.x + g) * top_r;
  for (int j = 0; j < top_r; ++j) {
    const int buf = j & 1;
    int m = key[0];
#pragma unroll
    for (int r = 1; r < kRowsPerThread; ++r) m = max(m, key[r]);
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) red[buf][warp] = m;
    __syncthreads();
    m = red[buf][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = max(m, red[buf][w]);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
      if (key[r] == m) key[r] = kIntMin;
    if (t == 0) dst[j] = m;
  }
}

cudaError_t launch_dp4a(const int8_t* table, const float* wscale, const int8_t* queries,
                        const float* qscale, const uint8_t* mask, const int32_t* exclude,
                        const float* head, int32_t* out, int n, int d, int nq, int top_r,
                        cudaStream_t stream) {
  const dim3 grid((n + kGroup - 1) / kGroup, nq);
  const size_t smem = (size_t)d + (size_t)kGroup * kStride;
  const cudaError_t err = scan::allow_smem<packed_topk_int8_kernel>(smem);
  if (err != cudaSuccess) return err;
  packed_topk_int8_kernel<<<grid, kThreads, smem, stream>>>(table, wscale, queries, qscale, mask,
                                                             exclude, head, out, n, d, top_r);
  return cudaGetLastError();
}

// ---- from kMmaMinQ: the int8 tensor cores ----------------------------------------

constexpr int kBigThreads = 512;     // 16 warps, 32 table rows (4 n-tiles of 8) each
constexpr int kWarpRows = kGroup / (kBigThreads / 32);
constexpr int kNT = kWarpRows / 8;   // n-tiles per warp
constexpr int kKeyStride = 520;      // keys row stride: 8-byte epilogue stores hit 32 banks
constexpr int kKStep = 64;           // dimensions per B load: 16 bytes a lane, 4 lanes a row

int sm_count() {   // as exact_topk.cu's
  static const int sms = [] {
    int dev = 0, v = 132;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      v = 132;
    return v;
  }();
  return sms;
}

// The queries that share one read of the table: 1 below kMmaMinQ (dp4a);
// then 16 (one m-tile; 64 registers, two blocks an SM) or 64 (four m-tiles
// share each B fragment; one block an SM). Up to 16 queries both give one
// block a group, and two blocks an SM take a grid of more groups than SMs
// in fewer waves (the 91,641-row user table: 179 groups); past 16 queries
// the 64-query tile, unless its grid leaves SMs idle (the 17,560-row anime
// table: 35 groups). tools/scan_kernels.py --time sweep --variant
// int8_tile16|int8_tile64 timed both tiles at 2 to 256 queries on an H100:
// the rule takes the faster tile but at 256 queries over the anime table
// (140 blocks of 64 queries, 20 % slower than 16-query tiles there).
int query_tile(int n, int nq) {
  if (nq < kMmaMinQ) return 1;
  const int groups = (n + kGroup - 1) / kGroup;
  const bool short_grid = groups * ((nq + 63) / 64) <= sm_count();
  return (nq <= 16) != short_grid ? 16 : 64;
}

// Query row stride (bytes) in shared memory for a tile of min(d,
// scan::kQueryDims) dimensions: at least the tile's width rounded up to 64
// (the last chunk's lanes past d read inside the row), and 64 more than a
// multiple of 128, so that the 16-byte A loads of a quarter warp (queries
// gid and gid + 1, 64 bytes each) fill the 32 banks once.
__host__ __device__ __forceinline__ int big_qstride(int d) {
  const int w = d < scan::kQueryDims ? d : scan::kQueryDims;
  return ((w + 63) & ~127) + 64;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// kQT queries per block (kQT / 16 m-tiles). kWide: d may pass
// scan::kQueryDims, so the queries are staged in several passes; without it
// the one pass is fixed at compile time.
template <int kQT, bool kWide>
__global__ void __launch_bounds__(kBigThreads, kQT == 16 ? 2 : 1)
packed_topk_int8_mma_kernel(const int8_t* __restrict__ table,
                            const float* __restrict__ wscale,
                            const int8_t* __restrict__ queries,
                            const float* __restrict__ qscale,
                            const uint8_t* __restrict__ mask,
                            const int32_t* __restrict__ exclude,
                            const float* __restrict__ head, int32_t* __restrict__ out,
                            int n, int d, int nq_total, int top_r) {
  constexpr int kMT = kQT / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  int* keys = reinterpret_cast<int*>(smem);                                        // [kQT][520]
  int8_t* qs = reinterpret_cast<int8_t*>(smem + kQT * kKeyStride * sizeof(int));  // [kQT][qstride]
  __shared__ int excl[kQT];
  __shared__ float qsc[kQT], bias[kQT];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int tiles = (nq_total + kQT - 1) / kQT;   // scan_common.cuh's grid
  const int g = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - g * tiles) * kQT;
  const int nq = min(kQT, nq_total - q0);
  const int row0 = g * kGroup;
  const int wrow0 = warp * kWarpRows;      // the warp's first row in the group
  const int qstride = big_qstride(d);

  // The lane's accumulator rows, wrow0 + nt * 8 + 2 tig + h: their mask
  // bytes and row scales are read before the product, their latency hidden
  // by it.
  unsigned live = 0;   // bit 2 nt + h
  float ws[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wrow0 + nt * 8 + 2 * tig + h;
      ws[nt][h] = row < n ? __ldg(wscale + row) : 0.f;
      if (row < n && (mask == nullptr || mask[row] != 0)) live |= 1u << (2 * nt + h);
    }
  if (t < kQT) {
    excl[t] = (exclude != nullptr && t < nq) ? exclude[q0 + t] : -1;
    const float s = t < nq ? qscale[q0 + t] : 1.f;
    qsc[t] = s;
    bias[t] = __fdiv_rn(2.f, s);
  }

  // The lane's B rows, wrow0 + nt * 8 + gid: 16 bytes of each from byte 16 tig
  // of a 64-dimension chunk.
  const int mtiles = (nq + 15) / 16;
  const int8_t* wp = table + (size_t)(row0 + wrow0 + gid) * d + 16 * tig;
  unsigned wok = 0;   // bit nt: row wrow0 + nt * 8 + gid < n
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
    if (row0 + wrow0 + nt * 8 + gid < n) wok |= 1u << nt;
  // B fragments of dims [c, c + 64) of the lane's rows; zeros past d.
  auto load_b = [&](int c, int width, uint4 (&w)[kNT]) {
    const bool kok = c + 16 * tig < width;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      w[nt] = (kok && (wok >> nt & 1u))
                  ? __ldg(reinterpret_cast<const uint4*>(wp + (size_t)nt * 8 * d + c))
                  : make_uint4(0u, 0u, 0u, 0u);
  };
  int c[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0;

  // The queries' dims [s0, s0 + width) into the shared tile, then their product.
  for (int s0 = 0; s0 < (kWide ? d : 1); s0 += scan::kQueryDims) {
    const int width = kWide ? min(scan::kQueryDims, d - s0) : d;
    if (s0 > 0) __syncthreads();   // every warp is done with the previous dims
    uint4 w[kNT];
    load_b(s0, s0 + width, w);
    scan::stage_queries<kQT, kBigThreads>(queries + s0, d, width, q0, nq,
                                            [&](int q, int cq, uint4 v) {
                                              *reinterpret_cast<uint4*>(qs + q * qstride + cq) = v;
                                            });
    __syncthreads();
    for (int c0 = 0; c0 < width; c0 += kKStep) {
      uint4 next[kNT];
      if (c0 + kKStep < width) load_b(s0 + c0 + kKStep, s0 + width, next);
      // Lanes whose 16 bytes lie past d take zeros, in A and B alike.
      const bool kok = c0 + 16 * tig < width;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (mt >= mtiles) break;
        const int8_t* xq = qs + (mt * 16 + gid) * qstride + c0 + 16 * tig;
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        const uint4 xa = kok ? *reinterpret_cast<const uint4*>(xq) : zero;
        const uint4 xb = kok ? *reinterpret_cast<const uint4*>(xq + 8 * qstride) : zero;
        // k32 step 1 takes bytes 0-7 of each lane's 16, step 2 bytes 8-15: logical
        // k = 4 tig + i is byte i, k = 16 + 4 tig + i byte 4 + i (of 8), in A and B.
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          mma_s8(c[mt][nt], xa.x, xb.x, xa.y, xb.y, w[nt].x, w[nt].y);
          mma_s8(c[mt][nt], xa.z, xb.z, xa.w, xb.w, w[nt].z, w[nt].w);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) w[nt] = next[nt];
    }
  }

  // Accumulator e of (mt, nt): query mt * 16 + gid (+ 8 for e >= 2), row
  // wrow0 + nt * 8 + 2 tig (+ 1 for odd e); the row pair goes out as one
  // 8-byte store.
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    if (mt >= mtiles) break;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = mt * 16 + gid + 8 * h;
        const int local = wrow0 + nt * 8 + 2 * tig;
        int2 pair;
        pair.x = int8_key(c[mt][nt][2 * h], ws[nt][0], qsc[q], bias[q], head,
                          (live >> (2 * nt) & 1u) && row0 + local != excl[q], local);
        pair.y = int8_key(c[mt][nt][2 * h + 1], ws[nt][1], qsc[q], bias[q], head,
                          (live >> (2 * nt + 1) & 1u) && row0 + local + 1 != excl[q], local + 1);
        *reinterpret_cast<int2*>(keys + q * kKeyStride + local) = pair;
      }
  }
  __syncthreads();
  const size_t ncols = (size_t)((n + kGroup - 1) / kGroup) * top_r;
  for (int q = warp; q < nq; q += kBigThreads / 32)
    scan::warp_top_keys(keys + q * kKeyStride, top_r,
                        out + (size_t)(q0 + q) * ncols + (size_t)g * top_r, lane);
}

template <int kQT, bool kWide>
cudaError_t launch_mma(const int8_t* table, const float* wscale, const int8_t* queries,
                       const float* qscale, const uint8_t* mask, const int32_t* exclude,
                       const float* head, int32_t* out, int n, int d, int nq, int top_r,
                       cudaStream_t stream) {
  const dim3 grid((unsigned)scan::grid_blocks(n, nq, kQT));
  const size_t smem = (size_t)kQT * kKeyStride * sizeof(int) + (size_t)kQT * big_qstride(d);
  static_assert(kQT * kKeyStride * sizeof(int) + kQT * (scan::kQueryDims + 64) <= kMaxSmem,
                "any d fits");
  auto kernel = packed_topk_int8_mma_kernel<kQT, kWide>;
  const cudaError_t err = scan::allow_smem<packed_topk_int8_mma_kernel<kQT, kWide>>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBigThreads, smem, stream>>>(table, wscale, queries, qscale, mask, exclude,
                                              head, out, n, d, nq, top_r);
  return cudaGetLastError();
}

template <int kQT>
cudaError_t launch_tile(const int8_t* table, const float* wscale, const int8_t* queries,
                        const float* qscale, const uint8_t* mask, const int32_t* exclude,
                        const float* head, int32_t* out, int n, int d, int nq, int top_r,
                        cudaStream_t s) {
  if (d > scan::kQueryDims)
    return launch_mma<kQT, true>(table, wscale, queries, qscale, mask, exclude, head, out, n, d,
                                 nq, top_r, s);
  return launch_mma<kQT, false>(table, wscale, queries, qscale, mask, exclude, head, out, n, d,
                                nq, top_r, s);
}

}  // namespace

// table: int8 [n, d] with f32 row scales wscale [n]; queries: int8 [nq, d]
// with f32 scales qscale [nq]. mask (uint8 [n], nonzero keeps), exclude
// (int32 [nq], -1 = none) and head (f32 [2]: alpha, beta) may be null. d must
// be a multiple of 16 (table and queries 16-byte aligned), 1 <= top_r <= 512,
// the grid must fit (scan::grid_fits; one query a block row of the
// one-query branch, nq <= 65535 there), and out must hold nq * ceil(n / 512)
// * top_r int32.
// From kMmaMinQ queries the tensor-core branch runs. Returns a cudaError_t.
extern "C" int packed_topk_int8(const int8_t* table, const float* wscale,
                                const int8_t* queries, const float* qscale,
                                const uint8_t* mask, const int32_t* exclude,
                                const float* head, int32_t* out, int n, int d,
                                int nq, int top_r, void* stream) {
  if (n <= 0 || nq <= 0 || d <= 0 || d % 16 != 0 || top_r < 1 || top_r > kGroup ||
      !scan::grid_fits(n, nq, 1) || (query_tile(n, nq) == 1 && nq > 65535))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (query_tile(n, nq)) {
    case 1:
      return (int)launch_dp4a(table, wscale, queries, qscale, mask, exclude, head, out, n, d,
                              nq, top_r, s);
    case 16:
      return (int)launch_tile<16>(table, wscale, queries, qscale, mask, exclude, head, out, n,
                                  d, nq, top_r, s);
    default:
      return (int)launch_tile<64>(table, wscale, queries, qscale, mask, exclude, head, out, n,
                                  d, nq, top_r, s);
  }
}

// The query tile packed_topk_int8 takes for n rows and nq queries (1, 16 or
// 64): the table is read once per tile.
extern "C" int packed_topk_int8_query_tile(int n, int nq) { return query_tile(n, nq); }
