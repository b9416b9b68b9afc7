// Worst-case-exact single-stage masked top-k (ops/topk.py, exact_scan=True),
// hand-written for Hopper.
//
// Replaces: anime_recommendations_tpu/ops/topk.py::_topk_kernel (entry
// _exact_scan_topk).
//
// What it computes, for every query q and every 512-row chunk of the table:
//   s = <query_q, row>                         full f32: fmaf over f32 values
//                                              in dimension order (bf16
//                                              tables widened to f32)
//   s = sigmoid(alpha * s + beta)              if a head is given
//   the row is dead when masked, excluded or >= n
// and emits the chunk's exact top kc = min(k, 512) live rows as (score, row)
// pairs, best first, ties to the lower row, then (-1e30, -1) sentinels once
// the chunk's live rows run out. Output: f32 scores and int32 rows, each
// [Q, n_chunks * kc], query-major, chunk c's pairs at [c * kc, (c + 1) * kc).
// The caller merges the n_chunks * kc candidates of each query with a
// stable descending sort: the layout is in row order between chunks, so
// ties keep the lower row across chunks too. When k >= 512 every row of the
// chunk is emitted in row order with no extraction.
//
// The TPU kernel skips a block when no score beats the running k-th best
// of the blocks before it, which needs its sequential grid. Here blocks run
// in no order, so every chunk extracts; the skip (per block, or a second
// pass) is perf work that changes no result.
//
// Bound on the H100: reading the f32 user table (91,641 x 128) once is
// 46.9 MB, ~14 us at 3.35 TB/s; at Q queries the scores are 2 * 128 * Q
// f32 flops per row on the CUDA cores (67 TFLOP/s), which passes the bytes
// from Q of about 8 (Q = 256: 90 us). So small Q is bound by bytes and
// large Q by f32 operations, and both want the table read once per large
// query tile with few shared-memory loads per fmaf.
//
// Design (the score phase is scan_common.cuh's, shared with packed_topk.cu):
// one block per (512-row chunk, tile of 1, 8 or 32 queries), the query tiles
// of a chunk adjacent in the grid so they share its rows through L2; the
// chunk streamed through a cp.async double buffer of 16-dimension slabs;
// register microtiles of 2 rows x 1 or 8 queries (256 threads) or, for the
// 32-query tile, 8 rows x 8 queries (4 shared-memory loads of 16 bytes per
// 64 fmaf); the queries staged scan::kQueryDims dimensions at a time, so
// every D % 16 == 0 fits in shared memory. The 32-query tile is taken only
// when the grid still gives every SM two blocks (query_tile;
// tools/scan_kernels.py --time sweep timed both tiles at 9 to 256 queries
// on an H100: the rule picks the faster tile, or one within 5 % of it).
// Extraction: the chunk's scores go to shared memory as ordered uint32 keys
// (0 = dead), and one warp per query takes kc rounds of a warp max of the
// lanes' best scores and a warp min of the tied lanes' positions (the lower
// row wins a tie), with no block barrier.

#include "scan_common.cuh"

namespace {

using scan::kGroup;
constexpr int kMaxSmem = 232448;   // a block's dynamic shared memory on an H100
constexpr float kNeg = -1e30f;     // dead-slot score

template <typename T, int RPT, int QPT, int QG>
__global__ void __launch_bounds__(scan::Tile<T, RPT, QPT, QG>::kThreads, 2)
exact_topk_kernel(const T* __restrict__ table, const T* __restrict__ queries,
                  const uint8_t* __restrict__ mask, const int32_t* __restrict__ exclude,
                  const float* __restrict__ head, float* __restrict__ out_s,
                  int32_t* __restrict__ out_i, int n, int d, int nq_total, int kc) {
  using S = scan::Tile<T, RPT, QPT, QG>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int tiles = (nq_total + S::kQT - 1) / S::kQT;   // scan_common.cuh's grid
  const int c = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - c * tiles) * S::kQT;
  const int nq = min(S::kQT, nq_total - q0);
  const int row0 = c * kGroup;
  const int rg = t % S::kRowThreads;
  const int qg = t / S::kRowThreads;

  // Mask, exclude and head are read before the scan, their latency hidden by it.
  unsigned row_ok = 0;   // bit i: row rg + kRowThreads * i is in the table and kept
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = row0 + rg + S::kRowThreads * i;
    if (row < n && (mask == nullptr || mask[row] != 0)) row_ok |= 1u << i;
  }
  int excl[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int q = qg * QPT + j;
    excl[j] = (exclude != nullptr && q < nq) ? exclude[q0 + q] : -1;
  }
  const float alpha = head != nullptr ? head[0] : 0.f;
  const float beta = head != nullptr ? head[1] : 0.f;

  float acc[RPT][QPT];
  scan::score_group<T, RPT, QPT, QG>(table, queries, n, d, nq_total, q0, row0, smem, acc);

  // Scores -> ordered uint32 keys (0 = dead) in the ring's place.
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);   // [kQT][512]
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int local = rg + S::kRowThreads * i;
    const int row = row0 + local;
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      float s = acc[i][j];
      if (head != nullptr)
        s = 1.f / (1.f + expf(-__fadd_rn(__fmul_rn(alpha, s), beta)));
      s = __fadd_rn(s, 0.f);  // -0 -> +0: equal scores tie on the row alone
      keys[(qg * QPT + j) * kGroup + local] =
          ((row_ok >> i & 1u) && row != excl[j]) ? scan::ordered(s) : 0u;
    }
  }
  __syncthreads();

  const size_t ncols = (size_t)((n + kGroup - 1) / kGroup) * kc;
  if (kc == kGroup) {
    // The chunk's every row is a candidate: emit them in row order.
    for (int p = t; p < nq * kGroup; p += S::kThreads) {
      const int q = p / kGroup;
      const int local = p - q * kGroup;
      const uint32_t key = keys[p];
      const size_t o = (size_t)(q0 + q) * ncols + (size_t)c * kc + local;
      out_s[o] = key ? scan::unordered(key) : kNeg;
      out_i[o] = key ? row0 + local : -1;
    }
    return;
  }
  for (int q = t >> 5; q < nq; q += S::kThreads / 32) {
    const size_t o = (size_t)(q0 + q) * ncols + (size_t)c * kc;
    scan::warp_top_exact(keys + q * kGroup, kc, row0, out_s + o, out_i + o, t & 31);
  }
}

template <typename T, int RPT, int QPT, int QG>
cudaError_t launch(const void* table, const void* queries, const uint8_t* mask,
                   const int32_t* exclude, const float* head, float* out_s, int32_t* out_i,
                   int n, int d, int nq, int kc, cudaStream_t stream) {
  using S = scan::Tile<T, RPT, QPT, QG>;
  const dim3 grid((unsigned)scan::grid_blocks(n, nq, S::kQT));
  static_assert(S::kRingBytes + S::kQT * (scan::kQueryDims + 4) * 4 <= kMaxSmem, "any d fits");
  const size_t smem = S::smem_bytes(d);
  const cudaError_t err = scan::allow_smem<exact_topk_kernel<T, RPT, QPT, QG>>(smem);
  if (err != cudaSuccess) return err;
  exact_topk_kernel<T, RPT, QPT, QG><<<grid, S::kThreads, smem, stream>>>(
      static_cast<const T*>(table), static_cast<const T*>(queries), mask, exclude, head,
      out_s, out_i, n, d, nq, kc);
  return cudaGetLastError();
}

int sm_count() {
  static const int sms = [] {
    int dev = 0, v = 132;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      v = 132;
    return v;
  }();
  return sms;
}

// The query tile: 1 query alone; else 32 when that still gives every SM two
// blocks (the 8 x 8 microtile needs 4 shared-memory loads per 64 fmaf, the
// 2 x 8 one 10 per 64), and 8 when the grid would be too small for the card
// (the 17,560-row anime table has 35 chunks).
int query_tile(int n, int nq) {
  if (nq == 1) return 1;
  const int chunks = (n + kGroup - 1) / kGroup;
  return nq > 8 && chunks * ((nq + 31) / 32) >= 2 * sm_count() ? 32 : 8;
}

template <typename T>
cudaError_t launch_for(const void* table, const void* queries, const uint8_t* mask,
                       const int32_t* exclude, const float* head, float* out_s, int32_t* out_i,
                       int n, int d, int nq, int kc, cudaStream_t s) {
  switch (query_tile(n, nq)) {
    case 1:
      return launch<T, 2, 1, 1>(table, queries, mask, exclude, head, out_s, out_i, n, d, nq, kc, s);
    case 8:
      return launch<T, 2, 8, 1>(table, queries, mask, exclude, head, out_s, out_i, n, d, nq, kc, s);
    default:
      return launch<T, 8, 8, 4>(table, queries, mask, exclude, head, out_s, out_i, n, d, nq, kc, s);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (table and queries share it). mask
// (uint8 [n], nonzero keeps), exclude (int32 [nq], -1 = none) and head
// (float32 [2]: alpha, beta) may be null. d must be a multiple of 16, 1 <=
// kc <= 512, the grid must fit (scan::grid_fits), and out_s / out_i must each hold nq *
// ceil(n / 512) * kc values; any such d fits (scan::kQueryDims). Returns a
// cudaError_t (0 on success).
extern "C" int exact_topk(const void* table, int dtype, const void* queries,
                          const uint8_t* mask, const int32_t* exclude,
                          const float* head, float* out_s, int32_t* out_i, int n,
                          int d, int nq, int kc, void* stream) {
  if (n <= 0 || nq <= 0 || d <= 0 || d % scan::kSlab != 0 || kc < 1 || kc > kGroup ||
      !scan::grid_fits(n, nq, 1) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_for<float>(table, queries, mask, exclude, head, out_s, out_i, n, d, nq, kc, s);
  return (int)launch_for<__nv_bfloat16>(table, queries, mask, exclude, head, out_s, out_i, n, d,
                                        nq, kc, s);
}

// The query tile exact_topk takes for n rows and nq queries (1, 8 or 32):
// the table is read once per tile.
extern "C" int exact_topk_query_tile(int n, int nq) { return query_tile(n, nq); }
