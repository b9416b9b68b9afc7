// Stage 1 of the two-stage masked top-k (ops/topk.py), hand-written for Hopper.
//
// Replaces: anime_recommendations_tpu/ops/topk.py::_packed_topk_kernel with
// _extract_groups (the float variant: f32 or bf16 tables, with and without
// the sigmoid head, mask and per-query exclude).
//
// What it computes, for every query q and every 512-row group g of the table:
//   s    = <query_q, row>                      f32 accumulation
//   s    = sigmoid(alpha * s + beta)           if a head is given
//   s2   = s + 2                               > 0 for every in-contract score
//   s2   = -1                                  masked, excluded, or row >= n
//   key  = (bits(s2) & ~511) | (row & 511)     int order == score order; a
//                                              key <= 0 is dead
// and keeps the top_r largest keys of the group, largest first. Output is
// int32 [Q, n_groups * top_r], query-major, group g's keys at
// [g * top_r, (g + 1) * top_r). Rows are rebuilt from (position, key low
// bits) by the caller.
//
// Two branches: one query streams, more than one take the tensor cores
// (ops/topk.py's TF32_MIN_Q = 2 is the same rule). On an H100 (700 W)
// tools/scan_kernels.py --time sweep timed the tensor-core branch at least
// as fast as the streaming one from 2 queries up, f32 and bf16 (PERF.md).
//
// One query (similar_anime, similar_users, model_recs, ...) is bound by
// bytes: 46.9 MB for the 91,641 x 128 f32 user table, 14 us at 3.35 TB/s,
// against 2 * 128 flops per row. The streaming branch keeps bytes in
// flight: one block per (512-row group, query), the group streamed through
// scan_common.cuh's cp.async double buffer (32 KB in flight per block, two
// blocks per SM, one barrier pair per 16 dimensions), each thread owning 2
// rows in registers (fmaf over f32; bf16 widened). The keys then go to
// shared memory and one warp extracts the group's top_r with warp
// reductions: no block barrier per round.
//
// From 2 queries (batch endpoints, model_recs_batch) the product grows with
// Q while the bytes do not: 6 GFLOP at Q = 256 over the user table. The
// tensor-core branch: one block per (512-row group, 64-query tile), the
// query tiles of a group adjacent in the grid so they share its rows
// through L2; the product with mma.sync, bf16 x bf16 for bf16 tables, TF32
// (operands rounded to nearest, ties away, as cvt.rna.tf32.f32) for f32
// tables, f32 accumulation. The queries are the M side (4 m16 tiles, from
// the shared query tile, staged scan::kQueryDims dimensions at a time so
// that every D % 16 == 0 fits) and the table rows the N side: each of 16 warps
// owns 32 rows of the group and loads their B fragments straight from
// device memory (16 bytes a lane, each table element read by one thread;
// the k index is permuted so a lane's 4 consecutive dimensions feed one
// fragment, the A fragments use the same permutation), so no barrier
// stands in the product and each 16-byte shared load feeds 4 mma. Epilogue:
// accumulators -> head, bias, mask, exclude -> packed keys in shared memory
// -> one warp per query extracts, as above.
// TF32 is within the JAX contract: its stage 1 runs at DEFAULT precision,
// one bf16 pass even for f32 tables, and stage 2 rescores the pool in f32.

#include "scan_common.cuh"

namespace {

using scan::kGroup;
constexpr int kLaneMask = kGroup - 1;
constexpr int kMaxSmem = 232448;   // a block's dynamic shared memory on an H100

// ---- shared: scores -> packed keys --------------------------------------------

__device__ __forceinline__ int pack_key(float s, bool live, int local, const float* head) {
  if (head != nullptr) s = 1.f / (1.f + expf(-(head[0] * s + head[1])));
  const float s2 = live ? s + 2.f : -1.f;
  return (__float_as_int(s2) & ~kLaneMask) | local;
}

// ---- below the threshold: scan_common.cuh's ring and microtiles --------------

template <typename T>
__global__ void __launch_bounds__(256, 2)
packed_topk_kernel(const T* __restrict__ table, const T* __restrict__ queries,
                   const uint8_t* __restrict__ mask, const int32_t* __restrict__ exclude,
                   const float* __restrict__ head, int32_t* __restrict__ out,
                   int n, int d, int nq_total, int top_r) {
  using S = scan::Tile<T, 2, 1, 1>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int g = blockIdx.x / nq_total;   // one query per block (scan_common.cuh's grid)
  const int q = blockIdx.x - g * nq_total;
  const int n_groups = (n + kGroup - 1) / kGroup;
  const int row0 = g * kGroup;

  // Mask and exclude are read before the scan, their latency hidden by it.
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + t + S::kRowThreads * i;
    row_ok[i] = row < n && (mask == nullptr || mask[row] != 0);
  }
  const int excl = exclude != nullptr ? exclude[q] : -1;

  float acc[2][1];
  scan::score_group<T, 2, 1, 1>(table, queries, n, d, nq_total, q, row0, smem, acc);

  int* keys = reinterpret_cast<int*>(smem);   // [512], in the ring's place
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int local = t + S::kRowThreads * i;
    keys[local] = pack_key(acc[i][0], row_ok[i] && row0 + local != excl, local, head);
  }
  __syncthreads();
  if (t < 32)
    scan::warp_top_keys(keys, top_r, out + ((size_t)q * n_groups + g) * top_r, t);
}

template <typename T>
cudaError_t launch_small(const void* table, const void* queries, const uint8_t* mask,
                         const int32_t* exclude, const float* head, int32_t* out, int n, int d,
                         int nq, int top_r, cudaStream_t stream) {
  using S = scan::Tile<T, 2, 1, 1>;
  const dim3 grid((unsigned)scan::grid_blocks(n, nq, 1));
  static_assert(S::kRingBytes + S::kQT * (scan::kQueryDims + 4) * 4 <= kMaxSmem, "any d fits");
  const size_t smem = S::smem_bytes(d);
  auto kernel = packed_topk_kernel<T>;
  const cudaError_t err = scan::allow_smem<packed_topk_kernel<T>>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, S::kThreads, smem, stream>>>(
      static_cast<const T*>(table), static_cast<const T*>(queries), mask, exclude, head, out,
      n, d, nq, top_r);
  return cudaGetLastError();
}

// ---- at or above the threshold: the tensor cores --------------------------------

constexpr int kBigQ = 64;            // queries per block: 4 m-tiles of 16
constexpr int kBigThreads = 512;     // 16 warps, 32 table rows (4 n-tiles of 8) each
constexpr int kWarpRows = kGroup / (kBigThreads / 32);
constexpr int kKeyStride = 520;      // keys row stride: 8-byte epilogue stores hit 32 banks
constexpr int kChunks = 2;           // 16-dim chunks whose B fragments load together

// Query row stride (elements) in shared memory for a tile of min(d,
// scan::kQueryDims) dimensions: an odd multiple of 16, so
// the A-fragment loads of a quarter warp (f32, 16 bytes a lane: queries gid
// 0 and 1 half a bank cycle apart) or a half warp (bf16, 8 bytes: queries
// gid 0-3 a quarter apart) hit distinct banks.
__host__ __device__ __forceinline__ int big_qstride(int d) {
  const int w = d < scan::kQueryDims ? d : scan::kQueryDims;
  return (w & 16) ? w : w + 16;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 4 consecutive elements of one table row as B-fragment words: f32 -> 4
// TF32 words; bf16 -> 2 words of 2 bf16 each (w[2], w[3] unused).
__device__ __forceinline__ void load_frag(const float* p, bool ok, uint32_t (&w)[4]) {
  const float4 v = ok ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
  w[0] = tf32(v.x); w[1] = tf32(v.y); w[2] = tf32(v.z); w[3] = tf32(v.w);
}

__device__ __forceinline__ void load_frag(const __nv_bfloat16* p, bool ok, uint32_t (&w)[4]) {
  const uint2 v = ok ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0u, 0u);
  w[0] = v.x; w[1] = v.y; w[2] = 0u; w[3] = 0u;
}

// One 16-dim chunk of the 16-query x 8-row tile c += Q . W^T. Lane (gid =
// lane / 4, tig = lane % 4) holds dims 4 tig .. 4 tig + 3 of queries gid
// (xa) and gid + 8 (xb), from shared memory, and of table row gid (w). f32:
// two m16n8k8 steps; in step s logical k = tig takes dim 4 tig + 2 s and
// k = tig + 4 dim 4 tig + 2 s + 1, in A and B alike. bf16: one m16n8k16
// step; logical k pair (2 tig, 2 tig + 1) takes dims (4 tig, 4 tig + 1) and
// (2 tig + 8, 2 tig + 9) takes (4 tig + 2, 4 tig + 3).
__device__ __forceinline__ void chunk_mma(float (&c)[4], const float* xq, int qstride,
                                          const uint32_t (&w)[4]) {
  const uint4 xa = *reinterpret_cast<const uint4*>(xq);
  const uint4 xb = *reinterpret_cast<const uint4*>(xq + 8 * qstride);
  mma_tf32(c, xa.x, xb.x, xa.y, xb.y, w[0], w[1]);
  mma_tf32(c, xa.z, xb.z, xa.w, xb.w, w[2], w[3]);
}

__device__ __forceinline__ void chunk_mma(float (&c)[4], const __nv_bfloat16* xq, int qstride,
                                          const uint32_t (&w)[4]) {
  const uint2 xa = *reinterpret_cast<const uint2*>(xq);
  const uint2 xb = *reinterpret_cast<const uint2*>(xq + 8 * qstride);
  mma_bf16(c, xa.x, xb.x, xa.y, xb.y, w[0], w[1]);
}

// 16 bytes of queries into the shared tile: f32 rounded to TF32 once here,
// bf16 as they are.
__device__ __forceinline__ void store_query(float* dst, uint4 v) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(tf32(__uint_as_float(v.x)), tf32(__uint_as_float(v.y)),
                                              tf32(__uint_as_float(v.z)), tf32(__uint_as_float(v.w)));
}

__device__ __forceinline__ void store_query(__nv_bfloat16* dst, uint4 v) {
  *reinterpret_cast<uint4*>(dst) = v;
}

// kWide: d may pass scan::kQueryDims, so the queries are staged in several
// passes. Without it (every d <= kQueryDims) the one pass is fixed at compile
// time: the loop's registers cost the f32 kernel a 12-byte spill and 3-7 %
// of its time at d = 128 on an H100 (PERF.md).
template <typename T, bool kWide>
__global__ void __launch_bounds__(kBigThreads)
packed_topk_mma_kernel(const T* __restrict__ table, const T* __restrict__ queries,
                       const uint8_t* __restrict__ mask, const int32_t* __restrict__ exclude,
                       const float* __restrict__ head, int32_t* __restrict__ out,
                       int n, int d, int nq_total, int top_r) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* keys = reinterpret_cast<int*>(smem);                                  // [64][520]
  T* qs = reinterpret_cast<T*>(smem + kBigQ * kKeyStride * sizeof(int));    // [64][qstride]
  __shared__ int excl[kBigQ];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int tiles = (nq_total + kBigQ - 1) / kBigQ;   // scan_common.cuh's grid
  const int g = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - g * tiles) * kBigQ;
  const int nq = min(kBigQ, nq_total - q0);
  const int row0 = g * kGroup;
  const int wrow0 = warp * kWarpRows;      // the warp's first row in the group
  const int qstride = big_qstride(d);

  // The lane's table rows: wrow0 + nt * 8 + gid (its B fragments) and, in
  // the accumulators, wrow0 + nt * 8 + 2 tig + {0, 1}; the latter's mask
  // bytes are read before the product, their latency hidden by it.
  unsigned live = 0;   // bit 2 nt + h: row wrow0 + nt * 8 + 2 tig + h
#pragma unroll
  for (int nt = 0; nt < kWarpRows / 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wrow0 + nt * 8 + 2 * tig + h;
      if (row < n && (mask == nullptr || mask[row] != 0)) live |= 1u << (2 * nt + h);
    }
  if (t < kBigQ) excl[t] = (exclude != nullptr && t < nq) ? exclude[q0 + t] : -1;

  const int mtiles = (nq + 15) / 16;
  const T* wp[kWarpRows / 8];
  bool wok[kWarpRows / 8];
#pragma unroll
  for (int nt = 0; nt < kWarpRows / 8; ++nt) {
    const int row = row0 + wrow0 + nt * 8 + gid;
    wok[nt] = row < n;
    wp[nt] = table + (size_t)(wok[nt] ? row : 0) * d + 4 * tig;
  }
  const T* xq = qs + gid * qstride + 4 * tig;
  float c[kBigQ / 16][kWarpRows / 8][4];
#pragma unroll
  for (int mt = 0; mt < kBigQ / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < kWarpRows / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0.f;

  // The queries' dims [s0, s0 + width) into the shared tile, then their product.
  for (int s0 = 0; s0 < (kWide ? d : 1); s0 += scan::kQueryDims) {
    const int width = kWide ? min(scan::kQueryDims, d - s0) : d;
    if (s0 > 0) __syncthreads();   // every warp is done with the previous dims
    scan::stage_queries<kBigQ, kBigThreads>(queries + s0, d, width, q0, nq,
                                            [&](int q, int c, uint4 v) {
                                              store_query(qs + q * qstride + c, v);
                                            });
    __syncthreads();
    for (int c0 = 0; c0 < width; c0 += 16 * kChunks) {
      uint32_t w[kChunks][kWarpRows / 8][4];
#pragma unroll
      for (int u = 0; u < kChunks; ++u)
#pragma unroll
        for (int nt = 0; nt < kWarpRows / 8; ++nt)
          load_frag(wp[nt] + s0 + c0 + 16 * u, wok[nt] && c0 + 16 * u < width, w[u][nt]);
#pragma unroll
      for (int u = 0; u < kChunks; ++u) {
        if (c0 + 16 * u >= width) break;
#pragma unroll
        for (int mt = 0; mt < kBigQ / 16; ++mt) {
          if (mt >= mtiles) break;
#pragma unroll
          for (int nt = 0; nt < kWarpRows / 8; ++nt)
            chunk_mma(c[mt][nt], xq + mt * 16 * qstride + c0 + 16 * u, qstride, w[u][nt]);
        }
      }
    }
  }

  // Accumulator e of (mt, nt): query mt * 16 + gid (+ 8 for e >= 2), row
  // wrow0 + nt * 8 + 2 tig (+ 1 for odd e); the row pair goes out as one
  // 8-byte store.
#pragma unroll
  for (int mt = 0; mt < kBigQ / 16; ++mt) {
    if (mt >= mtiles) break;
#pragma unroll
    for (int nt = 0; nt < kWarpRows / 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = mt * 16 + gid + 8 * h;
        const int local = wrow0 + nt * 8 + 2 * tig;
        int2 pair;
        pair.x = pack_key(c[mt][nt][2 * h], (live >> (2 * nt) & 1u) && row0 + local != excl[q],
                          local, head);
        pair.y = pack_key(c[mt][nt][2 * h + 1],
                          (live >> (2 * nt + 1) & 1u) && row0 + local + 1 != excl[q], local + 1,
                          head);
        *reinterpret_cast<int2*>(keys + q * kKeyStride + local) = pair;
      }
  }
  __syncthreads();
  const size_t ncols = (size_t)((n + kGroup - 1) / kGroup) * top_r;
  for (int q = warp; q < nq; q += kBigThreads / 32)
    scan::warp_top_keys(keys + q * kKeyStride, top_r,
                        out + (size_t)(q0 + q) * ncols + (size_t)g * top_r, lane);
}

template <typename T, bool kWide>
cudaError_t launch_big(const void* table, const void* queries, const uint8_t* mask,
                       const int32_t* exclude, const float* head, int32_t* out, int n, int d,
                       int nq, int top_r, cudaStream_t stream) {
  const dim3 grid((unsigned)scan::grid_blocks(n, nq, kBigQ));
  const size_t smem = (size_t)kBigQ * kKeyStride * sizeof(int) +
                      (size_t)kBigQ * big_qstride(d) * sizeof(T);
  static_assert(kBigQ * kKeyStride * sizeof(int) + kBigQ * (scan::kQueryDims + 16) * sizeof(T) <=
                    kMaxSmem, "any d fits");
  auto kernel = packed_topk_mma_kernel<T, kWide>;
  const cudaError_t err = scan::allow_smem<packed_topk_mma_kernel<T, kWide>>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBigThreads, smem, stream>>>(
      static_cast<const T*>(table), static_cast<const T*>(queries), mask, exclude, head, out,
      n, d, nq, top_r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* table, const void* queries, const uint8_t* mask,
                   const int32_t* exclude, const float* head, int32_t* out, int n, int d,
                   int nq, int top_r, cudaStream_t s) {
  if (nq > 1 && d > scan::kQueryDims)
    return launch_big<T, true>(table, queries, mask, exclude, head, out, n, d, nq, top_r, s);
  if (nq > 1)
    return launch_big<T, false>(table, queries, mask, exclude, head, out, n, d, nq, top_r, s);
  return launch_small<T>(table, queries, mask, exclude, head, out, n, d, nq, top_r, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (table and queries share it). mask
// (uint8 [n], nonzero keeps), exclude (int32 [nq], -1 = none) and head
// (float32 [2]: alpha, beta) may be null. d must be a multiple of 16, 1 <=
// top_r <= 512, the grid must fit (scan::grid_fits: n < 2^31 - 512, groups
// times query tiles < 2^31), and out must hold nq * ceil(n / 512) * top_r
// int32. nq > 1 takes the tensor-core branch (TF32 products for f32
// tables). Every such d fits in shared memory (scan::kQueryDims). Returns a cudaError_t (0 on success).
extern "C" int packed_topk(const void* table, int dtype, const void* queries,
                           const uint8_t* mask, const int32_t* exclude,
                           const float* head, int32_t* out, int n, int d,
                           int nq, int top_r, void* stream) {
  if (n <= 0 || nq <= 0 || d <= 0 || d % scan::kSlab != 0 || top_r < 1 ||
      top_r > kGroup || !scan::grid_fits(n, nq, 1) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(table, queries, mask, exclude, head, out, n, d, nq, top_r, s);
  return (int)launch<__nv_bfloat16>(table, queries, mask, exclude, head, out, n, d, nq, top_r, s);
}
