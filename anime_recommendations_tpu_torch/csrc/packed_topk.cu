// Stage 1 of the two-stage masked top-k (ops/topk.py), hand-written for Hopper.
//
// Replaces: anime_recommendations_tpu/ops/topk.py::_packed_topk_kernel with
// _extract_groups (the float variant: f32 or bf16 tables, with and without
// the sigmoid head, mask and per-query exclude).
//
// What it computes, for every query q and every 512-row group g of the table:
//   s    = <query_q, row>                      fp32 accumulation
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
// Bound on the H100: the scan reads the table once per query tile (16.8 MB
// per read for the 17,560 x 128 f32 anime table, 46.9 MB for the 91,641 x 128
// f32 user table) and does 2 * 128 flops per row and query, so at serving
// query counts it is memory-bound by a wide margin.
//
// Design, right and simple first:
//   * one block per (512-row group, tile of up to QT queries); 256 threads,
//     each owning 2 rows of the group, so a row's 8 (QT = 8) keys stay in
//     registers from the dot product through the extraction;
//   * the group's rows are staged through shared memory 16 dimensions at a
//     time with coalesced 16-byte loads; the query tile sits in shared
//     memory as fp32 and is read by broadcast;
//   * extraction is top_r rounds of a block-wide max (warp __reduce_max_sync,
//     then the 8 warp maxima through double-buffered shared memory, so one
//     barrier per round); keys are unique within a group (the low 9 bits are
//     the lane), so the one thread holding the max knocks it out.
// The table is re-read once per query tile: at Q = 256 that is 32 reads.
// Reading it once for all queries (and wgmma/TMA for the product) is the
// first thing to make faster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 512;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kGroup / kThreads;  // 2
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;             // table dimensions staged per step
constexpr int kStride = kChunk + 4;    // padded smem row stride (floats)
constexpr int kLaneMask = kGroup - 1;
constexpr int kIntMin = -2147483647 - 1;

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int QT>
__global__ void __launch_bounds__(kThreads)
packed_topk_kernel(const T* __restrict__ table, const T* __restrict__ queries,
                   const uint8_t* __restrict__ mask,
                   const int32_t* __restrict__ exclude,
                   const float* __restrict__ head, int32_t* __restrict__ out,
                   int n, int d, int nq_total, int top_r) {
  extern __shared__ float smem[];
  float* tile = smem;                       // [kGroup][kStride]
  float* qs = smem + kGroup * kStride;      // [QT][d]
  __shared__ int red[2][kWarps][QT];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const int nq = min(QT, nq_total - q0);
  const int row0 = g * kGroup;

  for (int i = t; i < QT * d; i += kThreads) {
    const int q = i / d;
    qs[i] = q < nq ? to_float(queries[(size_t)(q0 + q) * d + (i - q * d)]) : 0.f;
  }

  float acc[kRowsPerThread][QT];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int q = 0; q < QT; ++q) acc[r][q] = 0.f;

  constexpr int kUnitsPerRow = kChunk / 4;
  for (int d0 = 0; d0 < d; d0 += kChunk) {
    __syncthreads();  // previous chunk fully consumed (and qs written)
    for (int u = t; u < kGroup * kUnitsPerRow; u += kThreads) {
      const int r = u / kUnitsPerRow;
      const int c = (u - r * kUnitsPerRow) * 4;
      const int row = row0 + r;
      const float4 v = row < n ? load4(table + (size_t)row * d + d0 + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(tile + r * kStride + c) = v;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const float* trow = tile + (t + r * kThreads) * kStride;
#pragma unroll
      for (int c = 0; c < kChunk; c += 4) {
        const float4 w = *reinterpret_cast<const float4*>(trow + c);
#pragma unroll
        for (int q = 0; q < QT; ++q) {
          const float4 x = *reinterpret_cast<const float4*>(qs + q * d + d0 + c);
          acc[r][q] = fmaf(w.x, x.x, acc[r][q]);
          acc[r][q] = fmaf(w.y, x.y, acc[r][q]);
          acc[r][q] = fmaf(w.z, x.z, acc[r][q]);
          acc[r][q] = fmaf(w.w, x.w, acc[r][q]);
        }
      }
    }
  }

  // Scores -> packed keys, kept in registers.
  int excl[QT];
#pragma unroll
  for (int q = 0; q < QT; ++q)
    excl[q] = (exclude != nullptr && q < nq) ? exclude[q0 + q] : -1;
  const float alpha = head != nullptr ? head[0] : 0.f;
  const float beta = head != nullptr ? head[1] : 0.f;
  int key[kRowsPerThread][QT];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int local = t + r * kThreads;
    const int row = row0 + local;
    const bool row_ok = row < n && (mask == nullptr || mask[row] != 0);
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      float s = acc[r][q];
      if (head != nullptr) s = 1.f / (1.f + expf(-(alpha * s + beta)));
      const float s2 = (row_ok && row != excl[q]) ? s + 2.f : -1.f;
      key[r][q] = (__float_as_int(s2) & ~kLaneMask) | local;
    }
  }

  // top_r rounds of block-wide max with knock-out.
  const int ncols = gridDim.x * top_r;
  for (int j = 0; j < top_r; ++j) {
    const int buf = j & 1;
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      int m = key[0][q];
#pragma unroll
      for (int r = 1; r < kRowsPerThread; ++r) m = max(m, key[r][q]);
      m = __reduce_max_sync(0xffffffffu, m);
      if (lane == 0) red[buf][warp][q] = m;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      int m = red[buf][0][q];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m = max(m, red[buf][w][q]);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
        if (key[r][q] == m) key[r][q] = kIntMin;
      if (t == q && q < nq) out[(size_t)(q0 + q) * ncols + g * top_r + j] = m;
    }
  }
}

template <typename T, int QT>
cudaError_t launch(const void* table, const void* queries, const uint8_t* mask,
                   const int32_t* exclude, const float* head, int32_t* out,
                   int n, int d, int nq, int top_r, cudaStream_t stream) {
  const int n_groups = (n + kGroup - 1) / kGroup;
  const dim3 grid(n_groups, (nq + QT - 1) / QT);
  const size_t smem = (size_t)(kGroup * kStride + QT * d) * sizeof(float);
  auto kernel = packed_topk_kernel<T, QT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(table), static_cast<const T*>(queries), mask,
      exclude, head, out, n, d, nq, top_r);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (table and queries share it). mask
// (uint8 [n], nonzero keeps), exclude (int32 [nq], -1 = none) and head
// (float32 [2]: alpha, beta) may be null. d must be a multiple of 16, 1 <=
// top_r <= 512, and out must hold nq * ceil(n / 512) * top_r int32. Returns a
// cudaError_t (0 on success).
extern "C" int packed_topk(const void* table, int dtype, const void* queries,
                           const uint8_t* mask, const int32_t* exclude,
                           const float* head, int32_t* out, int n, int d,
                           int nq, int top_r, void* stream) {
  if (n <= 0 || nq <= 0 || d <= 0 || d % kChunk != 0 || top_r < 1 ||
      top_r > kGroup || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = nq == 1 ? launch<float, 1>(table, queries, mask, exclude, head, out, n, d, nq, top_r, s)
                  : launch<float, 8>(table, queries, mask, exclude, head, out, n, d, nq, top_r, s);
  else
    err = nq == 1 ? launch<__nv_bfloat16, 1>(table, queries, mask, exclude, head, out, n, d, nq, top_r, s)
                  : launch<__nv_bfloat16, 8>(table, queries, mask, exclude, head, out, n, d, nq, top_r, s);
  return (int)err;
}
