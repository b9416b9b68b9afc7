// Worst-case-exact single-stage masked top-k (ops/topk.py, exact_scan=True),
// hand-written for Hopper.
//
// Replaces: anime_recommendations_tpu/ops/topk.py::_topk_kernel (entry
// _exact_scan_topk).
//
// What it computes, for every query q and every 512-row chunk of the table:
//   s = <query_q, row>                         full f32: fmaf over f32 values
//                                              (bf16 tables widened to f32)
//   s = sigmoid(alpha * s + beta)              if a head is given
//   the row is dead when masked, excluded or >= n
// and emits the chunk's exact top kc = min(k, 512) live rows as (score, row)
// pairs, best first, ties to the lower row, then (-1e30, -1) sentinels once
// the chunk's live rows run out. Output: f32 scores and int32 rows, each
// [Q, n_chunks * kc], query-major, chunk c's pairs at [c * kc, (c + 1) * kc).
// The caller merges the n_chunks * kc candidates of each query with a
// stable descending sort: the layout is in row order between chunks, so
// ties keep the lower row across chunks too.
//
// Each live row carries a 64-bit key: the order-preserving uint32 of its
// score above 0xFFFFFFFF - row, so a max over keys is also the tie-break
// (dead rows are key 0). When k >= 512 every row of the chunk is emitted in
// row order with no extraction.
//
// The TPU kernel skips a block when no score beats the running k-th best
// of the blocks before it, which needs its sequential grid. Here blocks run
// in no order, so every chunk extracts; the skip (per block, or a second
// pass) is perf work that changes no result.
//
// Bound on the H100: the f32 user table (91,641 x 128) is 46.9 MB per read,
// ~14 us at 3.35 TB/s; the table is re-read once per 8-query tile, and each
// extraction round is a block-wide reduction per query, so at k of tens the
// rounds, not the bytes, set the time.
//
// Design: the score phase is packed_topk.cu's (one block per (512-row
// chunk, tile of up to QT queries), 256 threads each owning 2 rows, rows
// staged through shared memory 16 dimensions at a time with coalesced
// 16-byte loads, the query tile in shared memory as f32). Extraction: kc
// rounds of a 64-bit max (warp shuffles, then the 8 warp maxima through
// double-buffered shared memory, one barrier per round); the one thread that
// holds the max knocks it out.

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
constexpr float kNeg = -1e30f;         // dead-slot score

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

// Order-preserving map of a (non-NaN) float to uint32, and back.
__device__ __forceinline__ uint32_t ordered(float s) {
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

template <typename T, int QT>
__global__ void __launch_bounds__(kThreads)
exact_topk_kernel(const T* __restrict__ table, const T* __restrict__ queries,
                  const uint8_t* __restrict__ mask,
                  const int32_t* __restrict__ exclude,
                  const float* __restrict__ head, float* __restrict__ out_s,
                  int32_t* __restrict__ out_i, int n, int d, int nq_total, int kc) {
  extern __shared__ float smem[];
  float* tile = smem;                       // [kGroup][kStride]
  float* qs = smem + kGroup * kStride;      // [QT][d]
  __shared__ unsigned long long red[2][kWarps][QT];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int c = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const int nq = min(QT, nq_total - q0);
  const int row0 = c * kGroup;

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
      const int col = (u - r * kUnitsPerRow) * 4;
      const int row = row0 + r;
      const float4 v = row < n ? load4(table + (size_t)row * d + d0 + col)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(tile + r * kStride + col) = v;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const float* trow = tile + (t + r * kThreads) * kStride;
#pragma unroll
      for (int col = 0; col < kChunk; col += 4) {
        const float4 w = *reinterpret_cast<const float4*>(trow + col);
#pragma unroll
        for (int q = 0; q < QT; ++q) {
          const float4 x = *reinterpret_cast<const float4*>(qs + q * d + d0 + col);
          acc[r][q] = fmaf(w.x, x.x, acc[r][q]);
          acc[r][q] = fmaf(w.y, x.y, acc[r][q]);
          acc[r][q] = fmaf(w.z, x.z, acc[r][q]);
          acc[r][q] = fmaf(w.w, x.w, acc[r][q]);
        }
      }
    }
  }

  // Scores -> 64-bit keys (0 = dead), kept in registers.
  int excl[QT];
#pragma unroll
  for (int q = 0; q < QT; ++q)
    excl[q] = (exclude != nullptr && q < nq) ? exclude[q0 + q] : -1;
  const float alpha = head != nullptr ? head[0] : 0.f;
  const float beta = head != nullptr ? head[1] : 0.f;
  unsigned long long key[kRowsPerThread][QT];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = row0 + t + r * kThreads;
    const bool row_ok = row < n && (mask == nullptr || mask[row] != 0);
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      float s = acc[r][q];
      if (head != nullptr)
        s = 1.f / (1.f + expf(-__fadd_rn(__fmul_rn(alpha, s), beta)));
      s = __fadd_rn(s, 0.f);  // -0 -> +0: equal scores tie on the row alone
      key[r][q] = (row_ok && row != excl[q])
          ? ((unsigned long long)ordered(s) << 32) | (0xffffffffu - (uint32_t)row)
          : 0ull;
    }
  }

  const int ncols = gridDim.x * kc;
  if (kc == kGroup) {
    // The chunk's every row is a candidate: emit them in row order.
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      if (q >= nq) break;
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const size_t o = (size_t)(q0 + q) * ncols + c * kc + t + r * kThreads;
        const unsigned long long m = key[r][q];
        out_s[o] = m ? unordered((uint32_t)(m >> 32)) : kNeg;
        out_i[o] = m ? row0 + t + r * kThreads : -1;
      }
    }
    return;
  }

  // kc rounds of block-wide max with knock-out (live keys are unique: the
  // low 32 bits carry the row).
  for (int j = 0; j < kc; ++j) {
    const int buf = j & 1;
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      unsigned long long m = key[0][q];
#pragma unroll
      for (int r = 1; r < kRowsPerThread; ++r) m = max(m, key[r][q]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) red[buf][warp][q] = m;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      unsigned long long m = red[buf][0][q];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m = max(m, red[buf][w][q]);
      if (m != 0) {
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          if (key[r][q] == m) key[r][q] = 0ull;
      }
      if (t == q && q < nq) {
        const size_t o = (size_t)(q0 + q) * ncols + c * kc + j;
        out_s[o] = m ? unordered((uint32_t)(m >> 32)) : kNeg;
        out_i[o] = m ? (int32_t)(0xffffffffu - (uint32_t)m) : -1;
      }
    }
  }
}

template <typename T, int QT>
cudaError_t launch(const void* table, const void* queries, const uint8_t* mask,
                   const int32_t* exclude, const float* head, float* out_s,
                   int32_t* out_i, int n, int d, int nq, int kc, cudaStream_t stream) {
  const int n_chunks = (n + kGroup - 1) / kGroup;
  const dim3 grid(n_chunks, (nq + QT - 1) / QT);
  const size_t smem = (size_t)(kGroup * kStride + QT * d) * sizeof(float);
  auto kernel = exact_topk_kernel<T, QT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(table), static_cast<const T*>(queries), mask,
      exclude, head, out_s, out_i, n, d, nq, kc);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (table and queries share it). mask
// (uint8 [n], nonzero keeps), exclude (int32 [nq], -1 = none) and head
// (float32 [2]: alpha, beta) may be null. d must be a multiple of 16, 1 <=
// kc <= 512, and out_s / out_i must each hold nq * ceil(n / 512) * kc
// values. Returns a cudaError_t (0 on success).
extern "C" int exact_topk(const void* table, int dtype, const void* queries,
                          const uint8_t* mask, const int32_t* exclude,
                          const float* head, float* out_s, int32_t* out_i, int n,
                          int d, int nq, int kc, void* stream) {
  if (n <= 0 || nq <= 0 || d <= 0 || d % kChunk != 0 || kc < 1 || kc > kGroup ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = nq == 1 ? launch<float, 1>(table, queries, mask, exclude, head, out_s, out_i, n, d, nq, kc, s)
                  : launch<float, 8>(table, queries, mask, exclude, head, out_s, out_i, n, d, nq, kc, s);
  else
    err = nq == 1 ? launch<__nv_bfloat16, 1>(table, queries, mask, exclude, head, out_s, out_i, n, d, nq, kc, s)
                  : launch<__nv_bfloat16, 8>(table, queries, mask, exclude, head, out_s, out_i, n, d, nq, kc, s);
  return (int)err;
}
