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
// plain torch version (ops/topk.py::_packed_candidates_plain) takes them
// (__fmul_rn / __fadd_rn keep nvcc from contracting them into an FMA), and
// acc is exact, so the keys without a head equal the plain version's bit for
// bit. With a head, expf may differ from torch's by an ulp.
//
// Bound on the H100: the int8 user table is 11.7 MB (+0.37 MB of wscale),
// which fits the 50 MB L2, so after its first read the scan is bound by the
// dp4a products and the extraction, not by HBM.
//
// Design, right and simple first (the shape of packed_topk.cu): one block
// per (512-row group, tile of up to QT queries), 256 threads each owning 2
// rows of the group; the group's rows are staged through shared memory 128
// dimensions at a time with coalesced 16-byte loads (rows padded by 16 bytes
// so the per-thread 16-byte reads are free of bank conflicts); __dp4a into
// int32 accumulators held in registers; then top_r rounds of block-wide max
// with knock-out. The table is re-read per query tile; one read for all
// queries, and wgmma on int8, are for a later PR.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 512;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kGroup / kThreads;  // 2
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;            // table dimensions staged per step (bytes)
constexpr int kStride = kChunk + 16;   // padded smem row stride (bytes)
constexpr int kLaneMask = kGroup - 1;
constexpr int kIntMin = -2147483647 - 1;

__device__ __forceinline__ int dot16(const int4 a, const int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

template <int QT>
__global__ void __launch_bounds__(kThreads)
packed_topk_int8_kernel(const int8_t* __restrict__ table,
                        const float* __restrict__ wscale,
                        const int8_t* __restrict__ queries,
                        const float* __restrict__ qscale,
                        const uint8_t* __restrict__ mask,
                        const int32_t* __restrict__ exclude,
                        const float* __restrict__ head, int32_t* __restrict__ out,
                        int n, int d, int nq_total, int top_r) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* qs = smem;                        // [QT][d]
  int8_t* tile = smem + QT * d;             // [kGroup][kStride]
  __shared__ int red[2][kWarps][QT];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const int nq = min(QT, nq_total - q0);
  const int row0 = g * kGroup;

  for (int i = t; i < QT * d / 16; i += kThreads) {
    const int q = (i * 16) / d;
    const int4 v = q < nq ? __ldg(reinterpret_cast<const int4*>(queries + (size_t)q0 * d) + i)
                          : make_int4(0, 0, 0, 0);
    reinterpret_cast<int4*>(qs)[i] = v;
  }

  int acc[kRowsPerThread][QT];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int q = 0; q < QT; ++q) acc[r][q] = 0;

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
      for (int c = 0; c < width; c += 16) {
        const int4 w = *reinterpret_cast<const int4*>(trow + c);
#pragma unroll
        for (int q = 0; q < QT; ++q)
          acc[r][q] = dot16(w, *reinterpret_cast<const int4*>(qs + q * d + d0 + c), acc[r][q]);
      }
    }
  }

  // Scores -> packed keys, kept in registers.
  int excl[QT];
  float qsc[QT], bias[QT];
#pragma unroll
  for (int q = 0; q < QT; ++q) {
    excl[q] = (exclude != nullptr && q < nq) ? exclude[q0 + q] : -1;
    qsc[q] = q < nq ? qscale[q0 + q] : 1.f;
    bias[q] = __fdiv_rn(2.f, qsc[q]);
  }
  const float alpha = head != nullptr ? head[0] : 0.f;
  const float beta = head != nullptr ? head[1] : 0.f;
  int key[kRowsPerThread][QT];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int local = t + r * kThreads;
    const int row = row0 + local;
    const bool row_ok = row < n && (mask == nullptr || mask[row] != 0);
    const float ws = row < n ? wscale[row] : 0.f;
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      const float a = __int2float_rn(acc[r][q]);
      float s2;
      if (head != nullptr) {
        const float s = __fmul_rn(__fmul_rn(a, qsc[q]), ws);
        const float z = __fadd_rn(__fmul_rn(alpha, s), beta);
        s2 = __fadd_rn(1.f / (1.f + expf(-z)), 2.f);
      } else {
        s2 = __fadd_rn(__fmul_rn(a, ws), bias[q]);
      }
      if (!row_ok || row == excl[q]) s2 = -1.f;
      key[r][q] = (__float_as_int(s2) & ~kLaneMask) | local;
    }
  }

  // top_r rounds of block-wide max with knock-out (keys are unique within a
  // group: the low 9 bits are the lane).
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

template <int QT>
cudaError_t launch(const int8_t* table, const float* wscale, const int8_t* queries,
                   const float* qscale, const uint8_t* mask, const int32_t* exclude,
                   const float* head, int32_t* out, int n, int d, int nq, int top_r,
                   cudaStream_t stream) {
  const int n_groups = (n + kGroup - 1) / kGroup;
  const dim3 grid(n_groups, (nq + QT - 1) / QT);
  const size_t smem = (size_t)QT * d + (size_t)kGroup * kStride;
  auto kernel = packed_topk_int8_kernel<QT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(table, wscale, queries, qscale, mask,
                                           exclude, head, out, n, d, nq, top_r);
  return cudaGetLastError();
}

}  // namespace

// table: int8 [n, d] with f32 row scales wscale [n]; queries: int8 [nq, d]
// with f32 scales qscale [nq]. mask (uint8 [n], nonzero keeps), exclude
// (int32 [nq], -1 = none) and head (f32 [2]: alpha, beta) may be null. d must
// be a multiple of 16 (table and queries 16-byte aligned), 1 <= top_r <= 512,
// and out must hold nq * ceil(n / 512) * top_r int32. Returns a cudaError_t.
extern "C" int packed_topk_int8(const int8_t* table, const float* wscale,
                                const int8_t* queries, const float* qscale,
                                const uint8_t* mask, const int32_t* exclude,
                                const float* head, int32_t* out, int n, int d,
                                int nq, int top_r, void* stream) {
  if (n <= 0 || nq <= 0 || d <= 0 || d % 16 != 0 || top_r < 1 || top_r > kGroup)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(nq == 1
      ? launch<1>(table, wscale, queries, qscale, mask, exclude, head, out, n, d, nq, top_r, s)
      : launch<8>(table, wscale, queries, qscale, mask, exclude, head, out, n, d, nq, top_r, s));
}
