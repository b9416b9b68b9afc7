// L2 row normalization of an embedding table (ops/normalize.py), hand-written
// for Hopper.
//
// Replaces: anime_recommendations_tpu/ops/normalize.py::_normalize_kernel.
//
// What it computes, for every row x of an f32 [n, d] table:
//   sq  = sum(x * x)                       f32
//   out = x * rsqrt(max(sq, eps))          f32, stored as f32 or bf16 (to
//                                          nearest even)
// so a zero row stays zero. rsqrtf is not correctly rounded (2 ulp), so the
// result differs from the plain torch version by a few f32 ulp.
//
// Bound on the H100: pure streaming, 2 flops per element read. The user
// table (91,641 x 128 f32) is 46.9 MB read and 46.9 MB (f32) or 23.5 MB
// (bf16) written: ~28 us (f32) or ~21 us (bf16) at 3.35 TB/s.
//
// Design: one warp per row, 8 rows per 256-thread block. Each lane loads
// 16 bytes at a time (at d = 128 one float4 per lane: a row is one fully
// coalesced 512-byte read), the sum of squares is a butterfly of warp
// shuffles so every lane holds it, and each lane scales and stores the
// values it still holds in registers. Rows wider than 512 values re-read
// the rest from L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kCached = 4;  // float4s a lane keeps in registers (d <= 512)

__device__ __forceinline__ void store4(float* out, float4 v) {
  *reinterpret_cast<float4*>(out) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out) = raw;
}

__device__ __forceinline__ float sumsq4(float4 v) {
  return v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(__fmul_rn(v.x, s), __fmul_rn(v.y, s), __fmul_rn(v.z, s),
                     __fmul_rn(v.w, s));
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
l2_normalize_kernel(const float* __restrict__ table, Out* __restrict__ out,
                    int n, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps leave together
  const int d4 = d / 4;
  const float4* src = reinterpret_cast<const float4*>(table + (size_t)row * d);
  Out* dst = out + (size_t)row * d;

  float4 v[kCached];
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kCached; ++j) {
    const int c = lane + j * 32;
    v[j] = c < d4 ? __ldg(src + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    sq += sumsq4(v[j]);
  }
  for (int c = lane + kCached * 32; c < d4; c += 32) sq += sumsq4(__ldg(src + c));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  const float inv = rsqrtf(fmaxf(sq, eps));

#pragma unroll
  for (int j = 0; j < kCached; ++j) {
    const int c = lane + j * 32;
    if (c < d4) store4(dst + 4 * c, scale4(v[j], inv));
  }
  for (int c = lane + kCached * 32; c < d4; c += 32)
    store4(dst + 4 * c, scale4(__ldg(src + c), inv));
}

}  // namespace

// table: f32 [n, d], 16-byte aligned, d % 4 == 0. out: [n, d] f32
// (out_dtype 0) or bf16 (out_dtype 1). Returns a cudaError_t (0 on success).
extern "C" int l2_normalize(const float* table, void* out, int out_dtype, int n,
                            int d, float eps, void* stream) {
  if (n <= 0 || d <= 0 || d % 4 != 0 || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    l2_normalize_kernel<float><<<grid, kThreads, 0, s>>>(
        table, static_cast<float*>(out), n, d, eps);
  else
    l2_normalize_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        table, static_cast<__nv_bfloat16*>(out), n, d, eps);
  return (int)cudaGetLastError();
}
