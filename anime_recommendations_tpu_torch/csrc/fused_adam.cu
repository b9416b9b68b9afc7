// Fused sparse-gradient scatter + L2 decay + Adam update (ops/fused_adam.py),
// hand-written for Hopper, and its variant that also gathers the next
// batch's rows out of the updated table.
//
// Replaces: anime_recommendations_tpu/ops/fused_adam.py::_fused_adam_kernel
// with its stochastic rounding _sr_store (bf16 moments) -> fused_adam, and
// ::_fused_adam_gather_kernel -> fused_adam_gather.
//
// What it computes, for a table W [n, d] f32 and moments mu, nu [n, d] (f32,
// or bf16 when they are stored in half the bytes), given the batch's row ids
// sorted ascending (int32 [B]) and their gradients in the same order (f32
// [B, d]):
//   dscat  = sum of the gradient rows whose id == r    (exact f32, in order)
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
// The gather adds only its output (5.1 MB for 10,000 next rows of 128): the
// rows are copied out of the block the update just wrote, which is in L1/L2.
//
// Design, right and simple first:
//   * one block per 32 table rows, 256 threads; a thread owns one float4
//     of a row (a warp covers one 128-wide row) and walks 4 of them;
//   * the block's slice of the sorted ids, [starts[b], starts[b+1]), comes
//     from the wrapper (torch.searchsorted); one thread per row finds the
//     row's run in it by binary search into shared memory, and each thread
//     sums its columns over the run in sorted order, 8 loads in flight: no
//     float atomics, so the result is deterministic;
//   * the table is not padded: every read and write is bounded at row n, and
//     ids outside [0, n) lie outside every block's slice;
//   * the update is one device function (adam_block) that both kernels run,
//     so fused_adam_gather's tables equal fused_adam's bit for bit;
//   * the gather: after a __syncthreads() the block's own updated rows are
//     visible to all its threads; one warp copies one next row (float4 per
//     lane) from W' to its original position, from the wrapper's stable
//     argsort of the next ids ([gstarts[b], gstarts[b+1]) is the block's
//     slice), so no un-sort follows. A block reads only rows it updated
//     itself: another block's rows may not be updated yet. Next ids outside
//     [0, n) sort before gstarts[0] or after gstarts[nb]; the first and the
//     last block write their zero rows.
// Ways to make it faster are for later: cp.async/TMA staging of the W, mu,
// nu tiles, more bytes in flight per thread, and a split of hot rows' runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;       // table rows per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPipe = 8;        // gradient rows in flight per thread

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

__device__ __forceinline__ float4 load_moment(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load_moment(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

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

// First position in [lo, hi) of the sorted ids whose id >= key.
__device__ __forceinline__ int lower_bound(const int32_t* ids, int lo, int hi, int key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ids + mid) < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The update of block blockIdx.x's rows [row0, min(row0 + 32, n)) and its
// sumsq partial. Ends after a __syncthreads() that follows every W' store.
template <typename M>
__device__ __forceinline__ void adam_block(float* __restrict__ w, M* __restrict__ mu,
                                           M* __restrict__ nu, const int32_t* __restrict__ ids,
                                           const float* __restrict__ grads,
                                           const int32_t* __restrict__ starts,
                                           float* __restrict__ partials, int n, int d,
                                           const Scalars& s, int sr, uint32_t step) {
  __shared__ int run_lo[kRows];
  __shared__ int run_hi[kRows];
  __shared__ float warp_sums[kWarps];

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  if (t < kRows) {
    const int seg_lo = starts[blockIdx.x];
    const int seg_hi = starts[blockIdx.x + 1];
    const int lo = lower_bound(ids, seg_lo, seg_hi, row0 + t);
    run_lo[t] = lo;
    run_hi[t] = lower_bound(ids, lo, seg_hi, row0 + t + 1);
  }
  __syncthreads();

  const float two_l2 = __fmul_rn(2.f, s.l2);
  const float omb1 = __fsub_rn(1.f, s.b1);
  const float omb2 = __fsub_rn(1.f, s.b2);
  const bool use_sr = sr != 0;
  const uint32_t seed_mu = mix32(2u * step);
  const uint32_t seed_nu = mix32(2u * step + 1u);
  const int d4 = d >> 2;
  float sq = 0.f;
  for (int e = t; e < kRows * d4; e += kThreads) {
    const int r = e / d4;
    const int row = row0 + r;
    if (row >= n) break;  // e only grows: every later row is past n too
    const int c = (e - r * d4) * 4;
    const size_t off = (size_t)row * d + c;

    // A hot row's run is long, and one row at a time it is bound by load
    // latency: keep kPipe loads in flight, then add them in order, so the
    // sum is still the sequential one.
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* gc = grads + c;
    int j = run_lo[r];
    const int j_end = run_hi[r];
    for (; j + kPipe <= j_end; j += kPipe) {
      float4 v[kPipe];
#pragma unroll
      for (int u = 0; u < kPipe; ++u)
        v[u] = __ldg(reinterpret_cast<const float4*>(gc + (size_t)(j + u) * d));
#pragma unroll
      for (int u = 0; u < kPipe; ++u) acc = add4(acc, v[u]);
    }
    for (; j < j_end; ++j)
      acc = add4(acc, __ldg(reinterpret_cast<const float4*>(gc + (size_t)j * d)));

    float4 wv = *reinterpret_cast<const float4*>(w + off);
    sq = fmaf(wv.x, wv.x, sq);
    sq = fmaf(wv.y, wv.y, sq);
    sq = fmaf(wv.z, wv.z, sq);
    sq = fmaf(wv.w, wv.w, sq);
    float4 m = load_moment(mu + off);
    float4 v = load_moment(nu + off);
    adam(acc.x, wv.x, m.x, v.x, s, two_l2, omb1, omb2);
    adam(acc.y, wv.y, m.y, v.y, s, two_l2, omb1, omb2);
    adam(acc.z, wv.z, m.z, v.z, s, two_l2, omb1, omb2);
    adam(acc.w, wv.w, m.w, v.w, s, two_l2, omb1, omb2);
    *reinterpret_cast<float4*>(w + off) = wv;
    store_moment(mu + off, m, use_sr, mix32(seed_mu + (uint32_t)row) + (uint32_t)c);
    store_moment(nu + off, v, use_sr, mix32(seed_nu + (uint32_t)row) + (uint32_t)c);
  }

  // One sumsq partial per block.
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if ((t & 31) == 0) warp_sums[t >> 5] = sq;
  __syncthreads();
  if (t == 0) {
    float total = 0.f;
    for (int i = 0; i < kWarps; ++i) total += warp_sums[i];
    partials[blockIdx.x] = total;
  }
}

template <typename M>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(float* __restrict__ w, M* __restrict__ mu, M* __restrict__ nu,
                  const int32_t* __restrict__ ids, const float* __restrict__ grads,
                  const int32_t* __restrict__ starts, float* __restrict__ partials,
                  int n, int d, Scalars s, int sr, uint32_t step) {
  adam_block<M>(w, mu, nu, ids, grads, starts, partials, n, d, s, sr, step);
}

// Copies d floats (d % 4 == 0), one float4 per lane of a warp, or zeros them
// when src is null.
__device__ __forceinline__ void warp_copy_row(float* dst, const float* src, int d, int lane) {
  for (int c = lane * 4; c < d; c += 128) {
    const float4 v = src ? *reinterpret_cast<const float4*>(src + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + c) = v;
  }
}

template <typename M>
__global__ void __launch_bounds__(kThreads)
fused_adam_gather_kernel(float* __restrict__ w, M* __restrict__ mu, M* __restrict__ nu,
                         const int32_t* __restrict__ ids, const float* __restrict__ grads,
                         const int32_t* __restrict__ starts, float* __restrict__ partials,
                         const int32_t* __restrict__ nids, const int32_t* __restrict__ norder,
                         const int32_t* __restrict__ gstarts, float* __restrict__ rows_out,
                         int n_next, int n, int d, Scalars s, int sr, uint32_t step) {
  adam_block<M>(w, mu, nu, ids, grads, starts, partials, n, d, s, sr, step);
  // Read after write: every W' store of this block precedes the barrier, so
  // the plain (coherent, not __ldg) loads below see the updated rows.
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g_lo = gstarts[blockIdx.x];
  const int g_hi = gstarts[blockIdx.x + 1];
  for (int j = g_lo + warp; j < g_hi; j += kWarps)
    warp_copy_row(rows_out + (size_t)norder[j] * d, w + (size_t)nids[j] * d, d, lane);
  // Next ids below 0 sort before gstarts[0], ids >= n after gstarts[nb].
  if (blockIdx.x == 0)
    for (int j = warp; j < g_lo; j += kWarps)
      warp_copy_row(rows_out + (size_t)norder[j] * d, nullptr, d, lane);
  if (blockIdx.x == gridDim.x - 1)
    for (int j = gstarts[gridDim.x] + warp; j < n_next; j += kWarps)
      warp_copy_row(rows_out + (size_t)norder[j] * d, nullptr, d, lane);
}

int check_args(int n, int d, int block_rows, int moment_dtype) {
  if (n <= 0 || d <= 0 || d % 4 != 0 || block_rows != kRows ||
      (moment_dtype != 0 && moment_dtype != 1))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// moment_dtype: 0 = float32, 1 = bfloat16 (mu and nu share it). ids (int32
// [B], ascending) and grads (f32 [B, d], same order) may be null when B = 0.
// starts (int32 [nb + 1], nb = ceil(n / block_rows)) holds where each block's
// rows [b * block_rows, min((b + 1) * block_rows, n)) begin in the sorted ids,
// and partials (f32 [nb]) receives one sumsq partial per block. block_rows
// must be 32 and d a multiple of 4; W, mu, nu and grads must be 16-byte
// aligned (8-byte for bf16 moments). sr != 0 rounds bf16 moments
// stochastically. Updates W, mu and nu in place. Returns a cudaError_t
// (0 on success).
extern "C" int fused_adam(float* w, void* mu, void* nu, int moment_dtype,
                          const int32_t* ids, const float* grads,
                          const int32_t* starts, float* partials, int n, int d,
                          int block_rows, float lr, float bc1, float bc2, float eps,
                          float l2, float b1, float b2, int sr, unsigned int step,
                          void* stream) {
  if (const int err = check_args(n, d, block_rows, moment_dtype)) return err;
  const Scalars s{lr, bc1, bc2, eps, l2, b1, b2};
  const dim3 grid((n + kRows - 1) / kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (moment_dtype == 0)
    fused_adam_kernel<float><<<grid, kThreads, 0, st>>>(
        w, static_cast<float*>(mu), static_cast<float*>(nu), ids, grads, starts,
        partials, n, d, s, 0, step);
  else
    fused_adam_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        w, static_cast<__nv_bfloat16*>(mu), static_cast<__nv_bfloat16*>(nu), ids,
        grads, starts, partials, n, d, s, sr, step);
  return (int)cudaGetLastError();
}

// fused_adam, plus rows_out (f32 [n_next, d], 16-byte aligned) = W'[next id]
// for each next id. nids (int32 [n_next]) are the next ids sorted ascending,
// norder (int32 [n_next]) the original position of each (a stable argsort),
// gstarts (int32 [nb + 1]) where each block's rows begin in nids, over the
// same bounds as starts. Rows of next ids outside [0, n) are written as 0.
// nids and norder may be null when n_next = 0.
extern "C" int fused_adam_gather(float* w, void* mu, void* nu, int moment_dtype,
                                 const int32_t* ids, const float* grads,
                                 const int32_t* starts, float* partials,
                                 const int32_t* nids, const int32_t* norder,
                                 const int32_t* gstarts, float* rows_out, int n_next,
                                 int n, int d, int block_rows, float lr, float bc1,
                                 float bc2, float eps, float l2, float b1, float b2, int sr,
                                 unsigned int step, void* stream) {
  if (const int err = check_args(n, d, block_rows, moment_dtype)) return err;
  if (n_next < 0) return (int)cudaErrorInvalidValue;
  const Scalars s{lr, bc1, bc2, eps, l2, b1, b2};
  const dim3 grid((n + kRows - 1) / kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (moment_dtype == 0)
    fused_adam_gather_kernel<float><<<grid, kThreads, 0, st>>>(
        w, static_cast<float*>(mu), static_cast<float*>(nu), ids, grads, starts,
        partials, nids, norder, gstarts, rows_out, n_next, n, d, s, 0, step);
  else
    fused_adam_gather_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        w, static_cast<__nv_bfloat16*>(mu), static_cast<__nv_bfloat16*>(nu), ids,
        grads, starts, partials, nids, norder, gstarts, rows_out, n_next, n, d, s, sr,
        step);
  return (int)cudaGetLastError();
}
