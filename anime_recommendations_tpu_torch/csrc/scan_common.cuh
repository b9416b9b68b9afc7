// The score phase and the per-query warp extraction shared by
// packed_topk.cu (K2 below its large-Q threshold) and exact_topk.cu (K3).
//
// One block scores one 512-row group of the table against a tile of
// queries. The group is streamed through a two-stage cp.async ring of
// 16-dimension slabs (512 rows x 16 dims: 32 KB of f32 in flight per block
// while the other slab is computed; one barrier pair per slab). The query
// tile sits in shared memory as f32 and is read by broadcast. Each thread
// owns a register microtile of RPT rows x QPT queries and sums every score
// with fmaf in dimension order (K3's exact f32 contract). The queries are
// staged kQueryDims dimensions at a time, so the shared memory a block
// needs does not grow with D past that and every D % 16 == 0 runs. The scores then
// go to shared memory as one 32-bit key per (query, row), in the ring's
// place, and one warp per query extracts that query's best keys with warp
// reductions alone: no block barrier per round.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace scan {

constexpr int kGroup = 512;    // rows per block (K2's key lanes, K3's chunk)
constexpr int kSlab = 16;      // table dimensions per ring stage
constexpr int kStages = 2;
constexpr int kKeysPerLane = kGroup / 32;
constexpr int kQueryDims = 256;   // query dimensions staged at once

// The scan kernels' grids are one dimension of (512-row group, query tile)
// blocks: block b takes query tile b % tiles of group b / tiles. The tiles
// of a group stay side by side, as on a 2-D grid with the tiles on x (they
// share the group's rows through L2), and the group count is not held to
// gridDim.y's 65,535 (33,553,920 rows). A grid holds up to 2^31 - 1 blocks;
// rows are int, the last group's end included.
__host__ __device__ inline long long grid_blocks(int n, int nq, int qt) {
  return ((n + (long long)kGroup - 1) / kGroup) * ((nq + (long long)qt - 1) / qt);
}

inline bool grid_fits(int n, int nq, int qt) {
  return n <= 2147483647 - kGroup && grid_blocks(n, nq, qt) <= 2147483647LL;
}

// Padded row stride of a ring stage, in elements. f32 rows are read as
// float4: a stride of 20 floats puts 8 consecutive rows on 32 distinct
// banks. bf16 rows are read 4 values at a time; every 16-byte-aligned
// stride leaves a 2-way conflict there, 24 keeps it at 2.
template <typename T>
__host__ __device__ constexpr int tile_stride() { return sizeof(T) == 4 ? 20 : 24; }

template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return kGroup * tile_stride<T>() * (int)sizeof(T);
}

// A block of (kGroup / RPT) * QG threads; thread t owns rows
// t % (kGroup / RPT) + (kGroup / RPT) * i and queries (t / (kGroup / RPT)) *
// QPT + j of the tile.
template <typename T, int RPT, int QPT, int QG>
struct Tile {
  static constexpr int kRowThreads = kGroup / RPT;
  static constexpr int kThreads = kRowThreads * QG;
  static constexpr int kQT = QPT * QG;   // queries per block
  static constexpr int kRingBytes =
      kStages * stage_bytes<T>() > kQT * kGroup * 4 ? kStages * stage_bytes<T>()
                                                     : kQT * kGroup * 4;
  // Dynamic shared memory: the ring (then the keys), then the queries (f32,
  // up to kQueryDims dimensions of each, rows padded by 4).
  __host__ __device__ static int qstride(int d) { return (d < kQueryDims ? d : kQueryDims) + 4; }
  static size_t smem_bytes(int d) { return (size_t)kRingBytes + (size_t)kQT * qstride(d) * 4; }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;   // 0: zero-fill (rows past the table)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Copy dims [s * kSlab, (s + 1) * kSlab) of the group's rows into stage buf.
template <typename T>
__device__ __forceinline__ void stage_slab(unsigned char* ring, int buf, const T* table, int n,
                                           int d, int row0, int s, int tid, int nthreads) {
  constexpr int kPer = 16 / (int)sizeof(T);        // elements per 16-byte unit
  constexpr int kUnits = kSlab / kPer;             // units per row: 4 (f32), 2 (bf16)
  T* tile = reinterpret_cast<T*>(ring + buf * stage_bytes<T>());
  for (int u = tid; u < kGroup * kUnits; u += nthreads) {
    const int r = u / kUnits;
    const int c = (u - r * kUnits) * kPer;
    const int row = row0 + r;
    const bool ok = row < n;
    const T* src = ok ? table + (size_t)row * d + s * kSlab + c : table;
    cp_async16(tile + r * tile_stride<T>() + c, src, ok);
  }
}

__device__ __forceinline__ float4 tile4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 widen(uint2 raw);

__device__ __forceinline__ float4 tile4(const __nv_bfloat16* p) {
  return widen(*reinterpret_cast<const uint2*>(p));
}

// Elements [0, width) of rows [q0, q0 + nq) of queries (row stride ld) into
// a kQ-row tile: store(q, c, v) gets the 16 bytes v holding elements [c, c +
// 16 / sizeof(T)) of tile row q (zero past nq). Four 16-byte loads per
// thread are in flight at once: a loop of single loads, each followed by
// its store, waits out the latency of every one in turn.
template <int kQ, int kThreads, typename T, typename Store>
__device__ __forceinline__ void stage_queries(const T* __restrict__ queries, int ld, int width,
                                              int q0, int nq, Store store) {
  constexpr int kPer = 16 / (int)sizeof(T);
  constexpr int kBatch = 4;
  const int units = width / kPer;      // 16-byte units per row
  const int total = kQ * units;
  for (int base = threadIdx.x; base < total; base += kBatch * kThreads) {
    uint4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads;
      const int q = i / units;
      v[u] = (i < total && q < nq)
                 ? __ldg(reinterpret_cast<const uint4*>(queries + (size_t)(q0 + q) * ld) +
                         (i - q * units))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads;
      if (i < total) {
        const int q = i / units;
        store(q, (i - q * units) * kPer, v[u]);
      }
    }
  }
}

__device__ __forceinline__ float4 widen(uint2 raw) {   // 4 bf16 -> 4 f32
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// 16 bytes of T as f32 into dst: 4 floats, or 8 widened bf16.
__device__ __forceinline__ void store_f32(float* dst, uint4 v, float) {
  *reinterpret_cast<uint4*>(dst) = v;
}

__device__ __forceinline__ void store_f32(float* dst, uint4 v, __nv_bfloat16) {
  reinterpret_cast<float4*>(dst)[0] = widen(make_uint2(v.x, v.y));
  reinterpret_cast<float4*>(dst)[1] = widen(make_uint2(v.z, v.w));
}

// acc[i][j] = <row rg + kRowThreads * i, query qg * QPT + j> over the whole
// of d, one fmaf per dimension in dimension order (queries past nq_total are
// zero). The queries' next kQueryDims dimensions are staged after the
// barrier that ends the last slab of the previous ones. Ends with a
// barrier, after which the ring may be overwritten.
template <typename T, int RPT, int QPT, int QG>
__device__ __forceinline__ void score_group(const T* __restrict__ table,
                                            const T* __restrict__ queries, int n, int d,
                                            int nq_total, int q0, int row0, unsigned char* smem,
                                            float (&acc)[RPT][QPT]) {
  using S = Tile<T, RPT, QPT, QG>;
  const int t = threadIdx.x;
  const int rg = t % S::kRowThreads;
  const int qg = t / S::kRowThreads;
  constexpr int kQuerySlabs = kQueryDims / kSlab;
  const int qstride = S::qstride(d);
  float* qs = reinterpret_cast<float*>(smem + S::kRingBytes);
  const int nq = min(S::kQT, nq_total - q0);
  auto stage_query_dims = [&](int c0) {   // dims [c0, c0 + kQueryDims) of the tile
    stage_queries<S::kQT, S::kThreads>(queries + c0, d, min(kQueryDims, d - c0), q0, nq,
                                       [&](int q, int c, uint4 v) {
                                         store_f32(qs + q * qstride + c, v, T());
                                       });
  };

  stage_slab<T>(smem, 0, table, n, d, row0, 0, t, S::kThreads);
  cp_async_commit();
  stage_query_dims(0);
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < QPT; ++j) acc[i][j] = 0.f;

  const int nslabs = d / kSlab;
  for (int s = 0; s < nslabs; ++s) {
    if (s + 1 < nslabs) stage_slab<T>(smem, (s + 1) & 1, table, n, d, row0, s + 1, t, S::kThreads);
    cp_async_commit();
    if (s > 0 && s % kQuerySlabs == 0) stage_query_dims(s * kSlab);
    cp_async_wait<1>();   // slab s has landed
    __syncthreads();
    const T* tile = reinterpret_cast<const T*>(smem + (s & 1) * stage_bytes<T>());
    const float* qslab = qs + (s % kQuerySlabs) * kSlab + qg * QPT * qstride;
#pragma unroll
    for (int v = 0; v < kSlab; v += 4) {
      float4 w[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        w[i] = tile4(tile + (rg + S::kRowThreads * i) * tile_stride<T>() + v);
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(qslab + j * qstride + v);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc[i][j] = fmaf(w[i].x, x.x, acc[i][j]);
          acc[i][j] = fmaf(w[i].y, x.y, acc[i][j]);
          acc[i][j] = fmaf(w[i].z, x.z, acc[i][j]);
          acc[i][j] = fmaf(w[i].w, x.w, acc[i][j]);
        }
      }
    }
    __syncthreads();      // stage s & 1, and the queries' dims once read, are free again
  }
}

// K2: the top_r largest of one query's 512 int32 keys (unique: the low 9
// bits are the row's lane), largest first, to out[0, top_r). One warp; each
// lane keeps 16 keys and its own maximum, and only the lane that held a
// round's maximum rescans.
__device__ __forceinline__ void warp_top_keys(const int* keys, int top_r, int32_t* out,
                                              int lane) {
  constexpr int kIntMin = -2147483647 - 1;
  int k[kKeysPerLane];
  int best = kIntMin;
#pragma unroll
  for (int i = 0; i < kKeysPerLane; ++i) {
    k[i] = keys[lane + 32 * i];
    best = max(best, k[i]);
  }
  for (int j = 0; j < top_r; ++j) {
    const int m = __reduce_max_sync(0xffffffffu, best);
    if (lane == 0) out[j] = m;
    if (best == m) {
      best = kIntMin;
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        if (k[i] == m) k[i] = kIntMin;
        best = max(best, k[i]);
      }
    }
  }
}

// Order-preserving map of a (non-NaN) float to uint32, and back.
__device__ __forceinline__ uint32_t ordered(float s) {
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// K3: the exact top kc of one query's 512 ordered-score keys (0 = dead),
// ties to the lower position, as (score, row0 + position) pairs, then
// (-1e30, -1) once the live keys run out. One warp: each round a max of the
// lanes' best scores, then a min of the tied lanes' positions; only the lane
// that held the winner rescans.
__device__ __forceinline__ void warp_top_exact(const uint32_t* keys, int kc, int row0,
                                               float* out_s, int32_t* out_i, int lane) {
  uint32_t k[kKeysPerLane];
#pragma unroll
  for (int i = 0; i < kKeysPerLane; ++i) k[i] = keys[lane + 32 * i];
  uint32_t best = 0;
  int bi = 0;
#pragma unroll
  for (int i = 0; i < kKeysPerLane; ++i)
    if (k[i] > best) { best = k[i]; bi = i; }   // strict: the lowest i among equals
  int j = 0;
  for (; j < kc; ++j) {
    const uint32_t m = __reduce_max_sync(0xffffffffu, best);
    if (m == 0) break;
    const uint32_t pos = best == m ? (uint32_t)(lane + 32 * bi) : 0xffffffffu;
    const uint32_t p = __reduce_min_sync(0xffffffffu, pos);
    if (lane == 0) {
      out_s[j] = unordered(m);
      out_i[j] = row0 + (int)p;
    }
    if (pos == p) {
      best = 0;
      const int gone = bi;
      bi = 0;
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        if (i == gone) k[i] = 0;
        if (k[i] > best) { best = k[i]; bi = i; }
      }
    }
  }
  for (int jj = j + lane; jj < kc; jj += 32) {
    out_s[jj] = -1e30f;
    out_i[jj] = -1;
  }
}

// Let Kernel use `bytes` of dynamic shared memory on the current device.
// cudaFuncSetAttribute costs host time, so it runs only when a launch needs
// more than was allowed before; the limit only grows, under a lock (the
// HTTP server launches from many threads).
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  constexpr int kDevices = 64;
  static std::mutex mu;
  static size_t allowed[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < kDevices && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kDevices) allowed[dev] = bytes;
  return err;
}

}  // namespace scan
