// Dense Adam update of a list of f32 tensors in one launch
// (ops/dense_adam.py), hand-written for Hopper.
//
// Replaces no Pallas kernel: the JAX package leaves this update to optax
// (scale_by_adam, then -lr) and XLA. The port ran it as a chain of torch
// operations per tensor, about 14 passes over each table and 17 launches on
// each 0-dim head scalar; this kernel is that chain in one pass and one
// launch for every tensor of a step (trainer.dense_step's six parameters,
// lazy._head_adam's four head scalars).
//
// What it computes, for each tensor t of the list (p, g, mu, nu: f32, numel
// elements each) and each element, with lr, bc1 = 1 - b1^step and bc2 =
// 1 - b2^step read from the step's row in device memory:
//   mu' = mu*b1 + g*(1-b1)
//   nu' = nu*b2 + (g*g)*(1-b2)
//   p'  = p - ((mu'/bc1) / (sqrt(nu'/bc2) + eps)) * lr
// p, mu and nu in place. Every operation is an explicitly rounded f32
// intrinsic in the plain version's order (ops/dense_adam._dense_adam_plain,
// whose tensor ops round each result once; torch divides by a 0-dim device
// tensor, it does not multiply by a reciprocal), so the two agree bit for
// bit. b1, 1-b1, b2, 1-b2 and eps come by value as the f32 values torch
// casts the chain's Python numbers to.
//
// Bound on the H100: memory. Each element reads p, g, mu and nu and writes
// p, mu and nu: 28 bytes. anime-7m's step (91,641 + 17,560 rows of 128 and
// four scalars, 13,977,732 elements) moves 391 MB: 0.117 ms at 3.35 TB/s;
// 14 f32 operations an element (three divisions and a square root among
// them, each correctly rounded), far below the card's f32 rate.
//
// Design: the tensors are described in a parameter block passed by value
// (at most kMaxTensors), so a CUDA graph that captured the launch keeps
// valid arguments at every replay: the state's tensors keep their storage
// and the gradients come from the graph's pool. The step's row is read when
// the kernel runs, so each replay takes its own step's scalars. The tensors'
// elements form one concatenated range of units: a tensor whose four
// pointers are 16-byte aligned contributes numel / 4 float4 units and a
// scalar tail, any other tensor (a 0-dim head scalar, a view at an odd
// offset) scalar units only. The blocks walk the range grid-stride, one unit
// a thread at a time, neighbouring threads on neighbouring units (16-byte
// coalesced loads and stores); a thread finds its unit's tensor from the
// units' running ends, moving forward only. The grid has a thread for every
// unit (up to 2^31 - 1 blocks), so each thread makes one pass of the loop:
// on the H100 at the shapes above that took 0.132 ms, against 0.141 ms for
// one wave of 4 or 6 blocks an SM walking ~3.4 units a thread (0.159 ms
// with 8, whose register cap spills). No shared memory, no atomics, nothing
// allocated, no sync.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kMaxTensors = 8;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 0x7fffffff;

struct Tensors {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  long long vec[kMaxTensors];  // float4 units of tensor t (0 unless all four are aligned)
  long long end[kMaxTensors];  // one past tensor t's last unit in the concatenated range
  int count;
};

// The scalars fixed for a run, passed by value.
struct Consts {
  float b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void adam(float g, float& p, float& m, float& v, const Consts& c,
                                     float lr, float bc1, float bc2) {
  m = __fadd_rn(__fmul_rn(m, c.b1), __fmul_rn(g, c.omb1));
  v = __fadd_rn(__fmul_rn(v, c.b2), __fmul_rn(__fmul_rn(g, g), c.omb2));
  const float upd = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), c.eps));
  p = __fsub_rn(p, __fmul_rn(upd, lr));
}

__global__ void __launch_bounds__(kThreads)
dense_adam_kernel(const Tensors a, const float* __restrict__ row, const Consts c) {
  const float lr = __ldg(row), bc1 = __ldg(row + 1), bc2 = __ldg(row + 2);
  const long long total = a.end[a.count - 1];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  int t = 0;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += stride) {
    while (i >= a.end[t]) ++t;
    const long long j = i - (t ? a.end[t - 1] : 0);
    const long long vec = a.vec[t];
    if (j < vec) {
      float4* p4 = reinterpret_cast<float4*>(a.p[t]) + j;
      float4* m4 = reinterpret_cast<float4*>(a.m[t]) + j;
      float4* v4 = reinterpret_cast<float4*>(a.v[t]) + j;
      const float4 g = __ldg(reinterpret_cast<const float4*>(a.g[t]) + j);
      float4 p = *p4, m = *m4, v = *v4;
      adam(g.x, p.x, m.x, v.x, c, lr, bc1, bc2);
      adam(g.y, p.y, m.y, v.y, c, lr, bc1, bc2);
      adam(g.z, p.z, m.z, v.z, c, lr, bc1, bc2);
      adam(g.w, p.w, m.w, v.w, c, lr, bc1, bc2);
      *p4 = p;
      *m4 = m;
      *v4 = v;
    } else {
      const long long e = 4 * vec + (j - vec);
      float p = a.p[t][e], m = a.m[t][e], v = a.v[t][e];
      adam(__ldg(a.g[t] + e), p, m, v, c, lr, bc1, bc2);
      a.p[t][e] = p;
      a.m[t][e] = m;
      a.v[t][e] = v;
    }
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

// One dense Adam step over ``count`` (1..8) tensors: p, g, mu and nu are
// host arrays of ``count`` device pointers (f32, 4-byte aligned, not null
// where numel > 0), numel a host array of their element counts. row (f32 [4]
// in device memory: lr, bc1, bc2 and the step's bits) is read when the
// kernel runs. b1, omb1 = 1 - b1, b2, omb2 = 1 - b2 and eps as the plain
// version rounds them. Updates p, mu and nu in place on ``stream``; nothing
// is launched when every numel is 0. Returns a cudaError_t (0 on success).
extern "C" int dense_adam(float* const* p, const float* const* g, float* const* mu,
                          float* const* nu, const long long* numel, int count,
                          const float* row, float b1, float omb1, float b2, float omb2,
                          float eps, void* stream) {
  if (count < 1 || count > kMaxTensors || !p || !g || !mu || !nu || !numel || !row ||
      !aligned(row, 4))
    return (int)cudaErrorInvalidValue;
  Tensors a{};
  a.count = count;
  long long total = 0;
  for (int t = 0; t < count; ++t) {
    if (numel[t] < 0) return (int)cudaErrorInvalidValue;
    if (numel[t] > 0) {
      for (const void* ptr : {static_cast<const void*>(p[t]), static_cast<const void*>(g[t]),
                              static_cast<const void*>(mu[t]), static_cast<const void*>(nu[t])})
        if (!ptr || !aligned(ptr, 4)) return (int)cudaErrorInvalidValue;
    }
    a.p[t] = p[t];
    a.g[t] = g[t];
    a.m[t] = mu[t];
    a.v[t] = nu[t];
    const bool vec = aligned(p[t], 16) && aligned(g[t], 16) && aligned(mu[t], 16) &&
                     aligned(nu[t], 16);
    a.vec[t] = vec ? numel[t] / 4 : 0;
    total += numel[t] - 3 * a.vec[t];
    a.end[t] = total;
  }
  if (total == 0) return (int)cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  const Consts c{b1, omb1, b2, omb2, eps};
  dense_adam_kernel<<<static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks), kThreads,
                      0, static_cast<cudaStream_t>(stream)>>>(a, row, c);
  return (int)cudaGetLastError();
}
