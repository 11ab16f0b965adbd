// rmsprop_kernel — optax.rmsprop's update of one parameter tensor, in one
// pass over it: nu <- decay nu + (1 - decay) g^2, then p <- p - lr g /
// sqrt(nu + eps), eps inside the root (dense/train.py::RMSprop; the plain
// version is kernels/rmsprop.py::rmsprop_update_plain).
//
// Replaces no TPU kernel: tpu3d's grid optimizer is optax.rmsprop
// (tpu3d/dense/train.py:226-227), whose update XLA fuses into one loop over
// the grid. Written as torch operations the same update is eight
// elementwise launches that move 19 tensor-sized passes (~35.7 GB a step
// at 256^3 x 28); this kernel moves the five the update needs.
//
// What bounds it: bytes. Each element reads g, nu and p once and writes nu
// and p once, 5 x 4 = 20 bytes for ~6 FLOP, and nothing is read twice (the
// working set, 5.6 GB at 256^3 x 28, against a 50 MB L2). At 256^3 x 28
// (469.8 M elements) that is 9.395 GB: >= 2.80 ms at 3.35 TB/s.
//
// The design meets it as a plain stream:
//  - 16-byte vectors (float4): each thread loads one vector of each of the
//    three streams (three 16-byte loads in flight), updates its 4 elements
//    and stores nu and p; neighbouring threads touch neighbouring vectors.
//  - A grid of one thread per vector, so the blocks sweep the tensors in
//    address order. The loop over the vectors is a grid-stride loop with
//    int64 offsets (512^3 x 28 has 3.76 G elements), which only a grid
//    capped at 2^31 - 1 blocks would go round more than once.
//  - Streaming cache hints (ld.global.cs / st.global.cs: evict first):
//    nothing is re-read, so nothing is kept.
//  - When the three pointers share their offset within 16 bytes, the (at
//    most 3) elements before the first aligned vector and the (at most 3)
//    after the last take the scalar update (head and tail peel); when they
//    do not, every element does.
//  - No shared memory, no atomics: each element is one thread's.
// On an H100 at 256^3 x 28 it takes 3.10 ms, ~3.03 TB/s, the rate of
// torch's own copy_ in the same runs (3.02-3.04 TB/s). Measured slower
// there: the grid of the blocks the card holds at once, walking the
// tensors by grid stride with 4 vectors of each stream in flight per
// thread (3.28-3.30 ms); the one-pass grid with 2 or 4 vectors per
// thread (3.12, 3.14-3.15 ms).
// Without the cache hints: within 0.3%.
//
// The arithmetic is the plain version's, operation by operation, each
// product and sum rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn: no
// FMA contraction) and rsqrtf as torch's CUDA rsqrt:
//   nu = nu * d;  t = c * (g * g), c = 1 - d formed in double and rounded
//   to f32 by the caller, as torch rounds a Python scalar;  nu = nu + t;
//   r = rsqrtf(nu + eps);  s = r * lr;  p = p - s * g.
// lr is read on the device from lr_ptr when it is not null (a 0-d f32
// tensor, so that a CUDA graph replay applies the schedule's current
// value), else lr_value is used.
#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ void update(float& p, float g, float& nu, float lr, float d,
                                       float c, float eps) {
  const float t = __fmul_rn(c, __fmul_rn(g, g));
  nu = __fadd_rn(__fmul_rn(nu, d), t);
  const float s = __fmul_rn(rsqrtf(__fadd_rn(nu, eps)), lr);
  p = __fsub_rn(p, __fmul_rn(s, g));
}

// Elements [0, head) and [head + 4 nvec, n) are scalar; the nvec float4s
// from element head (16-byte aligned in all three tensors) are vectors.
__global__ void __launch_bounds__(kThreads)
rmsprop_kernel(float* __restrict__ p, const float* __restrict__ g, float* __restrict__ nu,
               const float* __restrict__ lr_ptr, float lr_value, float d, float c, float eps,
               int64_t n, int64_t head, int64_t nvec) {
  const float lr = lr_ptr != nullptr ? __ldg(lr_ptr) : lr_value;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p + head);
  const float4* g4 = reinterpret_cast<const float4*>(g + head);
  float4* nu4 = reinterpret_cast<float4*>(nu + head);
  for (int64_t i = tid; i < nvec; i += stride) {
    const float4 gv = __ldcs(g4 + i);
    float4 nv = __ldcs(nu4 + i), pv = __ldcs(p4 + i);
    update(pv.x, gv.x, nv.x, lr, d, c, eps);
    update(pv.y, gv.y, nv.y, lr, d, c, eps);
    update(pv.z, gv.z, nv.z, lr, d, c, eps);
    update(pv.w, gv.w, nv.w, lr, d, c, eps);
    __stcs(nu4 + i, nv);
    __stcs(p4 + i, pv);
  }
  const int64_t tail = head + 4 * nvec;
  for (int64_t j = tid; j < head + (n - tail); j += stride) {
    const int64_t e = j < head ? j : tail + (j - head);
    float pv = p[e], nv = nu[e];
    update(pv, g[e], nv, lr, d, c, eps);
    nu[e] = nv;
    p[e] = pv;
  }
}

}  // namespace

// p, g, nu: n contiguous f32 each, distinct, on the stream's device; p and
// nu updated in place. lr_ptr: a device f32, or null to use lr_value.
// one_minus_decay: (float)(1.0 - (double)decay).
extern "C" int tpu3d_rmsprop(float* p, const float* g, float* nu, const float* lr_ptr,
                             float lr_value, float decay, float one_minus_decay, float eps,
                             int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const uintptr_t a = (uintptr_t)p;
  const bool vec = (((a ^ (uintptr_t)g) | (a ^ (uintptr_t)nu)) & 15) == 0 && (a & 3) == 0;
  int64_t head = n, nvec = 0;
  if (vec) {
    head = std::min<int64_t>(n, (int64_t)((16 - (a & 15)) & 15) / 4);
    nvec = (n - head) / 4;
  }
  const int64_t scalars = n - 4 * nvec;
  const int64_t want = (std::max(nvec, scalars) + kThreads - 1) / kThreads;
  const int64_t blocks = std::min<int64_t>(want, 0x7fffffffLL);
  rmsprop_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      p, g, nu, lr_ptr, lr_value, decay, one_minus_decay, eps, n, head, nvec);
  return (int)cudaGetLastError();
}
