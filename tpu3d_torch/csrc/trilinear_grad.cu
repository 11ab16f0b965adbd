// trilinear_grad_kernel — the grid gradient of trilinear sampling: an
// 8-corner scatter-add of the (N, C) cotangents into an (X, Y, Z, C) grid.
//
// Replaces the TPU kernel tpu3d/kernels/trilinear_grad.py::scatter_grad
// (body _scatter_kernel, :73/:157). TPU grid instances run one after
// another and have no atomics, so tpu3d sorts the samples into (x-slab,
// y-block) bins of their base cell, lets each instance own a disjoint
// output block in VMEM with a y-halo row carried to the next instance,
// streams 128-aligned chunks of fields and cotangents through SMEM/VMEM,
// and does one (2, 2, 2, 128) read-modify-write per sample. None of that
// carries over: Hopper's global atomics are native, so no sort, no bins,
// no halo. The kernel mirrors the forward (trilinear.cu): the same
// corner_setup (trilinear_common.cuh), so the scatter hits exactly the
// cells the gather read, and a sample outside the box returns early (its
// cotangent is masked, as scatter_grad's g * in_bounds, trilinear_grad.py:177).
//
// Threads: a slot of 8 threads per sample, 4 samples per warp. When C is a
// multiple of 4 (C = 28 for a dense grid), thread j of a slot owns channels
// 4j..4j+3 and does 8 vector atomics (atomicAdd on float4, native on
// compute capability 9.x for global memory), one per corner: a 112-B row is
// 7 aligned float4s (row r starts at byte 112 r), so 7 of the 8 threads work
// and a sample costs 56 atomics instead of 224. Otherwise thread j owns
// channels j, j+8, ... with scalar atomics. The weight of corner (a, b, c)
// is wx_a * wy_b * wz_c (wx_0 = 1 - fx, wx_1 = fx), multiplied in that
// order and then by the cotangent, each product rounded on its own, as the
// plain version (kernels/trilinear_grad.py). Atomics sum in no fixed
// order, so the kernel and the plain version (and two runs of the kernel)
// agree to rounding, not bit for bit.
//
// What bounds it: bytes. The gradient is the whole grid, so the wrapper
// zero-fills it (X*Y*Z*C*4 B written: 1.879 GB at 256^3 x 28) before this
// kernel, which then reads the cotangents (N*C*4 B, 44 MB for one training
// step's 393,216 samples) and the points (N*12 B) and read-modify-writes the
// rows the in-box samples touch, in L2. With the fill the step is >= 1.93 GB,
// >= 0.58 ms at 3.35 TB/s; the scatter alone is bounded by the cotangents,
// the points and the touched rows.
#include "trilinear_common.cuh"

namespace {

using tpu3d::kWarpsPerBlock;
constexpr int kSlot = 8;   // threads per sample

template <bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
trilinear_grad_kernel(const float* __restrict__ g,
                      const float* __restrict__ min_bound,
                      const float* __restrict__ max_bound,
                      const float* __restrict__ pts, float* __restrict__ out,
                      int X, int Y, int Z, int C, int64_t N) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n = t / kSlot;
  const int j = (int)(t % kSlot);
  if (n >= N) return;
  const tpu3d::Corner cs = tpu3d::corner_setup(min_bound, max_bound, pts + 3 * n, X, Y, Z);
  if (!cs.inside) return;
  const float wx[2] = {__fsub_rn(1.0f, cs.f[0]), cs.f[0]};
  const float wy[2] = {__fsub_rn(1.0f, cs.f[1]), cs.f[1]};
  const float wz[2] = {__fsub_rn(1.0f, cs.f[2]), cs.f[2]};
  const int64_t dz = C;
  const int64_t dy = (int64_t)Z * C;
  const int64_t dx = (int64_t)Y * Z * C;
  float* row = out + cs.base * C;
  const float* grow = g + n * C;
  if (kVec) {
    const int c0 = 4 * j;
    if (c0 >= C) return;
    const float4 gv = __ldg(reinterpret_cast<const float4*>(grow + c0));
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int a = k >> 2, b = (k >> 1) & 1, c = k & 1;
      const float w = __fmul_rn(__fmul_rn(wx[a], wy[b]), wz[c]);
      float* p = row + a * dx + b * dy + c * dz + c0;
      const float4 v = make_float4(__fmul_rn(w, gv.x), __fmul_rn(w, gv.y),
                                   __fmul_rn(w, gv.z), __fmul_rn(w, gv.w));
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
      atomicAdd(reinterpret_cast<float4*>(p), v);
#else  // nvcc's host pass and pre-Hopper targets: four scalar atomics
      atomicAdd(p, v.x);
      atomicAdd(p + 1, v.y);
      atomicAdd(p + 2, v.z);
      atomicAdd(p + 3, v.w);
#endif
    }
  } else {
    for (int ch = j; ch < C; ch += kSlot) {
      const float gv = __ldg(grow + ch);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int a = k >> 2, b = (k >> 1) & 1, c = k & 1;
        const float w = __fmul_rn(__fmul_rn(wx[a], wy[b]), wz[c]);
        atomicAdd(row + a * dx + b * dy + c * dz + ch, __fmul_rn(w, gv));
      }
    }
  }
}

}  // namespace

// g (N, C) and out (X, Y, Z, C) f32, contiguous; out zero-filled by the
// caller. vec != 0 takes the float4 path: C % 4 == 0 and g, out 16-B aligned.
extern "C" int tpu3d_trilinear_grad(const float* g, const float* min_bound,
                                    const float* max_bound, const float* pts,
                                    float* out, int X, int Y, int Z, int C,
                                    int64_t N, int vec, void* stream) {
  if (N > 0) {
    const int64_t threads = kWarpsPerBlock * 32;
    const int64_t blocks = (N * kSlot + threads - 1) / threads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    if (vec) {
      trilinear_grad_kernel<true><<<(unsigned)blocks, (unsigned)threads, 0,
                                    (cudaStream_t)stream>>>(
          g, min_bound, max_bound, pts, out, X, Y, Z, C, N);
    } else {
      trilinear_grad_kernel<false><<<(unsigned)blocks, (unsigned)threads, 0,
                                     (cudaStream_t)stream>>>(
          g, min_bound, max_bound, pts, out, X, Y, Z, C, N);
    }
  }
  return (int)cudaGetLastError();
}
