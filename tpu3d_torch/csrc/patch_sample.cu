// patch_sample_kernel — bilinear samples of a level stack at per-keypoint
// coordinate grids.
//
// Replaces the TPU kernel tpu3d/kernels/patch_sample.py::
// sample_gradient_patches (body _patch_kernel). There each keypoint DMAs an
// (8, 128)-aligned 80x256 window into VMEM and evaluates the bilinear
// weights as two MXU matmuls, because gathers compile badly on the TPU.
// On Hopper a gather is cheap: one thread per (keypoint, sample) reads its
// keypoint's level and coordinate, loads the 2x2 cell from each channel
// through the read-only cache, and writes (K, C, S).
//
// What bounds it: bytes. Each sample moves 8 bytes of coordinates and
// 4 * C bytes of output against four gathered texels per channel; the
// gathered cells of one keypoint overlap heavily (a 16x16 grid spans a few
// dozen rows), so after L1/L2 the device traffic is coordinates + output +
// the touched texels once. The design keeps the sample axis fastest in the
// thread index, so coordinate loads and output stores coalesce, and routes
// the texel reads through __ldg.
//
// Semantics are those of tpu3d's gather path (features/descriptor.py
// ::_bilinear): the base index is clipped to [0, H-2] x [0, W-2] and the
// fraction comes from the unclipped coordinate. The TPU kernel's window,
// its alignment rounding and its bf16 precision modes have no counterpart
// here: this kernel always computes exact f32, with the same operation
// order as the plain PyTorch version (no FMA contraction), so the two agree
// bit for bit. An optional per-sample level offset (dlvl) serves the
// detector's 3x3x3 DoG fetch in one launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void patch_sample_kernel(const float* __restrict__ gx,
                                    const float* __restrict__ gy, int nch,
                                    const int* __restrict__ lvl,
                                    const int* __restrict__ dlvl,
                                    const float* __restrict__ ys,
                                    const float* __restrict__ xs,
                                    float* __restrict__ out, int L, int H,
                                    int W, int K, int S) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)K * S) return;
  const int k = (int)(i / S);
  const int s = (int)(i - (int64_t)k * S);
  int l = __ldg(lvl + k);
  if (dlvl != nullptr) l += __ldg(dlvl + s);
  l = min(max(l, 0), L - 1);
  const float y = __ldg(ys + i);
  const float x = __ldg(xs + i);
  const float y0 = floorf(y);
  const float x0 = floorf(x);
  const float wy = __fsub_rn(y, y0);
  const float wx = __fsub_rn(x, x0);
  const int y0i = min(max((int)y0, 0), H - 2);
  const int x0i = min(max((int)x0, 0), W - 2);
  const float oy = __fsub_rn(1.0f, wy);
  const float ox = __fsub_rn(1.0f, wx);
  const int64_t base = ((int64_t)l * H + y0i) * W + x0i;
  for (int c = 0; c < nch; ++c) {
    const float* img = c == 0 ? gx : gy;
    const float v00 = __ldg(img + base);
    const float v01 = __ldg(img + base + 1);
    const float v10 = __ldg(img + base + W);
    const float v11 = __ldg(img + base + W + 1);
    // ((v00*(1-wy))*(1-wx) + (v01*(1-wy))*wx) + (v10*wy)*(1-wx) + (v11*wy)*wx
    float acc = __fmul_rn(__fmul_rn(v00, oy), ox);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, oy), wx));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, wy), ox));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, wy), wx));
    out[((int64_t)k * nch + c) * S + s] = acc;
  }
}

}  // namespace

extern "C" int tpu3d_patch_sample(const float* gx, const float* gy, int nch,
                                  const int* lvl, const int* dlvl,
                                  const float* ys, const float* xs, float* out,
                                  int L, int H, int W, int K, int S,
                                  void* stream) {
  const int64_t n = (int64_t)K * S;
  if (n > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    patch_sample_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        gx, gy, nch, lvl, dlvl, ys, xs, out, L, H, W, K, S);
  }
  return (int)cudaGetLastError();
}
