// view_rays_kernel — one camera view's ray grid on the card: every
// stride-th row and column of an H x W image, row-major, each pixel's
// origin and unit direction in the scene's normalized frame
// (dense/eval.py::render_view without precomputed rays; the plain version
// is kernels/view_rays.py::view_rays_plain).
//
// Replaces no TPU kernel: tpu3d builds a view's rays in numpy on the host
// (tpu3d/dense/eval.py::view_rays), and so does the port's numpy
// view_rays, which the render then copies to the card. At the render
// cells' 968 x 648 rays of a 1936 x 1296 view that is ~50 ms of host time
// and 15 MB uploaded from pageable memory a view, while the card waits.
//
// What bounds it: bytes. A ray writes its origin and direction, 24 bytes,
// for ~20 FLOP, and reads nothing: the pose (rotation, origin, focal,
// image centre) comes in the launch's arguments. 627,264 rays are 15.05
// MB: >= 4.5 us at 3.35 TB/s. One thread a ray, one launch a view.
//
// The arithmetic is numpy view_rays' in f32, in its order, with the
// roundings of the BLAS sgemm that forms its (P, 3) x (3, 3) product (an
// FMA chain over k in order, as OpenBLAS's x86-64 kernels compute it):
//   u = x - W/2,  v = -(y - H/2);  a = u / f,  b = v / f;
//   d_j = fma(b, R[1][j], a R[0][j]) + R[2][j]  (the camera ray (a, b, 1) times R);
//   d = d / sqrt((dx dx + dy dy) + dz dz).
// Every other product, sum and quotient is rounded on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn: no contraction by nvcc, true division,
// a correctly rounded root), so the kernel equals the plain version bit for
// bit and numpy's rays wherever numpy's sgemm is that chain (on the hosts
// measured: every ray). That matters beyond the last bit: a box-clipped
// ray's last sample lies on the box's face, where its in-box flag, and with
// it a 1e10 segment's alpha, turns on the rounding of the ray; a ray a few
// ulp off numpy's can end in another colour. The origin is the pose's,
// formed on the host exactly as numpy view_rays forms it, written to every
// ray.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The view's pose and pixel grid, passed by value to the kernel.
struct Pose {
  float r[9];            // the world-to-camera rotation R, row-major
  float o[3];            // the camera centre, normalized
  float focal, half_w, half_h;
  int stride, w, n;      // pixel step, rays a row, rays
};

__global__ void __launch_bounds__(kThreads)
view_rays_kernel(float* __restrict__ origins, float* __restrict__ dirs, const Pose p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  const int row = i / p.w, col = i - row * p.w;
  const float u = __fsub_rn((float)(col * p.stride), p.half_w);
  const float v = -__fsub_rn((float)(row * p.stride), p.half_h);
  const float a = __fdiv_rn(u, p.focal), b = __fdiv_rn(v, p.focal);
  float d[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    d[j] = __fadd_rn(__fmaf_rn(b, p.r[3 + j], __fmul_rn(a, p.r[j])), p.r[6 + j]);
  const float norm = __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])), __fmul_rn(d[2], d[2])));
  float* o = origins + 3 * (int64_t)i;
  float* e = dirs + 3 * (int64_t)i;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    o[j] = p.o[j];
    e[j] = __fdiv_rn(d[j], norm);
  }
}

}  // namespace

struct ViewRaysArgs {
  float* origins;        // (n, 3) f32, written
  float* dirs;           // (n, 3) f32, written
  void* stream;
  Pose pose;
};
static_assert(sizeof(ViewRaysArgs) == 96, "layout of struct 3Q15f3i");

extern "C" int tpu3d_view_rays(const ViewRaysArgs* a) {
  if (a->pose.n > 0) {
    const unsigned blocks = (unsigned)((a->pose.n + kThreads - 1) / kThreads);
    view_rays_kernel<<<blocks, kThreads, 0, (cudaStream_t)a->stream>>>(a->origins, a->dirs,
                                                                        a->pose);
  }
  return (int)cudaGetLastError();
}
