// The corner setup shared by trilinear_kernel (trilinear.cu) and its
// backward, trilinear_grad_kernel (trilinear_grad.cu): one definition, so
// that the scatter provably hits the cells the gather read, with the same
// fractions.
//
// tpu3d's _corner_setup order (dense/grid.py:74-83), each operation rounded
// on its own (IEEE division, no FMA contraction), as the plain PyTorch
// version (kernels/trilinear.py::_corner_setup):
//   u = (p - min) / (max - min), in = all(0 <= u <= 1), v = u * (res - 1),
//   i0 = clip(floor v, 0, res - 2), f = v - i0.
// corner_axis is that arithmetic for one axis. The backward runs all three
// per thread (corner_setup); the forward runs one per lane and shares the
// results across a sample's lanes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tpu3d {

constexpr int kWarpsPerBlock = 8;   // trilinear_grad_kernel's block

struct Corner {
  int64_t base;   // row index of corner (0, 0, 0) in the (X*Y*Z, C) view
  float f[3];     // fractions along x, y, z
  bool inside;    // the point lies in the closed box
};

struct Axis {
  int i0;         // base cell index along the axis
  float f;        // fraction along the axis
  bool inside;    // 0 <= u <= 1 along the axis
};

// One axis of the setup: lo, hi the box's extent along it, p the point's
// coordinate, res the grid's resolution along it.
__device__ __forceinline__ Axis corner_axis(float lo, float hi, float p, int res) {
  const float u = __fdiv_rn(__fsub_rn(p, lo), __fsub_rn(hi, lo));
  const float v = __fmul_rn(u, (float)(res - 1));
  // clipped in float before the cast, as the plain version does
  const float b = fminf(fmaxf(floorf(v), 0.0f), (float)(res - 2));
  Axis a;
  a.i0 = (int)b;
  a.f = __fsub_rn(v, b);
  a.inside = (u >= 0.0f) && (u <= 1.0f);
  return a;
}

// The setup from values in registers: lo, hi the box, p the point.
__device__ __forceinline__ Corner corner_from(const float lo[3], const float hi[3],
                                              const float p[3], int X, int Y, int Z) {
  const int res[3] = {X, Y, Z};
  int i0[3];
  Corner c;
  c.inside = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const Axis ax = corner_axis(lo[a], hi[a], p[a], res[a]);
    c.inside = c.inside && ax.inside;
    i0[a] = ax.i0;
    c.f[a] = ax.f;
  }
  c.base = ((int64_t)i0[0] * Y + i0[1]) * Z + i0[2];
  return c;
}

// The setup from device memory: the box (3,) and (3,), the point (3,).
__device__ __forceinline__ Corner corner_setup(const float* __restrict__ min_bound,
                                               const float* __restrict__ max_bound,
                                               const float* __restrict__ p, int X,
                                               int Y, int Z) {
  float lo[3], hi[3], q[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = __ldg(min_bound + a);
    hi[a] = __ldg(max_bound + a);
    q[a] = __ldg(p + a);
  }
  return corner_from(lo, hi, q, X, Y, Z);
}

}  // namespace tpu3d
