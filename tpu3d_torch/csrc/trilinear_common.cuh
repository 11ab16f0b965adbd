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
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tpu3d {

constexpr int kWarpsPerBlock = 8;

struct Corner {
  int64_t base;   // row index of corner (0, 0, 0) in the (X*Y*Z, C) view
  float f[3];     // fractions along x, y, z
  bool inside;    // the point lies in the closed box
};

__device__ __forceinline__ Corner corner_setup(const float* __restrict__ min_bound,
                                               const float* __restrict__ max_bound,
                                               const float* __restrict__ p, int X,
                                               int Y, int Z) {
  const int res[3] = {X, Y, Z};
  int i0[3];
  Corner c;
  c.inside = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo = __ldg(min_bound + a);
    const float hi = __ldg(max_bound + a);
    const float u = __fdiv_rn(__fsub_rn(__ldg(p + a), lo), __fsub_rn(hi, lo));
    c.inside = c.inside && (u >= 0.0f) && (u <= 1.0f);
    const float v = __fmul_rn(u, (float)(res[a] - 1));
    // clipped in float before the cast, as the plain version does
    const float b = fminf(fmaxf(floorf(v), 0.0f), (float)(res[a] - 2));
    i0[a] = (int)b;
    c.f[a] = __fsub_rn(v, b);
  }
  c.base = ((int64_t)i0[0] * Y + i0[1]) * Z + i0[2];
  return c;
}

}  // namespace tpu3d
