// trilinear_kernel — trilinear samples of a voxel grid at world points.
//
// Replaces the TPU kernel tpu3d/kernels/trilinear.py::_sample_packed (body
// _kernel_whole, :82/:128). There the grid is re-packed to (X, Y, Z/8+1, 2,
// 128) so that ONE box DMA per sample brings all 8 corners into VMEM; a
// block queues 128 such DMAs to hide HBM latency, then folds z with an iota
// mask because gathers compile badly on the TPU. On Hopper a gather is
// native, so none of that carries over: the grid stays in tpu3d's
// channels-last (X, Y, Z, C) layout and one warp takes one sample, lane c
// reading channel c of the 8 corner rows (each read one contiguous row of
// C floats across the warp), lerping, and writing channel c of the output.
// The sample's coordinates are computed once, as one instruction stream of
// the warp, by corner_setup (trilinear_common.cuh, shared with the
// backward in trilinear_grad.cu).
// The lerp follows _lerp8 (z, then y, then x; grid.py:86-95) with every
// product and sum rounded on its own (__fmul_rn / __fadd_rn, no FMA
// contraction) and an IEEE division, so the kernel and the plain PyTorch
// version (kernels/trilinear.py) agree bit for bit.
//
// What bounds it: bytes. Per sample it reads 12 B of coordinates and
// writes 4*C B of values (112 B at C = 28) and one in-bounds byte; the
// corner rows of neighbouring samples along a ray overlap, so after L1/L2
// the grid traffic is the rows touched once. One render launch (8,192 rays
// x 192 samples = 1.57 M samples) moves >= 0.19 GB before grid reads:
// >= ~59 us at 3.35 TB/s. The grid reads go through the read-only path.
//
// Layout choice: C stays 28, not padded to 32. Padding would make each
// corner row one aligned 128-B line instead of 112 B straddling up to two,
// but costs 14% more grid memory (2.15 GB instead of 1.88 GB at 256^3) and,
// with a padded output, 14% more of the output bytes that dominate the
// bound; and the unpadded layout is tpu3d's artifact layout, so a loaded
// grid needs no copy. Four of 32 lanes idle at C = 28.
#include "trilinear_common.cuh"

namespace {

using tpu3d::kWarpsPerBlock;

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  // a * (1 - f) + b * f, each operation rounded (tpu3d's _lerp8 order)
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
trilinear_kernel(const float* __restrict__ grid,
                 const float* __restrict__ min_bound,
                 const float* __restrict__ max_bound,
                 const float* __restrict__ pts, float* __restrict__ out,
                 unsigned char* __restrict__ in_bounds, int X, int Y, int Z,
                 int C, int64_t N) {
  const int lane = threadIdx.x & 31;
  const int64_t n = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (n >= N) return;
  const tpu3d::Corner cs = tpu3d::corner_setup(min_bound, max_bound, pts + 3 * n, X, Y, Z);
  const bool inside = cs.inside;
  if (lane == 0) in_bounds[n] = inside ? 1 : 0;
  if (lane >= C) return;
  const int64_t dz = C;
  const int64_t dy = (int64_t)Z * C;
  const int64_t dx = (int64_t)Y * Z * C;
  const float* p = grid + cs.base * C + lane;
  const float c000 = __ldg(p);
  const float c001 = __ldg(p + dz);
  const float c010 = __ldg(p + dy);
  const float c011 = __ldg(p + dy + dz);
  const float c100 = __ldg(p + dx);
  const float c101 = __ldg(p + dx + dz);
  const float c110 = __ldg(p + dx + dy);
  const float c111 = __ldg(p + dx + dy + dz);
  const float c00 = lerp_rn(c000, c001, cs.f[2]);
  const float c01 = lerp_rn(c010, c011, cs.f[2]);
  const float c10 = lerp_rn(c100, c101, cs.f[2]);
  const float c11 = lerp_rn(c110, c111, cs.f[2]);
  const float c0 = lerp_rn(c00, c01, cs.f[1]);
  const float c1 = lerp_rn(c10, c11, cs.f[1]);
  const float v = lerp_rn(c0, c1, cs.f[0]);
  out[n * C + lane] = __fmul_rn(v, inside ? 1.0f : 0.0f);
}

}  // namespace

extern "C" int tpu3d_trilinear(const float* grid, const float* min_bound,
                               const float* max_bound, const float* pts,
                               float* out, unsigned char* in_bounds, int X,
                               int Y, int Z, int C, int64_t N, void* stream) {
  if (N > 0) {
    const int64_t blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    trilinear_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                       (cudaStream_t)stream>>>(grid, min_bound, max_bound, pts,
                                               out, in_bounds, X, Y, Z, C, N);
  }
  return (int)cudaGetLastError();
}
