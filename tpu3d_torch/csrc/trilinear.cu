// trilinear_kernel — trilinear samples of a voxel grid at world points.
//
// Replaces the TPU kernel tpu3d/kernels/trilinear.py::_sample_packed (body
// _kernel_whole, :82/:128). There the grid is re-packed to (X, Y, Z/8+1, 2,
// 128) so that ONE box DMA per sample brings all 8 corners into VMEM; a
// block queues 128 such DMAs to hide HBM latency, then folds z with an iota
// mask because gathers compile badly on the TPU. On Hopper a gather is
// native, so the grid stays in tpu3d's channels-last (X, Y, Z, C) layout
// and the design is about keeping enough gathers in flight with few
// instructions per sample.
//
// What bounds it: bytes, once enough loads are in flight. Per sample it
// reads 12 B of coordinates and writes 4*C B of values (112 B at C = 28)
// and one in-bounds byte; the corner rows of neighbouring samples along a
// ray overlap, so after L1/L2 the grid traffic is the rows touched once.
// One render launch (8,192 rays x 192 samples = 1.57 M samples) moves
// >= 0.19 GB before grid reads: >= ~59 us at 3.35 TB/s. A warp per sample
// (lane = channel) runs one dependent chain per warp (point, corner setup,
// 8 gathers, lerps, store) and keeps ~64 samples in flight per SM: 16% of
// the bound on an H100.
//
// The design:
//  - 8 lanes per sample, 4 samples per warp. With V = 4 (C % 4 == 0 and
//    16-byte aligned grid and output) lane j owns channels 4j..4j+3 and
//    issues its 8 corner loads and its store as float4: a 112-B row at
//    C = 28 is 7 float4s (row r starts at byte 112 r), so 7 of the 8 lanes
//    work and one warp's store is 448 contiguous bytes. With V = 1 (any
//    other C <= 32, or an unaligned view) lane j owns channels j, j+8,
//    j+16, j+24 with scalar loads. The wrapper picks V
//    (kernels/trilinear.py::vector_width).
//  - The corner setup is split over the slot: lanes 0, 1, 2 each run
//    tpu3d::corner_axis (trilinear_common.cuh, the one definition shared
//    with the backward) for one axis, with its IEEE division, and the slot
//    reads the three results by shuffle and the in-box test by ballot. So
//    a warp issues one axis's setup per 4 samples, not three per sample.
//  - Each warp takes 32 consecutive samples (consecutive along a ray) in 8
//    groups of 4, and loads the next group's coordinate before the current
//    group's gathers, so a point load never waits behind a lerp.
//  - 32-bit offsets where the wrapper has checked that X*Y*Z*C and N*C fit
//    (an address is one multiply-add on the base pointer), and at most 64
//    registers (__launch_bounds__(256, 4)), so 32 warps (128 samples) are
//    resident per SM. Two groups' gathers in flight per warp take 118-128
//    registers, so 16 warps per SM, and measure slower on an H100.
// The lerp follows _lerp8 (z, then y, then x; grid.py:86-95) with every
// product and sum rounded on its own (__fmul_rn / __fadd_rn, no FMA
// contraction), so the kernel and the plain PyTorch version
// (kernels/trilinear.py) agree bit for bit.
//
// Layout choice: C stays 28, not padded to 32. Padding would make each
// corner row one aligned 128-B line instead of 112 B straddling up to two,
// but costs 14% more grid memory (2.15 GB instead of 1.88 GB at 256^3) and,
// with a padded output, 14% more of the output bytes that dominate the
// bound; and the unpadded layout is tpu3d's artifact layout, so a loaded
// grid needs no copy.
#include "trilinear_common.cuh"

namespace {

constexpr int kThreads = 256;                          // 8 warps a block
constexpr int kMinBlocks = 4;                          // per SM: <= 64 registers
constexpr int kSlot = 8;                               // lanes per sample
constexpr int kGroup = 32 / kSlot;                     // samples per group: 4
constexpr int kPerWarp = 32;                           // samples per warp
constexpr int kIters = kPerWarp / kGroup;              // groups per warp
constexpr int kPerBlock = (kThreads / 32) * kPerWarp;  // 256 samples per block

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  // a * (1 - f) + b * f, each operation rounded (tpu3d's _lerp8 order)
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

__device__ __forceinline__ float4 lerp_rn(float4 a, float4 b, float f) {
  return make_float4(lerp_rn(a.x, b.x, f), lerp_rn(a.y, b.y, f), lerp_rn(a.z, b.z, f),
                     lerp_rn(a.w, b.w, f));
}

__device__ __forceinline__ float mask_rn(float v, float m) { return __fmul_rn(v, m); }

__device__ __forceinline__ float4 mask_rn(float4 v, float m) {
  return make_float4(__fmul_rn(v.x, m), __fmul_rn(v.y, m), __fmul_rn(v.z, m),
                     __fmul_rn(v.w, m));
}

template <int V>
struct Lane;

template <>
struct Lane<4> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Lane<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void store(float* p, T v) { *p = v; }
};

// V: channels per load (4: float4, 1: scalar); Idx: the type of grid and
// output offsets (int where the wrapper has checked that X*Y*Z*C and N*C
// fit).
template <int V, typename Idx>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
trilinear_kernel(const float* __restrict__ grid,
                 const float* __restrict__ min_bound,
                 const float* __restrict__ max_bound,
                 const float* __restrict__ pts, float* __restrict__ out,
                 unsigned char* __restrict__ in_bounds, int X, int Y, int Z,
                 int C, int64_t N) {
  using T = typename Lane<V>::T;
  constexpr int kRounds = 32 / (kSlot * V);   // channel chunks per lane
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int q = lane / kSlot;                 // the lane's sample in a group
  const int j = lane % kSlot;                 // its chunk of channels
  const int src = q * kSlot;                  // the slot's first lane
  // Lanes 0, 1, 2 of a slot set up axes x, y, z of their sample; the other
  // five repeat axis j % 3 and are not read.
  const int a = j % 3;
  const float lo = __ldg(min_bound + a);
  const float hi = __ldg(max_bound + a);
  const int res = a == 0 ? X : (a == 1 ? Y : Z);
  const int64_t first =
      ((int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * kPerWarp;
  const Idx dz = C;
  const Idx dy = (Idx)Z * C;
  const Idx dx = (Idx)Y * Z * C;
  float p = first + q < N ? __ldg(pts + 3 * (first + q) + a) : 0.0f;
  for (int it = 0; it < kIters; ++it) {
    const int64_t n0 = first + (int64_t)it * kGroup;
    if (n0 >= N) break;                       // the same for the whole warp
    const int64_t n = n0 + q;
    const tpu3d::Axis ax = tpu3d::corner_axis(lo, hi, p, res);
    const bool inside = ((__ballot_sync(kFull, ax.inside) >> src) & 7u) == 7u;
    const float fx = __shfl_sync(kFull, ax.f, src);
    const float fy = __shfl_sync(kFull, ax.f, src + 1);
    const float fz = __shfl_sync(kFull, ax.f, src + 2);
    const Idx ix = __shfl_sync(kFull, ax.i0, src);
    const Idx iy = __shfl_sync(kFull, ax.i0, src + 1);
    const Idx iz = __shfl_sync(kFull, ax.i0, src + 2);
    const Idx row = ((ix * Y + iy) * Z + iz) * C;
    // the next group's coordinate, before this group's gathers and lerps
    if (it + 1 < kIters && n + kGroup < N) p = __ldg(pts + 3 * (n + kGroup) + a);
    if (n >= N) continue;
    if (j == 0) in_bounds[n] = inside ? 1 : 0;
    const float m = inside ? 1.0f : 0.0f;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int ch = (j + kSlot * r) * V;
      if (ch < C) {
        // corner k in zyx bit order (c000, c001, ..., c111), as _lerp8
        T c[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          c[k] = Lane<V>::load(grid + (row + ((k & 4) ? dx : 0) + ((k & 2) ? dy : 0) +
                                       ((k & 1) ? dz : 0) + ch));
        const T c00 = lerp_rn(c[0], c[1], fz);
        const T c01 = lerp_rn(c[2], c[3], fz);
        const T c10 = lerp_rn(c[4], c[5], fz);
        const T c11 = lerp_rn(c[6], c[7], fz);
        const T c0 = lerp_rn(c00, c01, fy);
        const T c1 = lerp_rn(c10, c11, fy);
        Lane<V>::store(out + ((Idx)n * C + ch), mask_rn(lerp_rn(c0, c1, fx), m));
      }
    }
  }
}

template <int V>
void launch(unsigned blocks, cudaStream_t s, bool idx32, const float* grid,
            const float* min_bound, const float* max_bound, const float* pts, float* out,
            unsigned char* in_bounds, int X, int Y, int Z, int C, int64_t N) {
  if (idx32) {
    trilinear_kernel<V, int><<<blocks, kThreads, 0, s>>>(grid, min_bound, max_bound, pts, out,
                                                        in_bounds, X, Y, Z, C, N);
  } else {
    trilinear_kernel<V, int64_t><<<blocks, kThreads, 0, s>>>(
        grid, min_bound, max_bound, pts, out, in_bounds, X, Y, Z, C, N);
  }
}

}  // namespace

// The launch's arguments in one packed block (kernels/trilinear.py packs
// them with struct "7Qq6i"): grid (X, Y, Z, C) and out (N, C) f32,
// contiguous; vec != 0 takes the float4 path (C % 4 == 0, grid and out
// 16-B aligned); idx32 != 0 when X*Y*Z*C and N*C fit in an int32.
struct TrilinearArgs {
  const float* grid;
  const float* min_bound;
  const float* max_bound;
  const float* pts;
  float* out;
  unsigned char* in_bounds;
  void* stream;
  int64_t N;
  int X, Y, Z, C, vec, idx32;
};
static_assert(sizeof(TrilinearArgs) == 88, "layout of struct 7Qq6i");

extern "C" int tpu3d_trilinear(const TrilinearArgs* a) {
  if (a->N > 0) {
    const int64_t blocks = (a->N + kPerBlock - 1) / kPerBlock;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    (a->vec ? launch<4> : launch<1>)((unsigned)blocks, (cudaStream_t)a->stream, a->idx32 != 0,
                                    a->grid, a->min_bound, a->max_bound, a->pts, a->out,
                                    a->in_bounds, a->X, a->Y, a->Z, a->C, a->N);
  }
  return (int)cudaGetLastError();
}
