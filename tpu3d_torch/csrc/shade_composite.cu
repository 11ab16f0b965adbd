// shade_composite_kernel — a render chunk's trilinear values to its colours:
// relu density, degree-2 SH colour, alpha compositing and the background, one
// warp a ray (dense/render.py::render_rays on a forward-only render; the
// plain version is kernels/shade_composite.py::shade_composite_plain).
//
// Replaces no TPU kernel: tpu3d's render_rays_packed (tpu3d/dense/render.py:
// 234) leaves shading and compositing to XLA, which fuses them into the
// jitted render. Written as torch operations (dense/render.py::_shade,
// composite) they are ~50 launches a chunk that pass a dozen times over
// the (N*S, 28) f32 values and their (N*S, 3) and (N, S) intermediates.
//
// What bounds it: bytes. Per sample it reads 112 B of values, the 1-B
// in-box flag and the 4-B depth (a cascade a second 113 B), for ~90 FLOP;
// per ray the direction, the background and the colour. A render chunk of
// 8,192 rays x 192 samples is ~184 MB: >= 55 us at 3.35 TB/s (~110 us for
// a cascade).
//
// The design:
//  - One warp a ray, one sample a lane per round of 32 (6 rounds at S =
//    192). A lane loads its sample's 28 channels as 7 float4 (a row is 112
//    B, 16-byte aligned), so a round reads 3.5 KB contiguous; the cascade
//    base's row is added as it arrives. Nothing is written but the colour.
//  - The SH basis (8 direction products) is formed once a ray from its
//    direction, with eval_sh's roundings: the values the expanded
//    per-sample directions give.
//  - Transmittance: the exclusive product of 1 - alpha + 1e-10 along the
//    ray, as a Hillis-Steele scan over the round's lanes (shfl_up), times
//    the product carried from the rounds before. Lanes past the ray's last
//    sample take the factor 1 and alpha 0. Each partial product carries its
//    rounding error (fma's exact remainder), so T is the exact product
//    rounded once, near the CPU's cumprod (which accumulates in double);
//    an f32 scan's ~200 roundings differ from it by up to ~3e-6 a pixel.
//  - Sums in a fixed order: each lane adds its rounds in order, then the
//    lanes combine by an xor butterfly (16, 8, 4, 2, 1), so a pixel repeats
//    bit for bit from launch to launch.
//  - Every sample is kept: no early termination at small transmittance.
// Each product and sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn: no FMA contraction), as the eager path's separate operations
// are, and exp is expf, the function torch's exp calls on the card; only the
// transmittance's carried error and the sums' association differ from the
// eager path. Everything is f32.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRays = kThreads / 32;   // rays (warps) a block
constexpr int kC = 28;                 // 1 density + 3 colours x 9 SH
constexpr unsigned kAll = 0xffffffffu;
// Real SH degree-2 constants, as dense/grid.py rounds them to f32.
constexpr float kC0 = 0.282095f, kC1 = 0.488603f;
constexpr float kC20 = 1.092548f, kC21 = 1.092548f, kC22 = 0.315392f, kC23 = 1.092548f,
                kC24 = 0.546274f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// eval_sh of one colour's 9 coefficients k with the ray's basis b1..b8,
// term by term in eval_sh's order and signs.
__device__ __forceinline__ float sh(const float* k, const float* b) {
  float s = mul(kC0, k[0]);
  s = sub(s, mul(b[0], k[1]));
  s = add(s, mul(b[1], k[2]));
  s = sub(s, mul(b[2], k[3]));
  s = add(s, mul(b[3], k[4]));
  s = sub(s, mul(b[4], k[5]));
  s = add(s, mul(b[5], k[6]));
  s = sub(s, mul(b[6], k[7]));
  return add(s, mul(b[7], k[8]));
}

// A product carried with its rounding error, h + l: the error of h1 h2 is
// exact by fma (a deliberate one), the cross terms are rounded, and the
// transmittance is h + l rounded once, as if the product were taken in
// twice the precision.
struct Prod {
  float h, l;
};

__device__ __forceinline__ Prod pmul(Prod a, Prod b) {
  const float p = mul(a.h, b.h);
  return Prod{p, add(fmaf(a.h, b.h, -p), add(mul(a.h, b.l), mul(a.l, b.h)))};
}

__device__ __forceinline__ Prod shfl_up(Prod v, int off) {
  return Prod{__shfl_up_sync(kAll, v.h, off), __shfl_up_sync(kAll, v.l, off)};
}

__device__ __forceinline__ float4 mask4(float4 v, float m) {
  return make_float4(mul(v.x, m), mul(v.y, m), mul(v.z, m), mul(v.w, m));
}

template <bool kCascade>
__global__ void __launch_bounds__(kThreads)
shade_composite_kernel(const float* __restrict__ vals, const uint8_t* __restrict__ in_b,
                       const float* __restrict__ bvals, const uint8_t* __restrict__ bin_b,
                       const float* __restrict__ z, const float* __restrict__ rays_d,
                       const float* __restrict__ bg, float* __restrict__ out, int64_t n,
                       int S, int white) {
  const int lane = threadIdx.x & 31;
  const int64_t ray = (int64_t)blockIdx.x * kRays + (threadIdx.x >> 5);
  if (ray >= n) return;   // the whole warp

  const float x = __ldg(rays_d + 3 * ray), y = __ldg(rays_d + 3 * ray + 1),
              zd = __ldg(rays_d + 3 * ray + 2);
  const float xx = mul(x, x), yy = mul(y, y);
  const float b[8] = {mul(kC1, y), mul(kC1, zd), mul(kC1, x), mul(mul(kC20, x), y),
                      mul(mul(kC21, y), zd),
                      mul(kC22, sub(sub(mul(mul(2.0f, zd), zd), xx), yy)),
                      mul(mul(kC23, x), zd), mul(kC24, sub(xx, yy))};

  const int64_t row0 = ray * S;
  const float* zr = z + row0;
  Prod carry{1.0f, 0.0f};
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_w = 0.0f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    float f = 1.0f, alpha = 0.0f, r = 0.0f, g = 0.0f, bl = 0.0f;
    if (s < S) {
      const int64_t row = row0 + s;
      const float4* vp = reinterpret_cast<const float4*>(vals + row * kC);
      float v[kC];
      float m;
      if constexpr (kCascade) {
        const float4* bp = reinterpret_cast<const float4*>(bvals + row * kC);
        const float dm = in_b[row] ? 1.0f : 0.0f, bm = bin_b[row] ? 1.0f : 0.0f;
#pragma unroll
        for (int k = 0; k < kC / 4; ++k) {
          const float4 d4 = mask4(__ldg(vp + k), dm), b4 = mask4(__ldg(bp + k), bm);
          v[4 * k] = add(b4.x, d4.x);
          v[4 * k + 1] = add(b4.y, d4.y);
          v[4 * k + 2] = add(b4.z, d4.z);
          v[4 * k + 3] = add(b4.w, d4.w);
        }
        m = 1.0f;
      } else {
#pragma unroll
        for (int k = 0; k < kC / 4; ++k) {
          const float4 d4 = __ldg(vp + k);
          v[4 * k] = d4.x;
          v[4 * k + 1] = d4.y;
          v[4 * k + 2] = d4.z;
          v[4 * k + 3] = d4.w;
        }
        m = in_b[row] ? 1.0f : 0.0f;
      }
      const float sigma = mul(v[0] < 0.0f ? 0.0f : v[0], m);   // relu keeps a NaN
      r = mul(sh(v + 1, b), m);
      g = mul(sh(v + 10, b), m);
      bl = mul(sh(v + 19, b), m);
      const float zs = __ldg(zr + s);
      const float delta = s + 1 < S ? sub(__ldg(zr + s + 1), zs) : 1e10f;
      alpha = sub(1.0f, expf(mul(-sigma, delta)));
      f = add(sub(1.0f, alpha), 1e-10f);
    }
    // Inclusive product over the round's lanes, then shifted by one lane.
    Prod p{f, 0.0f};
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Prod u = shfl_up(p, off);
      if (lane >= off) p = pmul(u, p);
    }
    Prod ex = shfl_up(p, 1);
    if (lane == 0) ex = Prod{1.0f, 0.0f};
    const Prod t = pmul(carry, ex);
    const float w = mul(add(t.h, t.l), alpha);
    carry = pmul(carry, Prod{__shfl_sync(kAll, p.h, 31), __shfl_sync(kAll, p.l, 31)});
    acc_r = add(acc_r, mul(w, r));
    acc_g = add(acc_g, mul(w, g));
    acc_b = add(acc_b, mul(w, bl));
    acc_w = add(acc_w, w);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc_r = add(acc_r, __shfl_xor_sync(kAll, acc_r, off));
    acc_g = add(acc_g, __shfl_xor_sync(kAll, acc_g, off));
    acc_b = add(acc_b, __shfl_xor_sync(kAll, acc_b, off));
    acc_w = add(acc_w, __shfl_xor_sync(kAll, acc_w, off));
  }
  if (lane < 3) {
    float c = lane == 0 ? acc_r : lane == 1 ? acc_g : acc_b;
    if (bg != nullptr) {
      c = add(c, mul(sub(1.0f, acc_w), __ldg(bg + 3 * ray + lane)));
    } else if (white) {
      c = sub(add(c, 1.0f), acc_w);
    }
    out[3 * ray + lane] = c;
  }
}

}  // namespace

// vals, bvals: (n*S, 28) f32, 16-byte aligned; in_b, bin_b: (n*S,) bool;
// bvals and bin_b null without a cascade base; z: (n, S); rays_d: (n, 3);
// bg: (n, 3) or null (then white 1 composites white, 0 nothing); out: (n,
// 3). All contiguous, on the stream's device.
extern "C" int tpu3d_shade_composite(const float* vals, const uint8_t* in_b, const float* bvals,
                                     const uint8_t* bin_b, const float* z, const float* rays_d,
                                     const float* bg, float* out, int64_t n, int S, int white,
                                     void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n + kRays - 1) / kRays);
  const cudaStream_t st = (cudaStream_t)stream;
  if (bvals != nullptr) {
    shade_composite_kernel<true><<<blocks, kThreads, 0, st>>>(vals, in_b, bvals, bin_b, z,
                                                              rays_d, bg, out, n, S, white);
  } else {
    shade_composite_kernel<false><<<blocks, kThreads, 0, st>>>(vals, in_b, nullptr, nullptr, z,
                                                               rays_d, bg, out, n, S, white);
  }
  return (int)cudaGetLastError();
}
