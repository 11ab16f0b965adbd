// orient_desc_kernel — per keypoint: the dominant orientation from an 11x11
// gradient histogram, then the theta-rotated 16x16 descriptor samples.
//
// Replaces the TPU kernel tpu3d/kernels/orient_desc.py::orient_desc_samples
// (body _kernel). There each grid instance DMAs a 96x256 window of both
// gradient planes into VMEM, samples it with bilinear-weights-as-matmul,
// builds the 36-bin histogram as a one-hot matmul and smooths it with a
// circulant matmul, because the TPU has no cheap gather or scatter. On
// Hopper gathers are cheap, so one warp takes one keypoint and a block of
// eight warps takes eight; each warp keeps its votes and bins in its own
// shared arrays and synchronises with __syncwarp alone:
//
//   1. four rounds of 32 lanes take the 121 orientation samples (read-only
//      path) and leave each one's bin and two weighted votes in shared
//      memory;
//   2. lane j sums bin j (lanes 0-3 also bin j + 32) over the 121 votes in
//      ascending sample order, each vote a broadcast read — a fixed order,
//      no float atomics, so a near tie between two bins resolves the same
//      way on every run;
//   3. the lanes smooth the histogram with the [1,2,3,2,1]/9 circulant,
//      find the first maximum by a butterfly of shuffles and each fit the
//      parabolic peak: theta, in every lane;
//   4. eight rounds of 32 lanes take the rotated descriptor samples and
//      write gxs, gys with coalesced stores; lane 0 writes theta.
//
// What bounds it: bytes. Per keypoint it reads 377 bilinear cells of two
// planes (the cells of one keypoint overlap, so after L1 the traffic is
// the touched texels once) and writes (2 * 256 + 1) floats; its arithmetic
// is a few thousand flops. A first version gave each keypoint a block of
// 256 threads, most of them idle outside phases 1 and 4 and waiting at
// three block barriers, so too few keypoints were in flight to hide the
// gathers' latency; a warp per keypoint puts 8x more keypoints on an SM
// and no lane waits for another warp.
//
// Semantics are those of the plain PyTorch version
// (kernels/orient_desc.py::orient_desc_samples_plain): tpu3d's gather
// sampling (features/descriptor.py::_bilinear: base clipped to [0, H-2] x
// [0, W-2] of the level, coordinates clamped to the keypoint's octave
// rectangle first), _atan2_poly in the histogram, the first maximum as the
// peak, the parabolic offset clipped to +-0.5. The Pallas kernel's 96x256
// window is a VMEM tiling device with no counterpart here. The 11x11
// offsets and gaussian weights come from the wrapper as a table, built in
// numpy float32 as tpu3d builds them. Every product and sum is rounded as
// written (__fmul_rn / __fadd_rn: no FMA contraction), so the kernel and
// the plain version differ only where sincosf and PyTorch's sin/cos do.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ORI_N = 121;
constexpr int DESC_N = 256;
constexpr int HIST = 36;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// tpu3d/kernels/orient_desc.py::_atan2_poly, operation for operation.
__device__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const float hi = fmaxf(ax, ay);
  const float lo = fminf(ax, ay);
  const float z = __fdiv_rn(lo, fmaxf(hi, 1e-30f));
  const float z2 = mul(z, z);
  float p = add(-0.0851330f, mul(z2, 0.0208351f));
  p = add(0.1801410f, mul(z2, p));
  p = add(-0.3302995f, mul(z2, p));
  p = add(0.9998660f, mul(z2, p));
  float a = mul(z, p);
  if (ay > ax) a = sub(1.57079632679489662f, a);
  if (x < 0.0f) a = sub(3.14159265358979324f, a);
  return y < 0.0f ? -a : a;
}

// Bilinear sample of both planes at (y, x) on level l, with the gather
// semantics and rounding of patch_sample_kernel.
__device__ __forceinline__ void sample2(const float* __restrict__ gx,
                                        const float* __restrict__ gy, int64_t lbase,
                                        int H, int W, float y, float x, float* ox,
                                        float* oy) {
  const float y0 = floorf(y);
  const float x0 = floorf(x);
  const float wy = sub(y, y0);
  const float wx = sub(x, x0);
  const int y0i = min(max((int)y0, 0), H - 2);
  const int x0i = min(max((int)x0, 0), W - 2);
  const float ry = sub(1.0f, wy);
  const float rx = sub(1.0f, wx);
  const int64_t base = lbase + (int64_t)y0i * W + x0i;
  const float* img[2] = {gx, gy};
  float out[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float v00 = __ldg(img[c] + base);
    const float v01 = __ldg(img[c] + base + 1);
    const float v10 = __ldg(img[c] + base + W);
    const float v11 = __ldg(img[c] + base + W + 1);
    float acc = mul(mul(v00, ry), rx);
    acc = add(acc, mul(mul(v01, ry), wx));
    acc = add(acc, mul(mul(v10, wy), rx));
    acc = add(acc, mul(mul(v11, wy), wx));
    out[c] = acc;
  }
  *ox = out[0];
  *oy = out[1];
}

// Each warp's shared state: its keypoint's 121 votes and 36 bins.
struct __align__(16) Vote {
  float w0, w1;
  int bin, pad;   // 16 bytes: one broadcast load per vote
};
constexpr int WARPS = 8;   // keypoints per block

__global__ void __launch_bounds__(32 * WARPS)
orient_desc_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
                   const float* __restrict__ ky, const float* __restrict__ kx,
                   const int* __restrict__ lvl, const float* __restrict__ sigma,
                   const float* __restrict__ ymax, const float* __restrict__ xmax,
                   const float* __restrict__ table, float* __restrict__ gxs,
                   float* __restrict__ gys, float* __restrict__ theta, int L, int H,
                   int W, int K) {
  __shared__ Vote s_vote[WARPS][ORI_N];
  __shared__ float s_hist[WARPS][HIST];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * WARPS + warp;
  if (k >= K) return;   // a whole warp; no block-wide barrier follows
  Vote* vote = s_vote[warp];
  float* hist = s_hist[warp];
  const float kyk = __ldg(ky + k);
  const float kxk = __ldg(kx + k);
  const float sg = __ldg(sigma + k);
  const float ym = __ldg(ymax + k);
  const float xm = __ldg(xmax + k);
  const int l = min(max(__ldg(lvl + k), 0), L - 1);
  const int64_t lbase = (int64_t)l * H * W;

  // 1. orientation samples, 4 rounds of 32: table rows are (dy, dx,
  // weight), 121 each.
  const float sp = mul(0.9f, sg);
#pragma unroll
  for (int t = lane; t < ORI_N; t += 32) {
    const float ys = fminf(fmaxf(add(kyk, mul(__ldg(table + t), sp)), 0.0f), ym);
    const float xs = fminf(fmaxf(add(kxk, mul(__ldg(table + ORI_N + t), sp)), 0.0f), xm);
    float sx, sy;
    sample2(gx, gy, lbase, H, W, ys, xs, &sx, &sy);
    const float mag = mul(__fsqrt_rn(add(mul(sx, sx), mul(sy, sy))), __ldg(table + 2 * ORI_N + t));
    const float ang = atan2_poly(sy, sx);
    const float binf = mul(add(__fdiv_rn(ang, 6.28318530717958648f), 0.5f), 36.0f);
    const float fl = floorf(binf);
    int b0 = (int)fl % HIST;
    if (b0 < 0) b0 += HIST;
    const float frac = sub(binf, fl);
    vote[t].w0 = mul(mag, sub(1.0f, frac));
    vote[t].w1 = mul(mag, frac);
    vote[t].bin = b0;
  }
  __syncwarp();

  // 2. the soft histogram: bin j = sum of the w0 votes that land on j plus
  // the sum of the w1 votes that land on j - 1, each in ascending sample
  // order. Lane j owns bin j, lanes 0-3 bin j + 32 too; every lane reads
  // each vote (a broadcast). A lane's second pair of sums matches no
  // vote when j + 32 > 36 and is dropped when j + 32 = 36.
  {
    const int jm = (lane + HIST - 1) % HIST;
    float h0 = 0.0f, h1 = 0.0f, g0 = 0.0f, g1 = 0.0f;
#pragma unroll 11
    for (int i = 0; i < ORI_N; ++i) {
      const Vote v = vote[i];
      if (v.bin == lane) h0 = add(h0, v.w0);
      if (v.bin == jm) h1 = add(h1, v.w1);
      if (v.bin == lane + 32) g0 = add(g0, v.w0);
      if (v.bin == lane + 31) g1 = add(g1, v.w1);
    }
    hist[lane] = add(h0, h1);
    if (lane + 32 < HIST) hist[lane + 32] = add(g0, g1);
  }
  __syncwarp();

  // 3. circulant smoothing, the first maximum by a shuffle reduction (every
  // lane ends with it), the parabolic peak: every lane computes theta.
  const float c0 = (float)(3.0 / 9.0), c1 = (float)(2.0 / 9.0), c2 = (float)(1.0 / 9.0);
  float sm[2];
  float best = -1.0f;
  int arg = HIST;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = lane + 32 * r;
    sm[r] = 0.0f;
    if (j < HIST) {
      float s = mul(c2, hist[(j + HIST - 2) % HIST]);
      s = add(s, mul(c1, hist[(j + HIST - 1) % HIST]));
      s = add(s, mul(c0, hist[j]));
      s = add(s, mul(c1, hist[(j + 1) % HIST]));
      s = add(s, mul(c2, hist[(j + 2) % HIST]));
      sm[r] = s;
      if (s > best) {   // r ascending: the first of equal values stays
        best = s;
        arg = j;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  const int peak = arg;
  __syncwarp();   // every lane has read the raw bins
  hist[lane] = sm[0];
  if (lane + 32 < HIST) hist[lane + 32] = sm[1];
  __syncwarp();
  const float hp = hist[peak];
  const float hl = hist[(peak + HIST - 1) % HIST];
  const float hr = hist[(peak + 1) % HIST];
  const float denom = add(sub(hl, mul(2.0f, hp)), hr);
  float off = fabsf(denom) > 1e-9f ? __fdiv_rn(mul(0.5f, sub(hl, hr)), denom) : 0.0f;
  off = fminf(fmaxf(off, -0.5f), 0.5f);
  const float binp = add((float)peak, off);
  const float th = mul(mul(sub(__fdiv_rn(binp, 36.0f), 0.5f), 2.0f), 3.14159265358979324f);

  // 4. the theta-rotated 16x16 descriptor grid, 8 rounds of 32 samples
  // (each round's stores are one coalesced 128-byte line per plane).
  float st, ct;
  sincosf(th, &st, &ct);
  const float spacing = mul(0.75f, sg);
  float* ogx = gxs + (int64_t)k * DESC_N;
  float* ogy = gys + (int64_t)k * DESC_N;
#pragma unroll 2
  for (int t = lane; t < DESC_N; t += 32) {
    const float dyg = (float)(t / 16) - 7.5f;
    const float dxg = (float)(t % 16) - 7.5f;
    const float dx = mul(sub(mul(ct, dxg), mul(st, dyg)), spacing);
    const float dy = mul(add(mul(st, dxg), mul(ct, dyg)), spacing);
    const float ys = fminf(fmaxf(add(kyk, dy), 0.0f), ym);
    const float xs = fminf(fmaxf(add(kxk, dx), 0.0f), xm);
    float sx, sy;
    sample2(gx, gy, lbase, H, W, ys, xs, &sx, &sy);
    ogx[t] = sx;
    ogy[t] = sy;
  }
  if (lane == 0) theta[k] = th;
}

}  // namespace

// The launch's arguments in one packed block (kernels/orient_desc.py packs
// them with struct "13Q4i"): one pointer crosses ctypes instead of
// seventeen converted arguments.
struct OrientDescArgs {
  const float* gx;
  const float* gy;
  const float* ky;
  const float* kx;
  const int* lvl;
  const float* sigma;
  const float* ymax;
  const float* xmax;
  const float* table;
  float* gxs;
  float* gys;
  float* theta;
  void* stream;
  int L, H, W, K;
};
static_assert(sizeof(OrientDescArgs) == 120, "layout of struct 13Q4i");

extern "C" int tpu3d_orient_desc(const OrientDescArgs* a) {
  if (a->K > 0) {
    const unsigned blocks = (unsigned)((a->K + WARPS - 1) / WARPS);
    orient_desc_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)a->stream>>>(
        a->gx, a->gy, a->ky, a->kx, a->lvl, a->sigma, a->ymax, a->xmax, a->table, a->gxs,
        a->gys, a->theta, a->L, a->H, a->W, a->K);
  }
  return (int)cudaGetLastError();
}
