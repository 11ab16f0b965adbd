// trilinear_grad_kernel — the grid gradient of trilinear sampling: an
// 8-corner scatter-add of the (N, C) cotangents into an (X, Y, Z, C) grid,
// with every element summed in one fixed order, so that the result is the
// same bits on every run and equals the plain version's
// (kernels/trilinear_grad.py) on the CPU.
//
// Replaces the TPU kernel tpu3d/kernels/trilinear_grad.py::scatter_grad
// (body _scatter_kernel, :73/:157). tpu3d is conflict-free by construction:
// it sorts the samples into (x-slab, y-block) bins of their base cell
// (lax.sort_key_val, :125; offsets by searchsorted, :130), and each TPU grid
// instance, run in sequence, owns one output block in VMEM, with a y-halo
// row carried to the next instance. Hopper runs its blocks in parallel and
// in no order, so nothing can be carried from block to block; the design
// keeps tpu3d's binning and its owner-computes rule and drops the carry:
//
//  - trilinear_grad_keys (one thread a sample) runs the forward's corner
//    setup (trilinear_common.cuh, so the scatter hits exactly the cells the
//    gather read) and writes the sample's key, the flat index of its base
//    cell (X*Y*Z, past every cell, for a sample outside the box: its
//    cotangent is masked, as scatter_grad's g * in_bounds, :177), and its 8
//    corner weights wx_a * wy_b * wz_c (wx_0 = 1 - fx, wx_1 = fx),
//    multiplied in that order, each product rounded on its own.
//  - The wrapper sorts the keys with a stable sort (the samples of one
//    cell stay in sample order) and finds each (x, y) column's first
//    sorted position by searchsorted.
//  - trilinear_grad_kernel: a block owns up to kTileZ rows of one (x, y)
//    column and writes every one of them, zeros included, so the gradient
//    needs no zero fill and each byte of it is written once. A row's
//    contributions come from the base cells (x-a, y-b, z-c) of its 8
//    corners k = 4a + 2b + c, which lie in 4 neighbouring columns. The
//    block finds where each of those cells' runs of samples starts (a
//    binary search inside each column's sorted range, the 4 columns' in
//    step), stores the rows no run reaches as zeros at once and lists the
//    others. A warp then takes one listed row at a time: its stream of
//    contributions is its 8 runs in corner order, each in sorted (so
//    sample) order, the plain version's order. The warp moves 32 of them at
//    a time into shared memory (lane e: its sample, weight and cotangent
//    row), and lane q < C/4 (q < C on the scalar path) adds them to its 4
//    channels in stream order, from +0.0f, each product __fmul_rn(w_k, g)
//    and each sum __fadd_rn (no FMA contraction), then stores the row once.
//    No atomics, no read-modify-write: the order does not depend on
//    scheduling, the launch or the allocations.
//
// Samples outside the box are left out of the sums where the plain version
// adds their masked cotangents (+-0.0 times the weight) to clamped rows;
// a sum that starts at +0.0f never becomes -0.0, and adding +-0.0 to it
// changes nothing, so the two agree bit for bit for finite cotangents.
//
// What bounds it: bytes. The full call writes the whole gradient once
// (X*Y*Z*C*4 B: 1.879 GB at 256^3 x 28) and reads the cotangents (N*C*4 B,
// 44 MB for one training step's 393,216 samples) and the points (N*12 B):
// >= 0.58 ms at 3.35 TB/s. The keys, weights, sort and column starts add a
// few tens of MB. Most rows have no contribution (134k of 16.8M rows at
// one training step's shape), so the kernel is a stream of coalesced 16-B
// stores (a column's Z*C floats are contiguous); the listed rows take from
// 1 to ~4,900 contributions (samples crowd the cells near the camera), and
// a row's adds are one chain, so a row is one warp's and not one thread's:
// its loads come 32 at a time, the next 32 loading while these are added.
// On an H100 (PERF.md) the kernel takes 0.86 ms at one training step's
// shape, where the same grid storing zeros alone takes 0.57 (the byte
// bound): the listed rows' chains of dependent loads (sample, then its
// row) take the rest. Designs measured slower there: a thread per (row, 4
// channels) walking its runs in device memory (2.0 ms), the block's
// samples staged in shared memory corner by corner (1.18 ms), the
// cotangents gathered into sorted order by index_select first (0.48 ms of
// gather alone), this design without the loads ahead (0.91 ms) and with
// the samples of a second batch ahead too (0.97 ms: 95 registers).
#include <type_traits>

#include "trilinear_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileZ = 256;   // rows of one column a block owns, at most (<= kThreads)
constexpr int kMaxC = 32;     // channels, at most (<= 32: a warp's lane per channel)

__global__ void __launch_bounds__(kThreads)
trilinear_grad_keys(const float* __restrict__ min_bound,
                    const float* __restrict__ max_bound,
                    const float* __restrict__ pts, int* __restrict__ keys,
                    float* __restrict__ weights, int X, int Y, int Z, int64_t N) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const tpu3d::Corner cs = tpu3d::corner_setup(min_bound, max_bound, pts + 3 * n, X, Y, Z);
  keys[n] = cs.inside ? (int)cs.base : X * Y * Z;
  const float wx[2] = {__fsub_rn(1.0f, cs.f[0]), cs.f[0]};
  const float wy[2] = {__fsub_rn(1.0f, cs.f[1]), cs.f[1]};
  const float wz[2] = {__fsub_rn(1.0f, cs.f[2]), cs.f[2]};
  float w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    w[k] = __fmul_rn(__fmul_rn(wx[k >> 2], wy[(k >> 1) & 1]), wz[k & 1]);
  }
  float4* dst = reinterpret_cast<float4*>(weights + 8 * n);
  dst[0] = make_float4(w[0], w[1], w[2], w[3]);
  dst[1] = make_float4(w[4], w[5], w[6], w[7]);
}

// acc + w * g per channel, the product and the sum each rounded on its own
__device__ __forceinline__ float add_scaled(float acc, float w, float g) {
  return __fadd_rn(acc, __fmul_rn(w, g));
}
__device__ __forceinline__ float4 add_scaled(float4 acc, float w, float4 g) {
  return make_float4(add_scaled(acc.x, w, g.x), add_scaled(acc.y, w, g.y),
                     add_scaled(acc.z, w, g.z), add_scaled(acc.w, w, g.w));
}

// g (N, C) and weights (N, 8): the cotangents and pass 1's corner weights;
// keys: the sorted keys and perm the sample of each sorted position;
// col_start (X*Y + 1): the first sorted position of each (x, y) column's
// keys [col*Z, col*Z + Z). Block b owns rows z0 .. z0 + tz - 1 of column
// b / tiles_z.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
trilinear_grad_kernel(const float* __restrict__ g, const float* __restrict__ weights,
                      const int* __restrict__ keys, const int64_t* __restrict__ perm,
                      const int* __restrict__ col_start, float* __restrict__ out, int Y, int Z,
                      int C, int tiles_z, int tile_z) {
  using T = typename std::conditional<kVec, float4, float>::type;
  constexpr int kQ = kVec ? kMaxC / 4 : kMaxC;   // items a row splits into, at most
  constexpr int kWarps = kThreads / 32;
  // start[ab][j]: the first sorted position whose key is >= that of cell
  // (x - a, y - b, clamp(z0 - 1 + j, 0, Z - 1)), ab = 2a + b; the run of
  // base cell (x - a, y - b, zb) is [start[ab][zb - z0 + 1], start[ab][zb - z0 + 2]),
  // empty for zb = -1 and zb = Z - 1 (no base cell lies there) by the clamp.
  __shared__ int start[4][kTileZ + 2];
  __shared__ bool busy[kTileZ];
  __shared__ int rows[kTileZ], n_busy;     // the rows with a contribution, in order
  __shared__ int warp_count[kWarps];
  __shared__ T s_g[kWarps][32][kQ + 1];    // a warp's batch of cotangent rows (padded: banks)
  __shared__ float s_w[kWarps][32];        // and their weights
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t col = blockIdx.x / tiles_z;
  const int z0 = (int)(blockIdx.x - col * tiles_z) * tile_z;
  const int tz = min(tile_z, Z - z0);
  const int x = (int)(col / Y), y = (int)(col - (int64_t)x * Y);
  const int cq = kVec ? C / 4 : C;   // items a row splits into
  // A binary search in each of the 4 columns' sorted ranges at once, so
  // that a thread has 4 independent loads in flight a step.
  for (int j = tid; j < tz + 2; j += kThreads) {
    int lo[4], hi[4], want[4];
#pragma unroll
    for (int ab = 0; ab < 4; ++ab) {
      const int cx = x - (ab >> 1), cy = y - (ab & 1);
      const bool on = cx >= 0 && cy >= 0;
      const int c = on ? cx * Y + cy : 0;
      lo[ab] = on ? col_start[c] : 0;
      hi[ab] = on ? col_start[c + 1] : 0;
      want[ab] = c * Z + min(max(z0 - 1 + j, 0), Z - 1);
    }
    bool more = true;
    while (more) {
      more = false;
#pragma unroll
      for (int ab = 0; ab < 4; ++ab) {
        if (lo[ab] < hi[ab]) {
          const int mid = (lo[ab] + hi[ab]) >> 1;
          if (__ldg(keys + mid) < want[ab]) lo[ab] = mid + 1; else hi[ab] = mid;
          more = more || lo[ab] < hi[ab];
        }
      }
    }
#pragma unroll
    for (int ab = 0; ab < 4; ++ab) start[ab][j] = lo[ab];
  }
  __syncthreads();
  // Which rows have a contribution, and their list in row order (a ballot
  // per warp, then the warps' counts in order: kTileZ <= kThreads).
  bool mine = false;
  if (tid < tz) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int ab = k >> 1, j = tid + 1 - (k & 1);
      mine = mine || start[ab][j] < start[ab][j + 1];
    }
    busy[tid] = mine;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, mine);
  if ((tid & 31) == 0) warp_count[tid >> 5] = __popc(ballot);
  __syncthreads();
  if (mine) {
    int at = __popc(ballot & ((1u << (tid & 31)) - 1u));
    for (int w = 0; w < (tid >> 5); ++w) at += warp_count[w];
    rows[at] = tid;
  }
  if (tid == 0) {
    int n = 0;
    for (int w = 0; w < kWarps; ++w) n += warp_count[w];
    n_busy = n;
  }
  // Rows without a contribution are zeros, stored first.
  T* tile = reinterpret_cast<T*>(out + (col * Z + z0) * C);
  T zero;
  if constexpr (kVec) zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f); else zero = 0.0f;
  for (int it = tid; it < tz * cq; it += kThreads) {
    if (!busy[it / cq]) tile[it] = zero;
  }
  __syncthreads();
  // Then the others, a warp a row. The row's stream of contributions is
  // its 8 corners' runs in corner order, each in sorted order: the plain
  // version's order. The warp takes 32 of them at a time into shared memory
  // (lane e: its sample, weight and cotangent row), and lane q < cq adds
  // them to its channels in that order, while the next 32 load into
  // registers.
  for (int r = warp; r < n_busy; r += kWarps) {
    const int row = rows[r];
    int first[8], end[8], total = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int ab = k >> 1, j = row + 1 - (k & 1);
      first[k] = start[ab][j];
      total += start[ab][j + 1] - first[k];
      end[k] = total;
    }
    T acc = zero;
    T v[kQ];
    float wv = 0.0f;
    // Load element b0 + lane of the stream (if any) into v and wv.
    auto fetch = [&](int b0) {
      const int e = b0 + lane;
      if (e < total) {
        int i = 0, k = 0;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const int from = kk ? end[kk - 1] : 0;
          if (e >= from && e < end[kk]) {
            i = first[kk] + e - from;
            k = kk;
          }
        }
        const int64_t n = __ldg(perm + i);
        const T* src = reinterpret_cast<const T*>(g + n * C);
#pragma unroll
        for (int qq = 0; qq < kQ; ++qq) {
          if (qq < cq) v[qq] = __ldg(src + qq);
        }
        wv = __ldg(weights + 8 * n + k);
      }
    };
    fetch(0);
    for (int b0 = 0; b0 < total; b0 += 32) {
      if (b0 + lane < total) {
        s_w[warp][lane] = wv;
#pragma unroll
        for (int qq = 0; qq < kQ; ++qq) {
          if (qq < cq) s_g[warp][lane][qq] = v[qq];
        }
      }
      __syncwarp();
      fetch(b0 + 32);
      if (lane < cq) {
        const int m = min(32, total - b0);
#pragma unroll 8
        for (int e2 = 0; e2 < m; ++e2) acc = add_scaled(acc, s_w[warp][e2], s_g[warp][e2][lane]);
      }
      __syncwarp();
    }
    if (lane < cq) tile[row * cq + lane] = acc;
  }
}

}  // namespace

// Pass 1. min_bound, max_bound (3,), pts (N, 3) f32; keys (N,) i32 and
// weights (N, 8) f32 (16-B aligned) written. X*Y*Z < 2^31.
extern "C" int tpu3d_trilinear_grad_keys(const float* min_bound, const float* max_bound,
                                         const float* pts, int* keys, float* weights, int X,
                                         int Y, int Z, int64_t N, void* stream) {
  if (N > 0) {
    const int64_t blocks = (N + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    trilinear_grad_keys<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        min_bound, max_bound, pts, keys, weights, X, Y, Z, N);
  }
  return (int)cudaGetLastError();
}

// Pass 2. g (N, C) f32 and weights (N, 8) from pass 1; keys (N,) i32
// sorted and perm (N,) i64 their stable order; col_start (X*Y + 1,) i32;
// out (X, Y, Z, C) f32, every element written. vec != 0 takes the float4
// path: C % 4 == 0 and g, out 16-B aligned.
extern "C" int tpu3d_trilinear_grad(const float* g, const float* weights, const int* keys,
                                    const int64_t* perm, const int* col_start, float* out,
                                    int X, int Y, int Z, int C, int vec, void* stream) {
  const int tiles_z = (Z + kTileZ - 1) / kTileZ;
  const int tile_z = (Z + tiles_z - 1) / tiles_z;
  const int64_t blocks = (int64_t)X * Y * tiles_z;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (vec) {
    trilinear_grad_kernel<true><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        g, weights, keys, perm, col_start, out, Y, Z, C, tiles_z, tile_z);
  } else {
    trilinear_grad_kernel<false><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        g, weights, keys, perm, col_start, out, Y, Z, C, tiles_z, tile_z);
  }
  return (int)cudaGetLastError();
}
