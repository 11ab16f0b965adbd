// rgbnet_*_kernel — DVGO's colour MLP, Linear(39, 128)-ReLU-Linear(128,
// 128)-ReLU-Linear(128, 3)-sigmoid, over the samples that its equations
// colour (w > tau), forward and backward (dense/dvgo.py::march; the plain
// version is kernels/rgbnet.py::rgbnet_forward_plain / _backward_plain).
//
// Replaces no TPU kernel: tpu3d has no DVGO model. The port ran the MLP by
// cuBLAS over every sample of the step's dense (N, S) layout, 4.57 M rows
// at the dvgo-160 cell's 8,192 rays x 558 samples, of which about a third
// are coloured; the rest went through three layers, their ReLUs and their
// backward only to be multiplied by a zero weight. A cuBLAS product takes
// its row count from the host, and the coloured count changes every step
// and lives on the card: reading it back would break the step's CUDA-graph
// replays. These kernels read the count from device memory, and fold the
// biases, ReLUs, sigmoid, the input's concatenation and their backward
// passes into the same launches.
//
// What bounds it: operations. A coloured row costs 43.5 kFLOP forward and
// 80.1 kFLOP backward (the weights' gradients, the inputs' gradients of
// layers 3 and 2 and of layer 1's 12 k0 columns), against ~2 KB of
// activations saved and read back: ~60 FLOP a byte, far above the card's
// 20 FLOP a byte in f32. Everything is f32 on the CUDA cores (fmaf; no TF32
// anywhere): the step's correctness limits fail at TF32's rounding.
//
// The design:
//  - Compaction: rgbnet_count_kernel counts each 4,096-sample tile's
//    coloured samples; rgbnet_compact_kernel adds the counts of the tiles
//    before its own (integers, so exact in any order), scans its tile and
//    writes the coloured samples' indices in ascending order, and its last
//    block the count, to device memory. No atomics, no host read.
//  - Persistent blocks, one an SM (the weights fill most of its shared
//    memory), walk tiles of compacted rows up to the count read on the
//    card: 128 rows a forward tile, 64 a backward tile.
//  - Forward: gather the tile's k0 (vals[:, 1:]) and each row's ray's
//    27-value view encoding into shared memory, transposed (loaded into
//    registers during the tile before); layer 1 and layer 2 as
//    register-tiled products (8 rows x 8 columns a thread, float4 reads of
//    both operands from shared memory); bias and ReLU in registers; layer 3
//    by a fixed butterfly over the 16 threads that share a row; the sigmoid;
//    c written at the coloured rows of the dense (R, 3) output (zeroed by
//    the wrapper). With autograd, h1 and h2 are saved in compacted rows.
//  - Backward, per tile (its inputs fetched during the tile before, h1 and
//    h2 by cp.async straight into shared memory): gl = g (1 - c) c; gh2 = (gl
//    W3) [h2 > 0] with gw3, gb2, gb3; gw2 += gh2^T h1 (a register tile per
//    thread, held over all the block's tiles); gh1 = (gh2 W2) [h1 > 0]; gw1
//    += gh1^T x and gb1; gk0 = gh1 W1[:, :12] written at the coloured rows
//    of the dense (R, 12) cotangent (zeroed by the wrapper: +0 at every
//    uncoloured row).
//  - Every weight and bias gradient is summed by one thread in a fixed
//    order over the block's tiles, the block's partial lands in its own
//    slot, and rgbnet_reduce_kernel sums the slots in block order: no float
//    atomics, so a step repeats bit for bit.
// A thread's 8 rows (columns) of a 128-wide product are two runs of 4, from
// 4 ty (4 tx) and from 64 + 4 ty (64 + 4 tx): each operand is two float4
// reads, and the 8 threads of a quarter warp read 8 neighbouring float4,
// one a bank group. (Columns 16 apart, stored as 8 neighbours a thread, put
// two threads of a quarter warp on one group: the products waited on shared
// memory.) The forward's transposed h1 tile swizzles its rows so that its
// stores do not collide either.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kK0 = 12, kEmb = 27, kIn = kK0 + kEmb;   // 39 inputs
constexpr int kInPad = 40;
constexpr int kW = 128, kOut = 3;
constexpr int kFwdRows = 128, kBwdRows = 64;
constexpr int kLd = kW + 4;          // a padded 128-wide row in shared memory
constexpr int kLdT = kBwdRows + 4;   // a padded row of gh2's transpose
constexpr int kCompactPer = 16;
constexpr int kCompactTile = kThreads * kCompactPer;
constexpr unsigned kAll = 0xffffffffu;

// The gradients' flat layout: W1, b1, W2, b2, W3, b3, each row-major.
constexpr int kOffW1 = 0;
constexpr int kOffB1 = kOffW1 + kW * kIn;
constexpr int kOffW2 = kOffB1 + kW;
constexpr int kOffB2 = kOffW2 + kW * kW;
constexpr int kOffW3 = kOffB2 + kW;
constexpr int kOffB3 = kOffW3 + kOut * kW;
constexpr int kParams = kOffB3 + kOut;   // 22,019

constexpr int kFwdSmem =
    (kIn * kW + kW * kW + kOut * kW + kW + kW + 4 + kIn * kFwdRows + kW * kW) * 4;
constexpr int kBwdSmem = (kW * kW + kK0 * kLd + kBwdRows * 4 + kBwdRows * kLd + kW * kLdT +
                          2 * kBwdRows * kW + kBwdRows * kInPad) * 4 + kBwdRows * 4;

// The 8 rows (or columns) of a thread's register tile: 4 from ty * 4 and 4
// from 64 + ty * 4.
__device__ __forceinline__ int half_row(int ty, int i) {
  return (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }   // keeps NaN

// acc[i][j] += a[i] b[j] for the 8 x 8 tile, a and b as two float4 each.
__device__ __forceinline__ void outer8(float (&acc)[8][8], float4 a0, float4 a1, float4 b0,
                                       float4 b1) {
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// The block's sum of one int a thread; ``red`` holds kWarps ints.
__device__ __forceinline__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(kAll, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(kThreads)
rgbnet_count_kernel(const uint8_t* __restrict__ mask, int64_t n, int* __restrict__ counts) {
  __shared__ int red[kWarps];
  const int64_t base = (int64_t)blockIdx.x * kCompactTile + threadIdx.x * kCompactPer;
  int c = 0;
#pragma unroll
  for (int e = 0; e < kCompactPer; ++e) c += (base + e < n && mask[base + e]) ? 1 : 0;
  c = block_sum(c, red);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

__global__ void __launch_bounds__(kThreads)
rgbnet_compact_kernel(const uint8_t* __restrict__ mask, int64_t n,
                      const int* __restrict__ counts, int* __restrict__ idx,
                      int* __restrict__ count) {
  __shared__ int red[kWarps];
  __shared__ int warp_excl[kWarps];
  int before = 0;
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += kThreads) before += counts[b];
  before = block_sum(before, red);

  const int64_t base = (int64_t)blockIdx.x * kCompactTile + threadIdx.x * kCompactPer;
  unsigned bits = 0;
#pragma unroll
  for (int e = 0; e < kCompactPer; ++e)
    if (base + e < n && mask[base + e]) bits |= 1u << e;
  const int mine = __popc(bits);
  // The threads' exclusive prefix: a scan in each warp, then the warps'.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kAll, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) {
      warp_excl[w] = s;
      s += red[w];
    }
  }
  __syncthreads();
  int pos = before + warp_excl[warp] + incl - mine;
  for (int e = 0; e < kCompactPer; ++e)
    if (bits & (1u << e)) idx[pos++] = (int)(base + e);
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == kThreads - 1) *count = pos;
}

}  // namespace

struct FwdArgs {
  const float* k0;       // (R, 12) rows at stride ldk: vals[:, 1:]
  const float* emb;      // (R / S, 27) each ray's view encoding
  const int* idx;        // (R,) the coloured rows, ascending; count of them valid
  const int* count;      // (1,) the number of coloured rows
  const float* w1;       // (128, 39)
  const float* b1;       // (128,)
  const float* w2;       // (128, 128)
  const float* b2;       // (128,)
  const float* w3;       // (3, 128)
  const float* b3;       // (3,)
  float* c;              // (R, 3), zeroed: written at the coloured rows
  float* h1;             // (R, 128) compacted, or null
  float* h2;             // (R, 128) compacted, or null
  void* stream;
  int ldk, S, grid, pad;
};
static_assert(sizeof(FwdArgs) == 128, "layout of struct 14Q4i");

struct BwdArgs {
  const float* g;        // (R, 3) the colours' cotangent
  const float* c;        // (R, 3) the forward's colours
  const float* k0;
  const float* emb;
  const int* idx;
  const int* count;
  const float* h1;       // the forward's saved h1
  const float* h2;       // the forward's saved h2
  const float* w1;
  const float* w2;
  const float* w3;
  float* gk0;            // (R, 12), zeroed: written at the coloured rows
  float* part;           // (grid, 22019) each block's partial gradients
  float* out;            // (22019,) the gradients of W1, b1, W2, b2, W3, b3
  void* stream;
  int ldk, S, grid, pad;
};
static_assert(sizeof(BwdArgs) == 136, "layout of struct 15Q4i");

namespace {

// The row of h1's transposed tile that holds column n: its 128 rows XORed
// in groups of 4 by bits 2-4 of n, so that the 8 threads of a quarter warp
// storing 4 rows of 8 neighbouring columns hit 8 different banks.
__device__ __forceinline__ int swz(int n) { return ((n >> 2) & 7) << 2; }

// A 16-byte copy from device to shared memory that bypasses the registers
// (zeros when !ok), and the wait for this thread's copies.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

__global__ void __launch_bounds__(kThreads, 1) rgbnet_forward_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* w1s = sm;                        // [39][128] W1[n][k] at [k][n]
  float* w2s = w1s + kIn * kW;            // [128][128] W2[n][k] at [k][n]
  float* w3s = w2s + kW * kW;             // [3][128]
  float* b1s = w3s + kOut * kW;
  float* b2s = b1s + kW;
  float* b3s = b2s + kW;                  // 4
  float* xt = b3s + 4;                    // [39][128] the tile's inputs, transposed
  float* h1t = xt + kIn * kFwdRows;       // [128][128] h1 transposed, rows at m ^ swz(n)

  const int t = threadIdx.x;
  for (int e = t; e < kW * kIn; e += kThreads) {
    const int n = e / kIn, k = e - n * kIn;
    w1s[k * kW + n] = a.w1[e];
  }
  for (int e = t; e < kW * kW; e += kThreads) w2s[(e & (kW - 1)) * kW + (e >> 7)] = a.w2[e];
  for (int e = t; e < kOut * kW; e += kThreads) w3s[e] = a.w3[e];
  if (t < kW) {
    b1s[t] = a.b1[t];
    b2s[t] = a.b2[t];
  }
  if (t < 4) b3s[t] = t < kOut ? a.b3[t] : 0.0f;

  const int count = *a.count;
  const int tiles = (count + kFwdRows - 1) / kFwdRows;
  const int tx = t & 15, ty = t >> 4;
  // A tile's inputs, row t % 128, columns [0, 20) or [20, 39): loaded into
  // registers during the tile before, stored after its layer 2.
  const int gm = t & (kFwdRows - 1), j0 = t < kFwdRows ? 0 : 20;
  float pre[20];
  auto gather = [&](int tile) {
    const int r = tile * kFwdRows + gm;
    const bool ok = r < count;
    const int i = ok ? __ldg(a.idx + r) : 0;
    const float* kp = a.k0 + (int64_t)i * a.ldk;
    const float* ep = a.emb + (int64_t)(i / a.S) * kEmb;
#pragma unroll
    for (int jj = 0; jj < 20; ++jj) {
      const int j = j0 + jj;
      pre[jj] = (!ok || j >= kIn) ? 0.0f : j < kK0 ? __ldg(kp + j) : __ldg(ep + j - kK0);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int jj = 0; jj < 20; ++jj)
      if (j0 + jj < kIn) xt[(j0 + jj) * kFwdRows + gm] = pre[jj];
  };
  if ((int)blockIdx.x < tiles) {
    gather(blockIdx.x);
    store();
  }
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int base = tile * kFwdRows;
    __syncthreads();

    // acc[i][j]: row half_row(ty, i), column half_row(tx, j).
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll
    for (int k = 0; k < kIn; ++k)
      outer8(acc, ld4(xt + k * kFwdRows + ty * 4), ld4(xt + k * kFwdRows + 64 + ty * 4),
             ld4(w1s + k * kW + tx * 4), ld4(w1s + k * kW + 64 + tx * 4));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = half_row(tx, j);
      const float b = b1s[n];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = relu(acc[i][j] + b);
      float* col = h1t + n * kW;
      st4(col + ((ty * 4) ^ swz(n)), acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      st4(col + ((64 + ty * 4) ^ swz(n)), acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
    }
    if (a.h1 != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = base + half_row(ty, i);
        if (r < count) {
          float* p = a.h1 + (int64_t)r * kW + tx * 4;
          st4(p, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          st4(p + 64, acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
      }
    }
    __syncthreads();
    const bool more = tile + (int)gridDim.x < tiles;
    if (more) gather(tile + gridDim.x);

#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 8
    for (int k = 0; k < kW; ++k) {
      const float* row = h1t + k * kW;
      outer8(acc, ld4(row + ((ty * 4) ^ swz(k))), ld4(row + ((64 + ty * 4) ^ swz(k))),
             ld4(w2s + k * kW + tx * 4), ld4(w2s + k * kW + 64 + tx * 4));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b = b2s[half_row(tx, j)];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = relu(acc[i][j] + b);
    }
    if (a.h2 != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = base + half_row(ty, i);
        if (r < count) {
          float* p = a.h2 + (int64_t)r * kW + tx * 4;
          st4(p, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          st4(p + 64, acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
      }
    }
    // Layer 3: each thread's 8 columns, then the 16 threads of the row group
    // by an xor butterfly (8, 4, 2, 1): a fixed order.
    float p[8][kOut];
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      float w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = w3s[o * kW + half_row(tx, j)];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) s = fmaf(acc[i][j], w[j], s);
        p[i][o] = s;
      }
    }
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int o = 0; o < kOut; ++o) p[i][o] += __shfl_xor_sync(kAll, p[i][o], off);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = base + half_row(ty, i);
      if (tx == i && r < count) {
        float* cp = a.c + (int64_t)__ldg(a.idx + r) * kOut;
#pragma unroll
        for (int o = 0; o < kOut; ++o) cp[o] = 1.0f / (1.0f + expf(-(p[i][o] + b3s[o])));
      }
    }
    // xt was last read before the second barrier; h1t is next written after
    // the next tile's first, which every thread reaches only when done here.
    if (more) store();
  }
}

__global__ void __launch_bounds__(kThreads, 1) rgbnet_backward_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* w2s = sm;                        // [128][128] W2[n][k]
  float* w1t = w2s + kW * kW;             // [12][kLd] W1[n][jj] at [jj][n]
  float* gls = w1t + kK0 * kLd;           // [64][4] gl
  float* g2 = gls + kBwdRows * 4;         // [64][kLd] gh2, later gh1
  float* g2t = g2 + kBwdRows * kLd;       // [128][kLdT] gh2 transposed
  float* h1s = g2t + kW * kLdT;           // [64][128] h1
  float* h2s = h1s + kBwdRows * kW;       // [64][128] h2
  float* xs = h2s + kBwdRows * kW;        // [64][40] the inputs
  int* rows = reinterpret_cast<int*>(xs + kBwdRows * kInPad);   // [64] dense rows, -1 past count

  const int t = threadIdx.x;
  for (int e = t; e < kW * kW; e += kThreads) w2s[e] = a.w2[e];
  for (int e = t; e < kW * kK0; e += kThreads) {
    const int n = e / kK0, jj = e - n * kK0;
    w1t[jj * kLd + n] = a.w1[n * kIn + jj];
  }
  const int tx = t & 15, ty = t >> 4;     // the gw2 and gh1 tiles
  const int hf = t >> 7, u = t & (kW - 1);   // gh2's column u and the rows' half hf
  const int kg = u & 15, jg = u >> 4;     // the gw1 tile: 8 rows of W1 by 5 columns
  const float w30 = __ldg(a.w3 + u), w31 = __ldg(a.w3 + kW + u), w32 = __ldg(a.w3 + 2 * kW + u);

  float acc2[8][8], acc1[8][5], agb1[8], agw3[kOut], agb3[kOut], agb2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc2[i][j] = 0.0f;
#pragma unroll
    for (int p = 0; p < 5; ++p) acc1[i][p] = 0.0f;
    agb1[i] = 0.0f;
  }
#pragma unroll
  for (int o = 0; o < kOut; ++o) agw3[o] = agb3[o] = 0.0f;

  const int count = *a.count;
  const int tiles = (count + kBwdRows - 1) / kBwdRows;
  constexpr int kHalf = kBwdRows / 2;
  // A tile's inputs, fetched during the tile before: h1 and h2 by cp.async
  // into h1s and h2s (free once the gh1 product has read h1s), the inputs
  // of row t / 4 (columns 10 (t % 4) + 0..9) and, in threads t < 64, row
  // t's dense index, g and c into registers.
  float xv[10], gv[kOut], cv[kOut];
  int iv = -1;
  const int xm = t >> 2, xj = (t & 3) * 10;
  auto fetch = [&](int tile) {
    const int base = tile * kBwdRows;
#pragma unroll
    for (int q = 0; q < (kBwdRows * kW / 4) / kThreads; ++q) {
      const int e = t + q * kThreads, m = e >> 5, c4 = e & 31, r = base + m;
      const int64_t off = (int64_t)(r < count ? r : 0) * kW + c4 * 4;
      cp_async16(h1s + m * kW + c4 * 4, a.h1 + off, r < count);
      cp_async16(h2s + m * kW + c4 * 4, a.h2 + off, r < count);
    }
    {
      const int r = base + xm;
      const bool ok = r < count;
      const int i = ok ? __ldg(a.idx + r) : 0;
      const float* kp = a.k0 + (int64_t)i * a.ldk;
      const float* ep = a.emb + (int64_t)(i / a.S) * kEmb;
#pragma unroll
      for (int jj = 0; jj < 10; ++jj) {
        const int j = xj + jj;
        xv[jj] = (!ok || j >= kIn) ? 0.0f : j < kK0 ? __ldg(kp + j) : __ldg(ep + j - kK0);
      }
    }
    if (t < kBwdRows) {
      const int r = base + t;
      iv = r < count ? __ldg(a.idx + r) : -1;
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        gv[o] = iv >= 0 ? a.g[(int64_t)iv * kOut + o] : 0.0f;
        cv[o] = iv >= 0 ? __ldg(a.c + (int64_t)iv * kOut + o) : 0.0f;
      }
    }
  };
  if ((int)blockIdx.x < tiles) fetch(blockIdx.x);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#pragma unroll
    for (int jj = 0; jj < 10; ++jj) xs[xm * kInPad + xj + jj] = xv[jj];
    if (t < kBwdRows) {  // gl = g (1 - c) c
      rows[t] = iv;
#pragma unroll
      for (int o = 0; o < kOut; ++o) gls[t * 4 + o] = gv[o] * (1.0f - cv[o]) * cv[o];
    }
    cp_async_wait_all();
    __syncthreads();

    // gh2 = (gl W3) [h2 > 0], column u over the half's rows; gw3, gb2, gb3.
#pragma unroll
    for (int mm = 0; mm < kHalf; ++mm) {
      const int m = hf * kHalf + mm;
      const float4 gl = ld4(gls + m * 4);
      const float h = h2s[m * kW + u];
      const float gh = h > 0.0f ? fmaf(gl.z, w32, fmaf(gl.y, w31, gl.x * w30)) : 0.0f;
      g2[m * kLd + u] = gh;
      g2t[u * kLdT + m] = gh;
      agw3[0] = fmaf(gl.x, h, agw3[0]);
      agw3[1] = fmaf(gl.y, h, agw3[1]);
      agw3[2] = fmaf(gl.z, h, agw3[2]);
      agb3[0] += gl.x;
      agb3[1] += gl.y;
      agb3[2] += gl.z;
      agb2 += gh;
    }
    __syncthreads();

    // gw2[n][k] += sum_m gh2[m][n] h1[m][k]: n = half_row(ty, i), k = half_row(tx, j).
#pragma unroll 4
    for (int m = 0; m < kBwdRows; ++m)
      outer8(acc2, ld4(g2 + m * kLd + ty * 4), ld4(g2 + m * kLd + 64 + ty * 4),
             ld4(h1s + m * kW + tx * 4), ld4(h1s + m * kW + 64 + tx * 4));
    // gh1[m][k] = (sum_n gh2[m][n] W2[n][k]) [h1 > 0], rows ty * 4 + i.
    float gacc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) gacc[i][j] = 0.0f;
#pragma unroll 8
    for (int n = 0; n < kW; ++n) {
      const float4 av = ld4(g2t + n * kLdT + ty * 4);
      const float4 b0 = ld4(w2s + n * kW + tx * 4), b1 = ld4(w2s + n * kW + 64 + tx * 4);
      const float av4[4] = {av.x, av.y, av.z, av.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) gacc[i][j] = fmaf(av4[i], b[j], gacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 m0 = ld4(h1s + (ty * 4 + i) * kW + tx * 4);
      const float4 m1 = ld4(h1s + (ty * 4 + i) * kW + 64 + tx * 4);
      const float h[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) gacc[i][j] = h[j] > 0.0f ? gacc[i][j] : 0.0f;
    }
    __syncthreads();   // every read of gh2 in g2 and of h1s is done
    const bool more = tile + (int)gridDim.x < tiles;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = g2 + (ty * 4 + i) * kLd + tx * 4;
      st4(row, gacc[i][0], gacc[i][1], gacc[i][2], gacc[i][3]);
      st4(row + 64, gacc[i][4], gacc[i][5], gacc[i][6], gacc[i][7]);
    }
    __syncthreads();
    if (more) fetch(tile + gridDim.x);

    // gw1[k][j] += sum_m gh1[m][k] x[m][j] and gb1 over the half's rows.
#pragma unroll 2
    for (int mm = 0; mm < kHalf; ++mm) {
      const int m = hf * kHalf + mm;
      const float4 a0 = ld4(g2 + m * kLd + kg * 4), a1 = ld4(g2 + m * kLd + 64 + kg * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float x[5];
#pragma unroll
      for (int p = 0; p < 5; ++p) x[p] = xs[m * kInPad + jg * 5 + p];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
#pragma unroll
        for (int p = 0; p < 5; ++p) acc1[q][p] = fmaf(av[q], x[p], acc1[q][p]);
        agb1[q] += av[q];
      }
    }
    {  // gk0[m][jj] = sum_n gh1[m][n] W1[n][jj]: row t / 4, columns 3 (t % 4) + 0..2,
       // the even and the odd groups of 4 n summed apart, then added.
      const int m = t >> 2, jq = (t & 3) * 3, i = rows[m];
      float s[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll 4
      for (int k4 = 0; k4 < kW / 4; ++k4) {
        const float4 g4 = ld4(g2 + m * kLd + k4 * 4);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float4 v = ld4(w1t + (jq + q) * kLd + k4 * 4);
          float& acc = s[k4 & 1][q];
          acc = fmaf(g4.w, v.w, fmaf(g4.z, v.z, fmaf(g4.y, v.y, fmaf(g4.x, v.x, acc))));
        }
      }
      if (i >= 0) {
        float* gp = a.gk0 + (int64_t)i * kK0 + jq;
#pragma unroll
        for (int q = 0; q < 3; ++q) gp[q] = s[0][q] + s[1][q];
      }
    }
    __syncthreads();   // the next tile rewrites xs, gls, rows, g2 and g2t
  }

  // The block's partial: gw2 from its owner, the rest as the first half's
  // sum plus the second half's, in that order.
  float* part = a.part + (int64_t)blockIdx.x * kParams;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      part[kOffW2 + half_row(ty, i) * kW + half_row(tx, j)] = acc2[i][j];
  float* sw1 = g2t;                       // [128][40]
  float* sb1 = sw1 + kW * kInPad;         // [128]
  float* sw3 = sb1 + kW;                  // [3][128]
  float* sb2 = sw3 + kOut * kW;           // [128]
  float* sb3 = sb2 + kW;                  // [3]
  __syncthreads();
  if (hf == 1) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = half_row(kg, q);
#pragma unroll
      for (int p = 0; p < 5; ++p) sw1[k * kInPad + jg * 5 + p] = acc1[q][p];
      if (jg == 0) sb1[k] = agb1[q];
    }
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      sw3[o * kW + u] = agw3[o];
      if (u == 0) sb3[o] = agb3[o];
    }
    sb2[u] = agb2;
  }
  __syncthreads();
  if (hf == 0) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = half_row(kg, q);
#pragma unroll
      for (int p = 0; p < 5; ++p) {
        const int j = jg * 5 + p;
        if (j < kIn) part[kOffW1 + k * kIn + j] = acc1[q][p] + sw1[k * kInPad + j];
      }
      if (jg == 0) part[kOffB1 + k] = agb1[q] + sb1[k];
    }
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      part[kOffW3 + o * kW + u] = agw3[o] + sw3[o * kW + u];
      if (u == 0) part[kOffB3 + o] = agb3[o] + sb3[o];
    }
    part[kOffB2 + u] = agb2 + sb2[u];
  }
}

__global__ void __launch_bounds__(kThreads)
rgbnet_reduce_kernel(const float* __restrict__ part, int blocks, float* __restrict__ out) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= kParams) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += part[(int64_t)b * kParams + p];
  out[p] = s;
}

// The dynamic shared memory each kernel asks for, set once a device.
bool g_fwd_set[64], g_bwd_set[64];

int smem_attr(const void* fn, int bytes, bool* set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && set[dev]) return 0;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) set[dev] = true;
  return (int)err;
}

}  // namespace

// mask (n,) bool; counts (max(1, ceil(n / 4096)),) int32 scratch; idx (n,)
// int32; count (1,) int32.
extern "C" int tpu3d_rgbnet_compact(const uint8_t* mask, int64_t n, int* counts, int* idx,
                                    int* count, void* stream) {
  const unsigned blocks = (unsigned)(n > 0 ? (n + kCompactTile - 1) / kCompactTile : 1);
  cudaStream_t s = (cudaStream_t)stream;
  rgbnet_count_kernel<<<blocks, kThreads, 0, s>>>(mask, n, counts);
  rgbnet_compact_kernel<<<blocks, kThreads, 0, s>>>(mask, n, counts, idx, count);
  return (int)cudaGetLastError();
}

extern "C" int tpu3d_rgbnet_forward(const FwdArgs* a) {
  const int err = smem_attr((const void*)rgbnet_forward_kernel, kFwdSmem, g_fwd_set);
  if (err != 0) return err;
  rgbnet_forward_kernel<<<a->grid, kThreads, kFwdSmem, (cudaStream_t)a->stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int tpu3d_rgbnet_backward(const BwdArgs* a) {
  const int err = smem_attr((const void*)rgbnet_backward_kernel, kBwdSmem, g_bwd_set);
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)a->stream;
  rgbnet_backward_kernel<<<a->grid, kThreads, kBwdSmem, s>>>(*a);
  rgbnet_reduce_kernel<<<(kParams + kThreads - 1) / kThreads, kThreads, 0, s>>>(a->part, a->grid,
                                                                               a->out);
  return (int)cudaGetLastError();
}
