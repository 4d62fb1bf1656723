// Fused 3x3 SAME conv + bias + leaky ReLU + pixel norm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fused_kernel`, launched by `pallas_block`
// in tools/exp_fused_conv.py. Same function, per pixel (b, h, w):
//   v[c] = bias[c] + sum_{dy,dx,ci} x[b,ci,h+dy-1,w+dx-1] * w9[dy*3+dx, ci, c]
//   v[c] = max(0.2 v[c], v[c])
//   y[b,c,h,w] = v[c] * rsqrt(mean_c(v[c]^2) + 1e-6)
// x outside the image is zero (SAME padding). x and y are contiguous NCHW,
// [B, Cin, H, W] and [B, Cout, H, W], fp32 or bf16 (y in x's type); w9 is
// [9, Cin, Cout] fp32 with the caller's equalized-lr scale folded in, bias
// [Cout] fp32. x is exact in fp32, the TPU kernel multiplies it by the fp32
// weights and sums in fp32, and y is rounded once, on the store. Any H, W
// >= 1, Cin >= 1 and Cout >= 1.
//
// Any Cout. The TPU kernel holds all of Cout in one block, bounded only by
// VMEM; here a block holds up to kCoutTile = 1024 output channels (every
// width of the PGGAN generator's schedule, 1024 // 2^stage). The pixel norm
// needs the sum of squares over every channel of a pixel before any channel
// is written, so a wider layer (min_channels above 1024) takes two passes:
//  1. the grid also runs over tiles of kCoutTile channels; each block
//     applies bias and leaky to its tile and writes the fp32 values to a
//     workspace and its pixels' sums of squares over the tile to `ssq`
//     [tiles][B][H W], both allocated by the caller (the workspace is y
//     itself when y is fp32);
//  2. `pixel_norm_pass` adds each pixel's tile sums in tile order (fixed:
//     deterministic), scales the fp32 values and rounds y once.
// The products and sums are those of the one-pass kernel: only the order of
// the sum of squares' additions differs. The second pass reads and writes
// the layer's output once more (bytes, not products).
//
// Two variants, chosen by x's type:
//
// Tensor-core variant (bf16 x): an implicit GEMM [B H W pixels, 9 Cin] x
// [9 Cin, Cout] on mma.sync m16n8k16 with fp32 accumulators and the
// epilogue fused.
//  - What bounds it on the H100. Each multiply-add is two bf16 products
//    (below), so the 13 layers of a pggan256 generator pass at batch 12 are
//    105.6 GFLOP of tensor-core work, 0.107 ms at the 989 TFLOP/s bf16
//    peak; the 128 and 256 px layers, with 16-64 channels, are bound by
//    their bytes instead (x read and y written once: 15-22 us at 256 px).
//  - Numerics. The TPU kernel's weights are fp32; rounding them to bf16
//    would compute another function. Each weight is split while it is
//    staged into hi = bf16(w) and lo = bf16(w - hi), and every fragment is
//    multiplied twice (x hi, then x lo) into one fp32 accumulator: x is
//    exact in bf16 and w is carried to about 16 bits, against the output's
//    8.
//  - Layout. A block owns a TH x TW rectangle of one image's pixels (up to
//    M of them: the GEMM's rows) and every output channel (the pixel norm
//    needs them all): M shrinks as Cout grows, 256 pixels at 16-32
//    channels down to 16 at 1024, so that the accumulators stay at 64 fp32
//    registers a thread or fewer over 8 warps. x's halo tile [(TH+2)(TW+2)
//    positions][16 channels] is staged channel-last: read along W from
//    NCHW (coalesced) into registers and stored transposed, so that every
//    tap is a row offset of 16-byte aligned rows and an A fragment is one
//    ldmatrix (rows padded to 48 bytes: conflict-free). The weights of one
//    K step, [taps x 16][Cout], come by 16-byte cp.async into an
//    fp32 buffer, are split into the hi and lo rows of a double buffer,
//    and are read by ldmatrix.trans. The K loop runs over chunks x 9 taps
//    in steps of 9, 3 or 1 taps (bigger steps for narrower layers, whose
//    products per tap are few), one barrier a step; the next steps'
//    weights (a ring of 1 to 4 raw stages) and the next chunk's x are in
//    flight while a step computes.
//  - Too few blocks at 4-32 px (12 to 96 pixel tiles at batch 12 on 132
//    SMs). There the K loop is split across blocks (blockIdx.z takes a
//    range of Cin chunks, up to 8), and the blocks of one tile form a
//    thread-block cluster: each leaves its fp32 partial sums in its shared
//    memory, and each sums a slice of the tile's pixels over the cluster
//    in rank order through distributed shared memory and applies the
//    epilogue to them. Deterministic, no atomics, no workspace in device
//    memory and no second kernel.
//  - Epilogue: bias, leaky, each pixel's sum of squares over its lanes
//    (shuffles) and the block's warps (shared memory, fixed order), the
//    scale, one rounding; the tile goes through shared memory to be stored
//    along W, 16 bytes a thread where the rows allow it.
//
// CUDA-core variant (fp32 x), fp32 FMAs, which bound it: a pggan256 pass's
// 52.8 GFLOP take 0.79 ms at the 67 TFLOP/s fp32 peak. The TPU kernel gives
// each program an 8-row tile of one image with its halo rows duplicated in
// device memory (BlockSpec windows cannot overlap) and holds the tile's
// [8 W, Cout] accumulator in VMEM. Here:
//  - a block owns 32 consecutive pixels of one image (row-major over H*W,
//    threadIdx.x) and every output channel of them, in groups of 8 over
//    threadIdx.y (up to 32 warps, 256 channels). Past 256 channels a thread
//    takes 2 or 4 groups (Cout up to 512 or 1024), so that the block still
//    owns whole channel vectors. A thread keeps its pixel's 8 accumulators
//    per group in registers. Flattened pixels cover any H and W, down to
//    the 4x4 layers, without idle rows;
//  - x is read in place: each thread computes its nine taps' offsets and
//    in-image mask once, and reads x through L1 with zero fill outside the
//    image. Each element of x is used by 9 taps of neighbouring threads and
//    by every warp of the block, so device memory sees it about once;
//  - the weights of one (tap, input channel) are the same for the 32
//    threads of a warp: one broadcast load, two float4 loads per 8 channels
//    when Cout is a multiple of 8. Each x value loaded feeds all of the
//    thread's groups;
//  - the pixel norm sums squares over all Cout of a pixel, spread over the
//    block's warps: each thread writes its 8 channels' partial sum to shared
//    memory, one barrier, and each thread adds the partials of its pixel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <climits>

#include <cooperative_groups.h>

#include "flash_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPixels = 32;            // pixels per block (threadIdx.x)
constexpr int kChannelsPerThread = 8;  // output channels of one group
constexpr int kMaxWarps = 32;          // groups side by side (threadIdx.y)
constexpr int kMaxGroupsPerThread = 4;
// Output channels a block holds: both variants' widest block (here 8 x 32 x
// 4, and the tensor-core config 8's N). Wider layers take two passes.
constexpr int kCoutTile = kChannelsPerThread * kMaxWarps * kMaxGroupsPerThread;
constexpr float kSlope = 0.2f;
constexpr float kEps = 1e-6f;

// ---------------------------------------------------------------------------
// CUDA-core variant (fp32).

// kFull: Cout is a multiple of kChannelsPerThread, so every group that
// exists has all 8 channels and their weights are 16-byte aligned (float4
// loads). kGroups: groups of 8 channels per thread, threadIdx.y + k *
// blockDim.y for k < kGroups; a group past Cout is skipped, uniformly over
// its warp.
template <bool kFull, int kGroups>
__global__ void __launch_bounds__(kPixels * kMaxWarps)
fused_conv_kernel(const float* __restrict__ x, const float* __restrict__ w9,
                  const float* __restrict__ bias, float* __restrict__ y,
                  float* __restrict__ ssq, int cin, int cout, int height, int width) {
  __shared__ float partial[kMaxWarps][kPixels];
  const int hw = height * width;
  const int p = blockIdx.x * kPixels + threadIdx.x;
  const bool valid = p < hw;
  const int h = valid ? p / width : 0;
  const int w = valid ? p - h * width : 0;
  int co0[kGroups], n_ch[kGroups];
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    co0[k] = blockIdx.z * kCoutTile + (threadIdx.y + k * blockDim.y) * kChannelsPerThread;
    n_ch[k] = max(0, min(kChannelsPerThread, cout - co0[k]));
  }

  int offset[9];
  unsigned inside = 0;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int hh = h + t / 3 - 1;
    const int ww = w + t % 3 - 1;
    const bool in = valid && hh >= 0 && hh < height && ww >= 0 && ww < width;
    offset[t] = in ? hh * width + ww : 0;
    inside |= (in ? 1u : 0u) << t;
  }

  float acc[kGroups][kChannelsPerThread];
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
#pragma unroll
    for (int j = 0; j < kChannelsPerThread; ++j) acc[k][j] = 0.f;
  }

  const float* plane = x + static_cast<int64_t>(blockIdx.y) * cin * hw;
  for (int ci = 0; ci < cin; ++ci, plane += hw) {
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const float v = ((inside >> t) & 1u) ? plane[offset[t]] : 0.f;
      const float* wtap = w9 + (static_cast<int64_t>(t) * cin + ci) * cout;
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        if (n_ch[k] == 0) continue;  // past Cout: uniform over the warp
        const float* wt = wtap + co0[k];
        if (kFull) {
          const float4 lo = __ldg(reinterpret_cast<const float4*>(wt));
          const float4 hi = __ldg(reinterpret_cast<const float4*>(wt) + 1);
          acc[k][0] = fmaf(v, lo.x, acc[k][0]);
          acc[k][1] = fmaf(v, lo.y, acc[k][1]);
          acc[k][2] = fmaf(v, lo.z, acc[k][2]);
          acc[k][3] = fmaf(v, lo.w, acc[k][3]);
          acc[k][4] = fmaf(v, hi.x, acc[k][4]);
          acc[k][5] = fmaf(v, hi.y, acc[k][5]);
          acc[k][6] = fmaf(v, hi.z, acc[k][6]);
          acc[k][7] = fmaf(v, hi.w, acc[k][7]);
        } else {
#pragma unroll
          for (int j = 0; j < kChannelsPerThread; ++j) {
            if (j < n_ch[k]) acc[k][j] = fmaf(v, __ldg(wt + j), acc[k][j]);
          }
        }
      }
    }
  }

  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
#pragma unroll
    for (int j = 0; j < kChannelsPerThread; ++j) {
      if (j < n_ch[k]) {
        float v = acc[k][j] + __ldg(bias + co0[k] + j);
        v = fmaxf(kSlope * v, v);
        acc[k][j] = v;
        ss = fmaf(v, v, ss);
      }
    }
  }
  partial[threadIdx.y][threadIdx.x] = ss;
  __syncthreads();
  float total = 0.f;
  for (int g = 0; g < blockDim.y; ++g) total += partial[g][threadIdx.x];
  if (!valid) return;
  // Two passes (ssq set): this tile's sum of squares, and the values before
  // the norm in y, which pixel_norm_pass scales in place.
  const float scale = ssq ? 1.f : rsqrtf(total / static_cast<float>(cout) + kEps);
  if (ssq && threadIdx.y == 0) {
    ssq[(static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) * hw + p] = total;
  }
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    float* out = y + (static_cast<int64_t>(blockIdx.y) * cout + co0[k]) * hw + p;
#pragma unroll
    for (int j = 0; j < kChannelsPerThread; ++j) {
      if (j < n_ch[k]) out[static_cast<int64_t>(j) * hw] = acc[k][j] * scale;
    }
  }
}

template <int kGroups>
void launch_groups(dim3 grid, dim3 block, bool full, const float* x, const float* w9,
                   const float* bias, float* y, float* ssq, int cin, int cout, int height,
                   int width, cudaStream_t stream) {
  if (full) {
    fused_conv_kernel<true, kGroups><<<grid, block, 0, stream>>>(x, w9, bias, y, ssq, cin,
                                                                 cout, height, width);
  } else {
    fused_conv_kernel<false, kGroups><<<grid, block, 0, stream>>>(x, w9, bias, y, ssq, cin,
                                                                  cout, height, width);
  }
}

// blockIdx.z: the tile of kCoutTile channels (one tile, and ssq null, up to
// kCoutTile).
cudaError_t launch_cuda_core(const void* x, const void* w9, const void* bias, void* y,
                             float* ssq, int batch, int cin, int cout, int height, int width,
                             cudaStream_t stream) {
  const int hw = height * width;
  const int groups = (min(cout, kCoutTile) + kChannelsPerThread - 1) / kChannelsPerThread;
  const int warps = min(groups, kMaxWarps);
  const int per_thread = (groups + warps - 1) / warps;  // 1..4
  const dim3 block(kPixels, warps);
  const dim3 grid((hw + kPixels - 1) / kPixels, batch, (cout + kCoutTile - 1) / kCoutTile);
  const float* xt = static_cast<const float*>(x);
  const float* wt = static_cast<const float*>(w9);
  const float* bt = static_cast<const float*>(bias);
  float* yt = static_cast<float*>(y);
  const bool full =
      cout % kChannelsPerThread == 0 && reinterpret_cast<uintptr_t>(w9) % 16 == 0;
  if (per_thread == 1) {
    launch_groups<1>(grid, block, full, xt, wt, bt, yt, ssq, cin, cout, height, width, stream);
  } else if (per_thread == 2) {
    launch_groups<2>(grid, block, full, xt, wt, bt, yt, ssq, cin, cout, height, width, stream);
  } else {
    launch_groups<4>(grid, block, full, xt, wt, bt, yt, ssq, cin, cout, height, width, stream);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The second pass of a layer wider than kCoutTile: y = ws * rsqrt(mean_c +
// eps) per pixel, the mean from the tiles' sums of squares added in tile
// order. A thread owns one pixel (along W: coalesced) and kNormChannels
// channels of it. ws and y may be one buffer (fp32): each element is read
// and written by the same thread, so neither pointer is __restrict__.

constexpr int kNormPixels = 128;
constexpr int kNormChannels = 64;

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kNormPixels) pixel_norm_pass(const float* ws,
                                                               const float* __restrict__ ssq,
                                                               T* y, int tiles, int cout,
                                                               int hw) {
  const int p = blockIdx.x * kNormPixels + threadIdx.x;
  if (p >= hw) return;
  const int b = blockIdx.z;
  float total = 0.f;
  for (int t = 0; t < tiles; ++t) total += ssq[(static_cast<int64_t>(t) * gridDim.z + b) * hw + p];
  const float scale = rsqrtf(total / static_cast<float>(cout) + kEps);
  const int c1 = min(cout, static_cast<int>(blockIdx.y + 1) * kNormChannels);
  for (int co = blockIdx.y * kNormChannels; co < c1; ++co) {
    const int64_t i = (static_cast<int64_t>(b) * cout + co) * hw + p;
    store_as(y + i, ws[i] * scale);
  }
}

template <typename T>
cudaError_t launch_pixel_norm_pass(const float* ws, const float* ssq, void* y, int batch,
                                   int cout, int hw, cudaStream_t stream) {
  const dim3 grid((hw + kNormPixels - 1) / kNormPixels,
                  (cout + kNormChannels - 1) / kNormChannels, batch);
  pixel_norm_pass<T><<<grid, kNormPixels, 0, stream>>>(
      ws, ssq, static_cast<T*>(y), (cout + kCoutTile - 1) / kCoutTile, cout, hw);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core variant (bf16).

constexpr int kThreads = 256;    // 8 warps
constexpr int kKC = 16;          // input channels of one K chunk: one k16 step a tap
constexpr int kXS = kKC + 8;     // staged x row stride (bf16): 48 bytes, conflict-free ldmatrix
constexpr int kMaxSplits = 8;  // the splits of a tile form a cluster: 8 blocks at most

// The staged halo tile's positions at most, for a block of M pixels; the
// host picks tile shapes within it.
__host__ __device__ constexpr int max_halo(int m) { return 3 * m / 2 + 64; }

// MT x NT m16n8 tiles a warp, WM x WN warps. A K step is TAPS taps of one
// 16-channel chunk (9, 3 or 1: narrow layers take bigger steps, so that a
// step's products outweigh its barrier and copies), and STAGES steps of
// raw fp32 weights are in flight while one computes. MINB blocks an SM
// bound the registers.
template <int MT, int NT, int WM, int WN, int TAPS, int STAGES, int MINB>
struct Cfg {
  static_assert(WM * WN * 32 == kThreads && NT % 2 == 0 && 9 % TAPS == 0, "8 warps");
  static constexpr int M = 16 * MT * WM;  // pixels a block owns
  static constexpr int N = 8 * NT * WN;   // output channels, padded
  static constexpr int NS = N + 8;        // staged weight row stride (bf16)
  static constexpr int kRows = TAPS * kKC;  // weight rows of a step
  static constexpr int kXItems = (2 * max_halo(M) + kThreads - 1) / kThreads;  // x vectors
  static constexpr int kWItems = (kRows * N / 4 + kThreads - 1) / kThreads;    // weight float4s
  static constexpr size_t raw_bytes = STAGES * kRows * N * sizeof(float);
  static constexpr size_t w_bytes = 2 * 2 * kRows * NS * sizeof(bf16);  // [hi, lo][2][kRows][NS]
  static constexpr size_t epi_bytes = WN * M * sizeof(float) + N * (M + 8) * sizeof(bf16);
  static constexpr int PS = N + 4;  // row stride (floats) of the split-K partial sums
  // Shared memory for a halo tile of `npos` positions, one x buffer or two,
  // and `splits` blocks a tile: the partial sums [M][PS], then this
  // block's rows of the sum [rows][PS] and their scales.
  static constexpr size_t smem(int npos, int xbufs, int splits) {
    const size_t main = raw_bytes + w_bytes + xbufs * npos * kXS * sizeof(bf16);
    const size_t rows = (M + splits - 1) / splits;
    const size_t reduce = splits > 1 ? ((M + rows) * PS + rows) * sizeof(float) : 0;
    const size_t most = main > epi_bytes ? main : epi_bytes;
    return most > reduce ? most : reduce;
  }
};

// How a launch cuts the work: TH x TW pixel tiles, tiles_w of them along
// W and tiles_img in an image; Cin in nchunks chunks of 16,
// chunks_per_split of them a block along blockIdx.z. blockIdx.x is the
// pixel tile plus tiles_img times the tile of N output channels (one tile
// up to kCoutTile).
struct Tile {
  int th, tw, tiles_w, tiles_img, nchunks, chunks_per_split;
};

template <int MT, int NT, int WM, int WN, int TAPS, int STAGES, int MINB>
__global__ void __launch_bounds__(kThreads, MINB) fused_conv_mma_kernel(
    const bf16* __restrict__ x, const float* __restrict__ w9, const float* __restrict__ bias,
    bf16* __restrict__ y, float* __restrict__ ws, float* __restrict__ ssq, int cin, int cout,
    int height, int width, Tile tile, bool vec_w, bool vec_y) {
  using namespace flash_mma;
  using C = Cfg<MT, NT, WM, WN, TAPS, STAGES, MINB>;
  constexpr int M = C::M, N = C::N, NS = C::NS, kRows = C::kRows;
  constexpr int kStepsPerChunk = 9 / TAPS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem);                        // [STAGES][kRows][N]
  bf16* whi = reinterpret_cast<bf16*>(smem + C::raw_bytes);           // [2][kRows][NS]
  bf16* wlo = whi + 2 * kRows * NS;                                   // [2][kRows][NS]
  bf16* xs = reinterpret_cast<bf16*>(smem + C::raw_bytes + C::w_bytes);  // [1 or 2][npos][kXS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tig = lane % 4, mi = lane / 8, mr = lane % 8;
  const int warp_m = warp % WM, warp_n = warp / WM;
  const int b = blockIdx.y;
  const int ptile = blockIdx.x % tile.tiles_img;
  const int n0 = (blockIdx.x / tile.tiles_img) * N;  // the block's first output channel
  const int h0 = (ptile / tile.tiles_w) * tile.th;
  const int w0 = (ptile % tile.tiles_w) * tile.tw;
  const int hw = height * width;
  const int halo_w = tile.tw + 2;
  const int npos = (tile.th + 2) * halo_w;
  const int tile_px = tile.th * tile.tw;
  const int c_begin = blockIdx.z * tile.chunks_per_split;
  const int nchunks = min(tile.nchunks - c_begin, tile.chunks_per_split);
  const int nsteps = kStepsPerChunk * nchunks;
  const unsigned short* xb =
      reinterpret_cast<const unsigned short*>(x) + static_cast<int64_t>(b) * cin * hw;

  // Each lane's ldmatrix row of each m16 tile: its pixel's halo position at
  // tap (0, 0). Rows past the tile read position 0 and are never stored.
  int apos[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = warp_m * 16 * MT + mt * 16 + (mi % 2) * 8 + mr;
    apos[mt] = m < tile_px ? (m / tile.tw) * halo_w + m % tile.tw : 0;
  }

  // x: item (g8, pos) is 8 channels of one halo position, 16 bytes; items
  // run along the position, so a warp reads along W. Each item's offset in
  // an x plane (-1 outside the image) and in a staged tile (-1 past the
  // tile) are the same for every chunk: computed once.
  int xoff[C::kXItems], xdst[C::kXItems];
#pragma unroll
  for (int k = 0; k < C::kXItems; ++k) {
    const int item = tid + k * kThreads;
    const int g8 = item / npos, pos = item - g8 * npos;
    const int hr = pos / halo_w, wr = pos - hr * halo_w;
    const int hh = h0 - 1 + hr, ww = w0 - 1 + wr;
    const bool staged = item < 2 * npos;
    xdst[k] = staged ? pos * kXS + g8 * 8 : -1;
    xoff[k] = staged && hh >= 0 && hh < height && ww >= 0 && ww < width ? hh * width + ww : -1;
  }
  uint4 xr[C::kXItems];
  auto load_x = [&](int chunk) {
#pragma unroll
    for (int k = 0; k < C::kXItems; ++k) {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (xoff[k] >= 0) {
        const int ci0 = chunk * kKC + (xdst[k] % kXS);  // g8 * 8 of the item
        const unsigned short* src = xb + static_cast<int64_t>(ci0) * hw + xoff[k];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t bits = ci0 + j < cin ? __ldg(src + static_cast<int64_t>(j) * hw) : 0u;
          v[j / 2] |= bits << (16 * (j % 2));
        }
      }
      xr[k] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  };
  auto store_x = [&](int buf) {
    bf16* dst = xs + buf * npos * kXS;
#pragma unroll
    for (int k = 0; k < C::kXItems; ++k) {
      if (xdst[k] >= 0) *reinterpret_cast<uint4*>(dst + xdst[k]) = xr[k];
    }
  };

  // Weights of step s (chunk c_begin + s / kStepsPerChunk, its taps from
  // TAPS * (s % kStepsPerChunk)) into raw stage s % STAGES: row (tap, ci)
  // of the chunk, columns 0..N, zero past Cin and Cout; item = 4 columns.
  auto copy_w = [&](int s) {
    const int chunk = c_begin + s / kStepsPerChunk, tap0 = TAPS * (s % kStepsPerChunk);
    float* stage = raw + (s % STAGES) * kRows * N;
#pragma unroll
    for (int k = 0; k < C::kWItems; ++k) {
      const int item = tid + k * kThreads;
      if ((kRows * N / 4) % kThreads != 0 && item >= kRows * N / 4) break;
      const int row = item / (N / 4), col = 4 * (item % (N / 4));
      const int ci = chunk * kKC + row % kKC;
      const float* src =
          w9 + (static_cast<int64_t>(tap0 + row / kKC) * cin + ci) * cout + n0 + col;
      float* dst = stage + row * N + col;
      if (vec_w) {  // Cout % 4 == 0: a chunk is all in or all out
        const bool in = ci < cin && n0 + col < cout;
        cp_async16(dst, in ? src : w9, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = ci < cin && n0 + col + e < cout ? src[e] : 0.f;
      }
    }
  };
  // This thread's items of step s's raw stage (its own copies) as hi and lo
  // bf16 rows of weight buffer s & 1.
  auto split_w = [&](int s) {
    const float* stage = raw + (s % STAGES) * kRows * N;
#pragma unroll
    for (int k = 0; k < C::kWItems; ++k) {
      const int item = tid + k * kThreads;
      if ((kRows * N / 4) % kThreads != 0 && item >= kRows * N / 4) break;
      const int row = item / (N / 4), col = 4 * (item % (N / 4));
      const float4 v = *reinterpret_cast<const float4*>(stage + row * N + col);
      const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
      const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
      const __nv_bfloat162 l01 = __floats2bfloat162_rn(v.x - f01.x, v.y - f01.y);
      const __nv_bfloat162 l23 = __floats2bfloat162_rn(v.z - f23.x, v.w - f23.y);
      const int off = (s & 1) * kRows * NS + row * NS + col;
      *reinterpret_cast<uint2*>(whi + off) = make_uint2(
          *reinterpret_cast<const uint32_t*>(&h01), *reinterpret_cast<const uint32_t*>(&h23));
      *reinterpret_cast<uint2*>(wlo + off) = make_uint2(
          *reinterpret_cast<const uint32_t*>(&l01), *reinterpret_cast<const uint32_t*>(&l23));
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
        acc[mt][nt][3] = 0.f;
  }

  // One step: taps tap0 .. tap0 + TAPS of the chunk in x buffer `xbuf`,
  // weights in buffer `wb`. Per tap, all hi products, then all lo
  // products: each accumulator's two products are MT * NT mma apart.
  auto compute = [&](int wb, int xbuf, int tap0) {
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      const int tap = tap0 + t;
      const bf16* xt = xs + xbuf * npos * kXS + ((tap / 3) * halo_w + tap % 3) * kXS +
                       (mi / 2) * 8;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[mt], xt + apos[mt] * kXS);
      const int woff = wb * kRows * NS + (t * kKC + 8 * (mi % 2) + mr) * NS + warp_n * 8 * NT +
                       8 * (mi / 2);
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        const bf16* wt = (part == 0 ? whi : wlo) + woff;
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {  // matrices: (k +0, n +0), (+8, +0), (+0, +8), (+8, +8)
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, wt + 16 * j);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma16816(acc[mt][2 * j], a[mt], bf[0], bf[1]);
            mma16816(acc[mt][2 * j + 1], a[mt], bf[2], bf[3]);
          }
        }
      }
    }
  };

  // Prologue: steps 0 .. STAGES - 1 copied (one cp.async group each), step
  // 0 split, step STAGES copied into its stage; chunk 0's x staged.
  for (int s = 0; s < STAGES; ++s) {
    if (s < nsteps) copy_w(s);
    cp_async_commit();
  }
  load_x(c_begin);
  store_x(0);
  cp_async_wait<STAGES - 1>();
  split_w(0);
  if (STAGES < nsteps) copy_w(STAGES);
  cp_async_commit();
  __syncthreads();
  // Step s computes from weight buffer s & 1 while step s + 1's raw stage
  // (copied STAGES steps earlier) is split into the other buffer, and its
  // stage is refilled with step s + 1 + STAGES. A chunk's first step loads
  // the next chunk's x into registers, its last stores them. One barrier a
  // step: the buffers written in step s were last read in step s - 1.
  for (int s = 0; s < nsteps; ++s) {
    const int chunk = s / kStepsPerChunk, sub = s % kStepsPerChunk;
    const bool more_x = chunk + 1 < nchunks;
    if (sub == 0 && more_x) load_x(c_begin + chunk + 1);
    compute(s & 1, chunk & 1, TAPS * sub);
    if (s + 1 < nsteps) {
      cp_async_wait<STAGES - 1>();
      split_w(s + 1);  // reads its own copies, then their stage is refilled
      if (s + 1 + STAGES < nsteps) copy_w(s + 1 + STAGES);
      cp_async_commit();
    }
    if (sub == kStepsPerChunk - 1 && more_x) store_x((chunk + 1) & 1);
    __syncthreads();
  }

  bf16* yb = y + static_cast<int64_t>(b) * cout * hw;
  // Two passes (ssq set): the tile's fp32 values go to ws and its pixels'
  // sums of squares to ssq; pixel_norm_pass scales and rounds them.
  const int ncols = min(N, cout - n0);  // the block's output channels
  float* wsb = ws ? ws + (static_cast<int64_t>(b) * cout + n0) * hw : nullptr;
  float* ssqb = ssq ? ssq + (static_cast<int64_t>(blockIdx.x / tile.tiles_img) * gridDim.y + b) * hw
                    : nullptr;
  // Split K: the gridDim.z blocks of a tile are one cluster. Each puts its
  // partial sums in its shared memory (the staging buffers are retired),
  // then sums one slice of the tile's rows over the cluster's blocks in
  // rank order (distributed shared memory: deterministic, no atomics) and
  // applies the epilogue to them.
  if (gridDim.z > 1) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    constexpr int PS = C::PS;
    float* part = reinterpret_cast<float*>(smem);  // [M][PS]
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = warp_m * 16 * MT + mt * 16 + grp + 8 * r;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = warp_n * 8 * NT + nt * 8 + 2 * tig;
          *reinterpret_cast<float2*>(part + m * PS + col) =
              make_float2(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
        }
      }
    }
    cluster.sync();  // every block's partial sums are in place
    const int splits = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int rows = (M + splits - 1) / splits, r0 = rank * rows;
    const int nrows = max(0, min(M, r0 + rows) - r0);
    float* sum = part + M * PS;   // [rows][PS]
    float* scale = sum + rows * PS;  // [rows]
    for (int i = tid; i < nrows * N; i += kThreads) {
      const int m = r0 + i / N, col = i % N;
      float v = 0.f;
      for (int sp = 0; sp < splits; ++sp) v += cluster.map_shared_rank(part, sp)[m * PS + col];
      v += col < ncols ? __ldg(bias + n0 + col) : 0.f;  // past Cout: 0
      sum[(m - r0) * PS + col] = fmaxf(kSlope * v, v);
    }
    cluster.sync();  // no block reads another's partial sums after this
    for (int i = warp; i < nrows; i += kThreads / 32) {  // a warp a row
      float t = 0.f;
      for (int col = lane; col < N; col += 32) t = fmaf(sum[i * PS + col], sum[i * PS + col], t);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) t += __shfl_xor_sync(0xffffffffu, t, off);
      if (lane == 0) scale[i] = ssq ? t : rsqrtf(t / static_cast<float>(cout) + kEps);
    }
    __syncthreads();
    for (int i = tid; i < ncols * nrows; i += kThreads) {  // along the rows: along W
      const int mm = i % nrows, co = i / nrows, m = r0 + mm;
      const int hh = h0 + m / tile.tw, ww = w0 + m % tile.tw;
      if (m < tile_px && hh < height && ww < width) {
        const int64_t at = static_cast<int64_t>(co) * hw + hh * width + ww;
        if (ssq) {
          wsb[at] = sum[mm * PS + co];
          if (co == 0) ssqb[hh * width + ww] = scale[mm];
        } else {
          yb[at] = __float2bfloat16(sum[mm * PS + co] * scale[mm]);
        }
      }
    }
    return;
  }

  // Epilogue. Channels past Cout have zero weights and bias, so they add 0
  // to the squares.
  float ss[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) ss[mt][0] = ss[mt][1] = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = warp_n * 8 * NT + nt * 8 + 2 * tig;
    const float b0 = col < ncols ? __ldg(bias + n0 + col) : 0.f;
    const float b1 = col + 1 < ncols ? __ldg(bias + n0 + col + 1) : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = acc[mt][nt][e] + (e % 2 ? b1 : b0);
        v = fmaxf(kSlope * v, v);
        acc[mt][nt][e] = v;
        ss[mt][e / 2] = fmaf(v, v, ss[mt][e / 2]);
      }
    }
  }
  float* red = reinterpret_cast<float*>(smem);                        // [WN][M]
  bf16* ys = reinterpret_cast<bf16*>(smem + WN * M * sizeof(float));  // [N][M + 8]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = ss[mt][r];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (tig == 0) red[warp_n * M + warp_m * 16 * MT + mt * 16 + grp + 8 * r] = v;
    }
  }
  __syncthreads();  // the loop's last barrier retired the staging buffers
  if (ssq) {  // the first pass of two: fp32 values and the tile's sums, unscaled
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = warp_m * 16 * MT + mt * 16 + grp + 8 * r;
        const int hh = h0 + m / tile.tw, ww = w0 + m % tile.tw;
        if (m >= tile_px || hh >= height || ww >= width) continue;
        const int at = hh * width + ww;
        if (warp_n == 0 && tig == 0) {
          float total = 0.f;
#pragma unroll
          for (int wn = 0; wn < WN; ++wn) total += red[wn * M + m];
          ssqb[at] = total;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = warp_n * 8 * NT + nt * 8 + 2 * tig;
          if (col < ncols) wsb[static_cast<int64_t>(col) * hw + at] = acc[mt][nt][2 * r];
          if (col + 1 < ncols) wsb[static_cast<int64_t>(col + 1) * hw + at] = acc[mt][nt][2 * r + 1];
        }
      }
    }
    return;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = warp_m * 16 * MT + mt * 16 + grp + 8 * r;
      float total = 0.f;
#pragma unroll
      for (int wn = 0; wn < WN; ++wn) total += red[wn * M + m];
      const float scale = rsqrtf(total / static_cast<float>(cout) + kEps);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = warp_n * 8 * NT + nt * 8 + 2 * tig;
        ys[col * (M + 8) + m] = __float2bfloat16(acc[mt][nt][2 * r] * scale);
        ys[(col + 1) * (M + 8) + m] = __float2bfloat16(acc[mt][nt][2 * r + 1] * scale);
      }
    }
  }
  __syncthreads();
  if (vec_y) {  // TW and W multiples of 8: 8 pixels of a row, 16 bytes
    const int per_row = tile.tw / 8;
    for (int i = tid; i < cout * tile.th * per_row; i += kThreads) {
      const int c8 = i % per_row, rest = i / per_row;
      const int r = rest % tile.th, co = rest / tile.th;
      const int hh = h0 + r, ww = w0 + 8 * c8;
      if (hh < height && ww < width) {
        *reinterpret_cast<uint4*>(yb + static_cast<int64_t>(co) * hw + hh * width + ww) =
            *reinterpret_cast<const uint4*>(ys + co * (M + 8) + r * tile.tw + 8 * c8);
      }
    }
  } else {
    for (int i = tid; i < cout * tile_px; i += kThreads) {
      const int m = i % tile_px, co = i / tile_px;
      const int hh = h0 + m / tile.tw, ww = w0 + m % tile.tw;
      if (hh < height && ww < width) {
        yb[static_cast<int64_t>(co) * hw + hh * width + ww] = ys[co * (M + 8) + m];
      }
    }
  }
}

// The instantiations: (MT, NT, WM, WN, TAPS, STAGES, MINB) -> M pixels,
// N channels.
#define FUSED_CONV_CONFIGS(X)                                               \
  X(0, 2, 2, 8, 1, 9, 1, 3)  /* M 256, N 16   */                            \
  X(1, 2, 4, 8, 1, 9, 1, 2)  /* M 256, N 32   */                            \
  X(2, 2, 4, 4, 2, 3, 2, 3)  /* M 128, N 64   */                            \
  X(3, 2, 8, 4, 2, 1, 4, 2)  /* M 128, N 128  */                            \
  X(4, 2, 8, 2, 4, 1, 4, 2)  /* M 64,  N 256  */                            \
  X(5, 1, 4, 1, 8, 1, 4, 3)  /* M 16,  N 256: images of 16 pixels or fewer */ \
  X(6, 1, 8, 1, 8, 1, 3, 2)  /* M 16,  N 512: the same */                   \
  X(7, 2, 8, 1, 8, 1, 3, 1)  /* M 32,  N 512  */                            \
  X(8, 1, 16, 1, 8, 1, 1, 1) /* M 16,  N 1024 = kCoutTile: every wider layer */

constexpr int kConfigM[] = {256, 256, 128, 128, 64, 16, 16, 32, 16};

int pick_config(int cout, int hw) {
  if (cout <= 16) return 0;
  if (cout <= 32) return 1;
  if (cout <= 64) return 2;
  if (cout <= 128) return 3;
  if (cout <= 256) return hw <= 16 ? 5 : 4;
  if (cout <= 512) return hw <= 16 ? 6 : 7;
  return 8;
}

struct Plan {
  int config, splits;
  Tile tile;
  int64_t tiles;  // pixel tiles of the whole batch
  int ctiles;     // tiles of kCoutTile output channels (1 up to kCoutTile)
};

// The pixel tile for a block of M pixels: TW a power of two from 8 below W,
// or W itself, and as many rows as fit in M and in max_halo(M) staged
// positions; the least (M + halo positions) per pixel wins, powers of two
// (16-byte stores) on a tie. Then the split of Cin: the fewest
// power-of-two splits (at most the chunks and kMaxSplits, a cluster's
// blocks) that give every SM a block, counting the channel tiles.
Plan make_plan(int batch, int cin, int cout, int height, int width, int sms) {
  Plan plan;
  plan.config = pick_config(cout, height * width);
  const int m = kConfigM[plan.config];
  double best = 1e30;
  auto consider = [&](int tw) {
    if (tw > m) return;
    int th = min(height, m / tw);
    while (th > 1 && (th + 2) * (tw + 2) > max_halo(m)) --th;
    if ((th + 2) * (tw + 2) > max_halo(m)) return;
    const double cost = static_cast<double>(m + (th + 2) * (tw + 2)) / (th * tw);
    if (cost < best) {
      best = cost;
      plan.tile.th = th;
      plan.tile.tw = tw;
    }
  };
  for (int tw = 8; tw < width; tw *= 2) consider(tw);
  consider(width);  // W <= 8 always fits; past 8, tw = 8 does
  plan.tile.tiles_w = (width + plan.tile.tw - 1) / plan.tile.tw;
  plan.tile.tiles_img = plan.tile.tiles_w * ((height + plan.tile.th - 1) / plan.tile.th);
  plan.tiles = static_cast<int64_t>(batch) * plan.tile.tiles_img;
  plan.ctiles = (cout + kCoutTile - 1) / kCoutTile;
  plan.tile.nchunks = (cin + kKC - 1) / kKC;
  int splits = 1;
  while (plan.tiles * plan.ctiles * splits < sms &&
         2 * splits <= min(plan.tile.nchunks, kMaxSplits)) {
    splits *= 2;
  }
  plan.tile.chunks_per_split = (plan.tile.nchunks + splits - 1) / splits;
  plan.splits = (plan.tile.nchunks + plan.tile.chunks_per_split - 1) / plan.tile.chunks_per_split;
  return plan;
}

template <int MT, int NT, int WM, int WN, int TAPS, int STAGES, int MINB>
cudaError_t launch_mma_config(const Plan& plan, const bf16* x, const float* w9,
                              const float* bias, bf16* y, float* ws, float* ssq, int batch,
                              int cin, int cout, int height, int width, cudaStream_t stream) {
  using C = Cfg<MT, NT, WM, WN, TAPS, STAGES, MINB>;
  static_assert(C::N <= kCoutTile, "a block holds at most kCoutTile channels");
  if (plan.ctiles > 1 && C::N != kCoutTile) return cudaErrorInvalidValue;
  auto kernel = fused_conv_mma_kernel<MT, NT, WM, WN, TAPS, STAGES, MINB>;
  const int npos = (plan.tile.th + 2) * (plan.tile.tw + 2);
  const size_t smem = C::smem(npos, plan.tile.chunks_per_split > 1 ? 2 : 1, plan.splits);
  // Every config may take up to 227 KB (Cout 1024: 199 KB); set once.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (attr != cudaSuccess) return attr;
  const bool vec_w = cout % 4 == 0 && reinterpret_cast<uintptr_t>(w9) % 16 == 0;
  const bool vec_y = plan.tile.tw % 8 == 0 && width % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaLaunchConfig_t config = {};
  config.gridDim =
      dim3(static_cast<unsigned>(plan.tiles / batch * plan.ctiles), batch, plan.splits);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = plan.splits;  // a tile's splits, one cluster
  config.attrs = cluster;
  config.numAttrs = plan.splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&config, kernel, x, w9, bias, y, ws, ssq, cin, cout, height,
                            width, plan.tile, vec_w, vec_y);
}

cudaError_t launch_tensor_core(const void* x, const void* w9, const void* bias, void* y,
                               float* ws, float* ssq, int batch, int cin, int cout, int height,
                               int width, int sms, cudaStream_t stream) {
  const Plan plan = make_plan(batch, cin, cout, height, width, sms);
  const bf16* xt = static_cast<const bf16*>(x);
  const float* wt = static_cast<const float*>(w9);
  const float* bt = static_cast<const float*>(bias);
  bf16* yt = static_cast<bf16*>(y);
  cudaError_t err = cudaErrorInvalidValue;
  switch (plan.config) {
#define FUSED_CONV_CASE(id, MT, NT, WM, WN, TAPS, STAGES, MINB)                         \
  case id:                                                                              \
    err = launch_mma_config<MT, NT, WM, WN, TAPS, STAGES, MINB>(                        \
        plan, xt, wt, bt, yt, ws, ssq, batch, cin, cout, height, width, stream);        \
    break;
    FUSED_CONV_CONFIGS(FUSED_CONV_CASE)
#undef FUSED_CONV_CASE
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t check(int dtype, int device, int batch, int cin, int cout, int height, int width,
                  bool two_pass, int* sms) {
  if (batch < 1 || batch > 65535 || cin < 1 || cout < 1 || height < 1 || width < 1 ||
      static_cast<int64_t>(height) * width > INT_MAX - kNormPixels ||
      (cout > kCoutTile) != two_pass || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core variant), 1 = bfloat16 (the
// tensor-core one), for x and y. x, w9, bias and y are contiguous (see the
// top of the file). Past kCoutTile output channels (and only there) ws and
// ssq are the two passes' scratch: ws fp32 [B, Cout, H, W] (y itself for
// fp32), ssq fp32 [ceil(Cout / kCoutTile), B, H W]; else both are null.
// Launches on `stream` (one kernel, or the two passes) and returns the
// cudaError_t of cudaGetLastError() after the launches (0 on success).
extern "C" int fused_conv3x3_leaky_pixel_norm(const void* x, const void* w9, const void* bias,
                                              void* y, void* ws, void* ssq, int dtype,
                                              int device, int batch, int cin, int cout,
                                              int height, int width, void* stream) {
  int sms = 0;
  const bool two_pass = ws != nullptr && ssq != nullptr;
  cudaError_t err = check(dtype, device, batch, cin, cout, height, width, two_pass, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  float* ssqf = static_cast<float*>(ssq);
  if (dtype == 0) {
    err = launch_cuda_core(x, w9, bias, y, ssqf, batch, cin, cout, height, width, s);
  } else {
    err = launch_tensor_core(x, w9, bias, y, wsf, ssqf, batch, cin, cout, height, width, sms,
                             s);
  }
  if (err != cudaSuccess || !two_pass) return static_cast<int>(err);
  const int hw = height * width;
  err = dtype == 0 ? launch_pixel_norm_pass<float>(wsf, ssqf, y, batch, cout, hw, s)
                   : launch_pixel_norm_pass<bf16>(wsf, ssqf, y, batch, cout, hw, s);
  return static_cast<int>(err);
}
