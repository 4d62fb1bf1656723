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
// is written. A wider layer (min_channels above 1024) is cut into channel
// tiles of kChannelTile = 256 (a block of 64 pixels in bf16, 32 in fp32,
// 16 at images of 16 pixels or fewer), and the channel tiles of one pixel
// tile form one thread-block cluster (blockIdx.x: channel tile fastest):
//  - one pass up to kOnePassWidth = 8 tiles (2048 channels): each block
//    applies bias and leaky to its tile, leaves its pixels' sums of squares
//    over the tile in its shared memory, and after cluster.sync() adds
//    every block's sums in rank order through distributed shared memory
//    (fixed: deterministic, no atomics), scales its own channels and rounds
//    them once. No workspace, no second kernel. The channel tiles of a
//    cluster are 8 at most, the portable size: 2048 channels cover the
//    widest layer the JAX package's configs are run at here (min_channels
//    2048), and 16 tiles (non-portable) would need 16 free SMs of one GPC
//    for every pixel tile of a large image. At 16 pixels or fewer (1 pixel
//    tile an image, 10-16 blocks at batch 2) the cluster also splits K, up
//    to 16 blocks (non-portable; fewer where the card holds no such
//    cluster, cudaOccupancyMaxActiveClusters), each split's partial sums
//    added in rank order before the tiles' sums of squares;
//  - past 2048 channels, two passes, a route of their own (the wrapper
//    counts it): each block writes its tile's fp32 values to a workspace
//    and its pixels' sums of squares to `ssq` [tiles][B][H W], both
//    allocated by the caller (the workspace is y itself when y is fp32),
//    then `pixel_norm_pass` adds each pixel's tile sums in tile order,
//    scales the fp32 values and rounds y once.
// The products and sums are those of the narrow kernel: only the order of
// the sum of squares' additions differs. Weights: a block stages its
// tile's 9 Cin x 256 weights (fp32) once for its pixels, and the blocks that
// share a channel tile (one a cluster) run side by side in the raster, so
// the layer's weights stream from device memory about once a wave and the
// rest from L2. At Cout 2048, 32 px, B 2 (bf16) the blocks stage 4.8 GB of
// weights (256 blocks of 64 pixels, 18.9 MB each), where 1024-channel blocks
// of 16 pixels staged 19.3 GB.
//
// One kernel, `fused_conv_mma_kernel<T, ...>`, in two variants chosen by
// x's type T: an implicit GEMM [B H W pixels, 9 Cin] x [9 Cin, Cout] on the
// tensor cores with fp32 accumulators and the epilogue fused.
//  - bf16 x (the tensor-core variant): mma.sync m16n8k16. Each multiply-add
//    is two bf16 products (below), so the 13 layers of a pggan256 generator
//    pass at batch 12 are 105.6 GFLOP of tensor-core work, 0.107 ms at the
//    989 TFLOP/s bf16 peak; the 128 and 256 px layers, with 16-64
//    channels, are bound by their bytes instead (x read and y written
//    once: 15-22 us at 256 px).
//  - fp32 x (the TF32 variant, 3xTF32): mma.sync m16n8k8 tf32. Each
//    multiply-add is three TF32 products (below): the pass's 52.8 GFLOP
//    are 158 GFLOP of TF32 work, 0.32 ms at the 495 TFLOP/s TF32 peak
//    (0.79 ms for the same products on the CUDA cores' 67 TFLOP/s).
//  - Numerics. The TPU kernel's weights are fp32; rounding them to bf16 or
//    TF32 would compute another function. bf16: each weight is split while
//    it is staged into hi = bf16(w) and lo = bf16(w - hi), and every
//    fragment is multiplied twice (x hi, then x lo) into one fp32
//    accumulator: x is exact in bf16 and w is carried to about 16 bits,
//    against the output's 8. fp32: x is not exact in TF32, so both x and w
//    are split (flash_mma.cuh: hi = tf32(v) by cvt.rna, lo = v - hi cut to
//    TF32), x as its halo tile is staged and w as each K step's weights
//    are, each once in shared memory for every warp of the block, and a
//    product is x_lo w_hi + x_hi w_lo + x_hi w_hi (about 2^-21 of it
//    lost). The tensor cores' fp32 sums cut toward zero, which over the
//    2304 products of a 256-channel pixel would drift past fp32's
//    tolerance (as the fp32 flash kernels' did over a long N), so each K
//    chunk's products go to fresh accumulators, added to the pixel's sums
//    by fp32 adds on the CUDA cores.
//  - Layout. A block owns a TH x TW rectangle of one image's pixels (up to
//    M of them: the GEMM's rows) and every output channel (the pixel norm
//    needs them all): M shrinks as Cout grows (256 pixels at 16-32
//    channels down to 16 at 1024), so that the accumulators fit the
//    registers of 8 warps. x's halo tile [(TH+2)(TW+2) positions][a K
//    chunk's channels] is staged channel-last: read along W from NCHW
//    (coalesced) into registers and stored transposed, so that every tap
//    is a row offset. bf16: a chunk is 16 channels, rows padded to 48
//    bytes (conflict-free ldmatrix), an A fragment is one ldmatrix. fp32:
//    ldmatrix cannot move 32-bit elements, so a chunk is 8 channels (one
//    k8 step a tap), split into hi and lo rows of 8 words stored in the
//    order 0 4 1 5 2 6 3 7: the A fragment's k tig and k tig + 4 of a row
//    are then one 8-byte load, and a half warp's loads of 4 positions
//    cover the 32 banks. The weights of one K step, [taps x chunk][Cout],
//    come by 16-byte cp.async into an fp32 buffer, are split into the hi
//    and lo rows of a double buffer (bf16 pairs, or TF32 words in rows of
//    Cout + 8, where the B fragments' 32-bit loads at k rows tig and tig +
//    4 fall in 32 banks), and are read by ldmatrix.trans (bf16) or those
//    loads (fp32). The K loop runs over chunks x 9 taps in steps of 9, 3
//    or 1 taps (bigger steps for narrower layers, whose products per tap
//    are few), one barrier a step; the next steps' weights (a ring of 1 to
//    4 raw stages) and the next chunk's x are in flight while a step
//    computes.
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <climits>

#include <cooperative_groups.h>

#include "flash_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Output channels a block holds (the widest config's N). Wider layers are
// cut into channel tiles of kChannelTile, one pass up to kOnePassWidth (a
// cluster of kMaxCluster tiles), two passes past it (the caller's ssq holds
// ceil(Cout / kChannelTile) tiles).
constexpr int kCoutTile = 1024;
constexpr int kChannelTile = 256;
constexpr int kMaxCluster = 8;  // blocks of a cluster: split-K or channel tiles (portable)
constexpr int kOnePassWidth = kMaxCluster * kChannelTile;
// A one-pass cluster of channel tiles also takes splits of K, up to 16
// blocks (non-portable) where the pixel tiles leave SMs idle (4-16 px).
constexpr int kMaxWideCluster = 16;
constexpr float kSlope = 0.2f;
constexpr float kEps = 1e-6f;

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
                                   int cout, int hw, int tiles, cudaStream_t stream) {
  const dim3 grid((hw + kNormPixels - 1) / kNormPixels,
                  (cout + kNormChannels - 1) / kNormChannels, batch);
  pixel_norm_pass<T><<<grid, kNormPixels, 0, stream>>>(
      ws, ssq, static_cast<T*>(y), tiles, cout, hw);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The implicit GEMM (bf16: tensor-core variant; fp32: TF32 variant).

constexpr int kThreads = 256;    // 8 warps

// The staged halo tile's positions at most, for a block of M pixels; the
// host picks tile shapes within it.
__host__ __device__ constexpr int max_halo(int m) { return 3 * m / 2 + 64; }

// T: x's (and y's) type. MT x NT m16n8 tiles a warp, WM x WN warps. A K
// step is TAPS taps of one chunk of KC input channels (9, 3 or 1: narrow
// layers take bigger steps, so that a step's products outweigh its barrier
// and copies), and STAGES steps of raw fp32 weights are in flight while one
// computes. MINB blocks an SM bound the registers.
template <typename T, int MT, int NT, int WM, int WN, int TAPS, int STAGES, int MINB>
struct Cfg {
  static_assert(WM * WN * 32 == kThreads && NT % 2 == 0 && 9 % TAPS == 0, "8 warps");
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int KC = kF32 ? 8 : 16;       // input channels of a K chunk: a k step a tap
  static constexpr int XS = kF32 ? 8 : KC + 8;   // staged x row stride (of each of hi, lo)
  static constexpr int M = 16 * MT * WM;  // pixels a block owns
  static constexpr int N = 8 * NT * WN;   // output channels, padded
  static constexpr int NS = N + 8;        // staged weight row stride
  static constexpr int kRows = TAPS * KC;  // weight rows of a step
  // x vectors: 8 channels of a position each (bf16 16 bytes, fp32 32)
  static constexpr int kXItems = ((kF32 ? 1 : 2) * max_halo(M) + kThreads - 1) / kThreads;
  static constexpr int kWItems = (kRows * N / 4 + kThreads - 1) / kThreads;  // weight float4s
  static constexpr size_t raw_bytes = STAGES * kRows * N * sizeof(float);
  static constexpr size_t w_bytes = 2 * 2 * kRows * NS * sizeof(T);  // [hi, lo][2][kRows][NS]
  // A staged position: bf16 one row; fp32 hi and lo rows, and the raw
  // copy of the next chunk's 8 values.
  static constexpr size_t pos_bytes = (kF32 ? 2 : 1) * XS * sizeof(T);
  static constexpr size_t raw_pos_bytes = kF32 ? 8 * sizeof(float) : 0;
  static constexpr int YS = M + 16 / static_cast<int>(sizeof(T));  // y tile row stride
  // the warps' row sums [WN][M], the y tile [N][YS], the block's row sums [M]
  static constexpr size_t epi_bytes = WN * M * sizeof(float) + N * YS * sizeof(T) +
                                      M * sizeof(float);
  static constexpr int PS = N + 4;  // row stride (floats) of the split-K partial sums
  // Shared memory for a halo tile of `npos` positions, one x buffer or two,
  // and `splits` blocks a tile: the partial sums [M][PS], then this
  // block's rows of the sum [rows][PS], their sums of squares and scales.
  static constexpr size_t smem(int npos, int xbufs, int splits) {
    const size_t main = raw_bytes + w_bytes + xbufs * npos * pos_bytes + npos * raw_pos_bytes;
    const size_t rows = (M + splits - 1) / splits;
    const size_t reduce = splits > 1 ? ((M + rows) * PS + 2 * rows) * sizeof(float) : 0;
    const size_t most = main > epi_bytes ? main : epi_bytes;
    return most > reduce ? most : reduce;
  }
};

// How a launch cuts the work: TH x TW pixel tiles, tiles_w of them along
// W and tiles_img in an image; Cin in nchunks chunks of KC,
// chunks_per_split of them a block along blockIdx.z; ctiles tiles of N
// output channels (one up to kCoutTile), of which `cluster_ct` form a
// cluster (ctiles in one pass, 1 in two). blockIdx.x is the channel tile
// plus ctiles times the pixel tile.
struct Tile {
  int th, tw, tiles_w, tiles_img, nchunks, chunks_per_split, ctiles, cluster_ct;
};

template <typename T, int MT, int NT, int WM, int WN, int TAPS, int STAGES, int MINB>
__global__ void __launch_bounds__(kThreads, MINB) fused_conv_mma_kernel(
    const T* __restrict__ x, const float* __restrict__ w9, const float* __restrict__ bias,
    T* __restrict__ y, float* __restrict__ ws, float* __restrict__ ssq, int cin, int cout,
    int height, int width, Tile tile, bool vec_w, bool vec_y) {
  using namespace flash_mma;
  using C = Cfg<T, MT, NT, WM, WN, TAPS, STAGES, MINB>;
  constexpr bool kF32 = C::kF32;
  constexpr int M = C::M, N = C::N, NS = C::NS, kRows = C::kRows, KC = C::KC, XS = C::XS;
  constexpr int YS = C::YS;
  constexpr int kStepsPerChunk = 9 / TAPS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem);                   // [STAGES][kRows][N]
  T* whi = reinterpret_cast<T*>(smem + C::raw_bytes);            // [2][kRows][NS]
  T* wlo = whi + 2 * kRows * NS;                                 // [2][kRows][NS]
  // [1 or 2][npos][XS] (fp32: the hi rows, then the lo rows)
  T* xs = reinterpret_cast<T*>(smem + C::raw_bytes + C::w_bytes);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tig = lane % 4, mi = lane / 8, mr = lane % 8;
  const int warp_m = warp % WM, warp_n = warp / WM;
  const int b = blockIdx.y;
  const int ctile = blockIdx.x % tile.ctiles, ptile = blockIdx.x / tile.ctiles;
  const int n0 = ctile * N;  // the block's first output channel
  const int h0 = (ptile / tile.tiles_w) * tile.th;
  const int w0 = (ptile % tile.tiles_w) * tile.tw;
  const int hw = height * width;
  const int halo_w = tile.tw + 2;
  const int npos = (tile.th + 2) * halo_w;
  const int xbuf_elems = (kF32 ? 2 : 1) * npos * XS;  // one x buffer (fp32: the hi rows, then lo)
  // fp32: the next chunk's x as copied, [8][npos], after the one or two x buffers.
  float* xraw = reinterpret_cast<float*>(xs + (tile.chunks_per_split > 1 ? 2 : 1) * xbuf_elems);
  const int tile_px = tile.th * tile.tw;
  const int c_begin = blockIdx.z * tile.chunks_per_split;
  const int nchunks = min(tile.nchunks - c_begin, tile.chunks_per_split);
  const int nsteps = kStepsPerChunk * nchunks;
  const unsigned short* xb =
      reinterpret_cast<const unsigned short*>(x) + static_cast<int64_t>(b) * cin * hw;
  const float* xf = reinterpret_cast<const float*>(x) + static_cast<int64_t>(b) * cin * hw;

  // bf16: each lane's ldmatrix row of each m16 tile, its pixel's halo
  // position at tap (0, 0). fp32: the positions of the A fragment's rows grp
  // and grp + 8 of each m16 tile. Rows past the tile read position 0 and are
  // never stored.
  constexpr int kRowsA = kF32 ? 2 : 1;
  int apos[MT * kRowsA];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < kRowsA; ++r) {
      const int m = warp_m * 16 * MT + mt * 16 + (kF32 ? grp + 8 * r : (mi % 2) * 8 + mr);
      apos[mt * kRowsA + r] = m < tile_px ? (m / tile.tw) * halo_w + m % tile.tw : 0;
    }
  }

  // x: item (g8, pos) is 8 channels of one halo position (bf16: two items
  // a position, 16 bytes each; fp32: one, 32 bytes); items run along the
  // position, so a warp reads along W. Each item's offset in an x plane (-1
  // outside the image) and in a staged tile (-1 past the tile) are the same
  // for every chunk: computed once.
  int xoff[C::kXItems], xdst[C::kXItems];
#pragma unroll
  for (int k = 0; k < C::kXItems; ++k) {
    const int item = tid + k * kThreads;
    const int g8 = item / npos, pos = item - g8 * npos;
    const int hr = pos / halo_w, wr = pos - hr * halo_w;
    const int hh = h0 - 1 + hr, ww = w0 - 1 + wr;
    const bool staged = item < (kF32 ? 1 : 2) * npos;
    xdst[k] = staged ? pos * XS + g8 * 8 : -1;
    xoff[k] = staged && hh >= 0 && hh < height && ww >= 0 && ww < width ? hh * width + ww : -1;
  }
  // bf16: the next chunk's x is loaded into registers and stored
  // transposed. fp32: each of its values is copied by a 4-byte cp.async
  // into xraw (zero filled outside the image and past Cin), which this
  // thread alone reads back when it splits them.
  uint32_t xr[C::kXItems][kF32 ? 1 : 4];
  auto copy_x = [&](int chunk) {
#pragma unroll
    for (int k = 0; k < C::kXItems; ++k) {
      if (xdst[k] < 0) continue;
      const int ci0 = chunk * KC, pos = xdst[k] / XS;
      const float* src = xf + static_cast<int64_t>(ci0) * hw + xoff[k];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool in = xoff[k] >= 0 && ci0 + j < cin;
        cp_async4(xraw + j * npos + pos, in ? src + static_cast<int64_t>(j) * hw : xf,
                  in ? 4 : 0);
      }
    }
  };
  auto load_x = [&](int chunk) {
#pragma unroll
    for (int k = 0; k < C::kXItems; ++k) {
      if constexpr (!kF32) {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (xoff[k] >= 0) {
          const int ci0 = chunk * KC + (xdst[k] % XS);  // g8 * 8 of the item
          const unsigned short* src = xb + static_cast<int64_t>(ci0) * hw + xoff[k];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint32_t bits = ci0 + j < cin ? __ldg(src + static_cast<int64_t>(j) * hw) : 0u;
            v[j / 2] |= bits << (16 * (j % 2));
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) xr[k][j] = v[j];
      }
    }
  };
  // fp32: each value (this thread's copies in xraw) split into hi and lo,
  // the 8 channels in the order 0 4 1 5 2 6 3 7 (k tig and k tig + 4 of an
  // A fragment side by side).
  auto store_x = [&](int buf) {
    T* dst = xs + buf * xbuf_elems;
#pragma unroll
    for (int k = 0; k < C::kXItems; ++k) {
      if (xdst[k] < 0) continue;
      if constexpr (kF32) {
        Tf32Split s[8];
        const int pos = xdst[k] / XS;
#pragma unroll
        for (int j = 0; j < 8; ++j) s[j] = split_tf32(xraw[j * npos + pos]);
        uint4* hi = reinterpret_cast<uint4*>(dst + xdst[k]);
        uint4* lo = reinterpret_cast<uint4*>(dst + npos * XS + xdst[k]);
        hi[0] = make_uint4(s[0].hi, s[4].hi, s[1].hi, s[5].hi);
        hi[1] = make_uint4(s[2].hi, s[6].hi, s[3].hi, s[7].hi);
        lo[0] = make_uint4(s[0].lo, s[4].lo, s[1].lo, s[5].lo);
        lo[1] = make_uint4(s[2].lo, s[6].lo, s[3].lo, s[7].lo);
      } else {
        *reinterpret_cast<uint4*>(dst + xdst[k]) =
            make_uint4(xr[k][0], xr[k][1], xr[k][2], xr[k][3]);
      }
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
      const int ci = chunk * KC + row % KC;
      const float* src =
          w9 + (static_cast<int64_t>(tap0 + row / KC) * cin + ci) * cout + n0 + col;
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
  // rows of weight buffer s & 1: bf16 halves, or TF32 words.
  auto split_w = [&](int s) {
    const float* stage = raw + (s % STAGES) * kRows * N;
#pragma unroll
    for (int k = 0; k < C::kWItems; ++k) {
      const int item = tid + k * kThreads;
      if ((kRows * N / 4) % kThreads != 0 && item >= kRows * N / 4) break;
      const int row = item / (N / 4), col = 4 * (item % (N / 4));
      const float4 v = *reinterpret_cast<const float4*>(stage + row * N + col);
      const int off = (s & 1) * kRows * NS + row * NS + col;
      if constexpr (kF32) {
        const Tf32Split s0 = split_tf32(v.x), s1 = split_tf32(v.y), s2 = split_tf32(v.z),
                        s3 = split_tf32(v.w);
        *reinterpret_cast<uint4*>(whi + off) = make_uint4(s0.hi, s1.hi, s2.hi, s3.hi);
        *reinterpret_cast<uint4*>(wlo + off) = make_uint4(s0.lo, s1.lo, s2.lo, s3.lo);
      } else {
        const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
        const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
        const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
        const __nv_bfloat162 l01 = __floats2bfloat162_rn(v.x - f01.x, v.y - f01.y);
        const __nv_bfloat162 l23 = __floats2bfloat162_rn(v.z - f23.x, v.w - f23.y);
        *reinterpret_cast<uint2*>(whi + off) = make_uint2(
            *reinterpret_cast<const uint32_t*>(&h01), *reinterpret_cast<const uint32_t*>(&h23));
        *reinterpret_cast<uint2*>(wlo + off) = make_uint2(
            *reinterpret_cast<const uint32_t*>(&l01), *reinterpret_cast<const uint32_t*>(&l23));
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
        acc[mt][nt][3] = 0.f;
  }
  // fp32: the current chunk's products, in fresh accumulators (the tensor
  // cores' sums cut toward zero), added to acc by fp32 adds at its end.
  float cacc[kF32 ? MT : 1][kF32 ? NT : 1][4];

  // One step: taps tap0 .. tap0 + TAPS of the chunk in x buffer `xbuf`,
  // weights in buffer `wb`. bf16: per tap, all hi products, then all lo
  // products: each accumulator's two products are MT * NT mma apart.
  // fp32: per tap and pair of n8 tiles, the lo x hi products, then hi x lo,
  // then hi x hi, each over the pair and the m16 tiles.
  auto compute = [&](int wb, int xbuf, int tap0) {
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      const int tap = tap0 + t;
      if constexpr (kF32) {
        const float* xh = reinterpret_cast<const float*>(xs) + xbuf * xbuf_elems +
                          ((tap / 3) * halo_w + tap % 3) * XS + 2 * tig;
        const float* xl = xh + npos * XS;
        Tf32Frag a[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float2 h0 = *reinterpret_cast<const float2*>(xh + apos[2 * mt] * XS);
          const float2 h1 = *reinterpret_cast<const float2*>(xh + apos[2 * mt + 1] * XS);
          const float2 l0 = *reinterpret_cast<const float2*>(xl + apos[2 * mt] * XS);
          const float2 l1 = *reinterpret_cast<const float2*>(xl + apos[2 * mt + 1] * XS);
          a[mt] = {{__float_as_uint(h0.x), __float_as_uint(h1.x), __float_as_uint(h0.y),
                    __float_as_uint(h1.y)},
                   {__float_as_uint(l0.x), __float_as_uint(l1.x), __float_as_uint(l0.y),
                    __float_as_uint(l1.y)}};
        }
        const int woff = wb * kRows * NS + (t * KC + tig) * NS + warp_n * 8 * NT + grp;
        const uint32_t* wh = reinterpret_cast<const uint32_t*>(whi) + woff;
        const uint32_t* wl = reinterpret_cast<const uint32_t*>(wlo) + woff;
#pragma unroll
        for (int j = 0; j < NT; j += 2) {  // b0: k tig, b1: k tig + 4; column grp of tile j, j + 1
          const uint32_t bh[2][2] = {{wh[8 * j], wh[4 * NS + 8 * j]},
                                     {wh[8 * j + 8], wh[4 * NS + 8 * j + 8]}};
          const uint32_t bl[2][2] = {{wl[8 * j], wl[4 * NS + 8 * j]},
                                     {wl[8 * j + 8], wl[4 * NS + 8 * j + 8]}};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma1688_tf32(cacc[mt][j + e], a[mt].lo, bh[e][0], bh[e][1]);
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma1688_tf32(cacc[mt][j + e], a[mt].hi, bl[e][0], bl[e][1]);
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma1688_tf32(cacc[mt][j + e], a[mt].hi, bh[e][0], bh[e][1]);
            }
          }
        }
      } else {
        const bf16* xt = xs + xbuf * xbuf_elems + ((tap / 3) * halo_w + tap % 3) * XS +
                         (mi / 2) * 8;
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[mt], xt + apos[mt] * XS);
        const int woff = wb * kRows * NS + (t * KC + 8 * (mi % 2) + mr) * NS + warp_n * 8 * NT +
                         8 * (mi / 2);
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          const bf16* wt = (part == 0 ? whi : wlo) + woff;
#pragma unroll
          // matrices: (k +0, n +0), (+8, +0), (+0, +8), (+8, +8)
          for (int j = 0; j < NT / 2; ++j) {
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
    }
  };

  // Prologue: steps 0 .. STAGES - 1 copied (one cp.async group each; fp32
  // copies chunk 0's x in the first), step 0 split, step STAGES copied into
  // its stage; chunk 0's x staged.
  if constexpr (kF32) copy_x(c_begin);
  for (int s = 0; s < STAGES; ++s) {
    if (s < nsteps) copy_w(s);
    cp_async_commit();
  }
  if constexpr (!kF32) load_x(c_begin);
  cp_async_wait<STAGES - 1>();
  store_x(0);
  split_w(0);
  if (STAGES < nsteps) copy_w(STAGES);
  cp_async_commit();
  __syncthreads();
  // Step s computes from weight buffer s & 1 while step s + 1's raw stage
  // (copied STAGES steps earlier) is split into the other buffer, and its
  // stage is refilled with step s + 1 + STAGES. A chunk's first step loads
  // the next chunk's x into registers (fp32: copies it into xraw, in that
  // step's group), its last stores them. One barrier a step: the buffers
  // written in step s were last read in step s - 1.
  for (int s = 0; s < nsteps; ++s) {
    const int chunk = s / kStepsPerChunk, sub = s % kStepsPerChunk;
    const bool more_x = chunk + 1 < nchunks;
    if (sub == 0 && more_x) {
      if constexpr (kF32) {
        copy_x(c_begin + chunk + 1);
      } else {
        load_x(c_begin + chunk + 1);
      }
    }
    if constexpr (kF32) {
      if (sub == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) cacc[mt][nt][0] = cacc[mt][nt][1] = cacc[mt][nt][2] =
              cacc[mt][nt][3] = 0.f;
        }
      }
    }
    compute(s & 1, chunk & 1, TAPS * sub);
    if constexpr (kF32) {
      if (sub == kStepsPerChunk - 1) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += cacc[mt][nt][e];
          }
        }
      }
    }
    if (s + 1 < nsteps) {
      cp_async_wait<STAGES - 1>();
      split_w(s + 1);  // reads its own copies, then their stage is refilled
      if (s + 1 + STAGES < nsteps) copy_w(s + 1 + STAGES);
      cp_async_commit();
    }
    if (sub == kStepsPerChunk - 1 && more_x) {
      // fp32: the x copies went with the group of the chunk's first step,
      // which the wait above covers when a chunk has more steps than
      // STAGES; else wait for that group (kStepsPerChunk - 1 newer ones
      // may stay in flight).
      if constexpr (kF32 && kStepsPerChunk <= STAGES) cp_async_wait<kStepsPerChunk - 1>();
      store_x((chunk + 1) & 1);
    }
    __syncthreads();
  }

  T* yb = y + static_cast<int64_t>(b) * cout * hw;
  // Two passes (ssq set): the tile's fp32 values go to ws and its pixels'
  // sums of squares to ssq; pixel_norm_pass scales and rounds them.
  const int ncols = min(N, cout - n0);  // the block's output channels
  float* wsb = ws ? ws + (static_cast<int64_t>(b) * cout + n0) * hw : nullptr;
  float* ssqb = ssq ? ssq + (static_cast<int64_t>(ctile) * gridDim.y + b) * hw : nullptr;
  namespace cg = cooperative_groups;
  // Split K: the gridDim.z blocks of a tile are one cluster. Each puts its
  // partial sums in its shared memory (the staging buffers are retired),
  // then sums one slice of the tile's rows over the cluster's blocks in
  // rank order (distributed shared memory: deterministic, no atomics) and
  // applies the epilogue to them. In a one-pass cluster of several channel
  // tiles (cct of them, each split gridDim.z ways; rank = channel tile +
  // cct split), each block's row sums of squares are then added over the
  // channel tiles of its split, in rank order.
  const int cct = tile.cluster_ct;
  if (gridDim.z > 1) {
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
    const int splits = static_cast<int>(gridDim.z), split = static_cast<int>(blockIdx.z);
    const int me = ctile % cct;  // the block's channel tile in the cluster
    const int rows = (M + splits - 1) / splits, r0 = split * rows;
    const int nrows = max(0, min(M, r0 + rows) - r0);
    float* sum = part + M * PS;      // [rows][PS]
    float* ssq_rows = sum + rows * PS;  // [rows]: over this tile's channels
    float* scale = ssq_rows + rows;     // [rows]
    for (int i = tid; i < nrows * N; i += kThreads) {
      const int m = r0 + i / N, col = i % N;
      float v = 0.f;
      for (int sp = 0; sp < splits; ++sp) {
        v += cluster.map_shared_rank(part, me + cct * sp)[m * PS + col];
      }
      v += col < ncols ? __ldg(bias + n0 + col) : 0.f;  // past Cout: 0
      sum[(m - r0) * PS + col] = fmaxf(kSlope * v, v);
    }
    cluster.sync();  // no block reads another's partial sums after this
    for (int i = warp; i < nrows; i += kThreads / 32) {  // a warp a row
      float t = 0.f;
      for (int col = lane; col < N; col += 32) t = fmaf(sum[i * PS + col], sum[i * PS + col], t);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) t += __shfl_xor_sync(0xffffffffu, t, off);
      if (lane == 0) ssq_rows[i] = t;
    }
    if (cct > 1) cluster.sync();  // every tile's row sums are in place
    else __syncthreads();
    for (int i = tid; i < nrows; i += kThreads) {
      float t = 0.f;
      if (cct > 1) {
        for (int c = 0; c < cct; ++c) t += cluster.map_shared_rank(ssq_rows, c + cct * split)[i];
      } else {
        t = ssq_rows[i];
      }
      scale[i] = ssq ? t : rsqrtf(t / static_cast<float>(cout) + kEps);
    }
    if (cct > 1) cluster.sync();  // no block reads another's row sums after this
    else __syncthreads();
    for (int i = tid; i < ncols * nrows; i += kThreads) {  // along the rows: along W
      const int mm = i % nrows, co = i / nrows, m = r0 + mm;
      const int hh = h0 + m / tile.tw, ww = w0 + m % tile.tw;
      if (m < tile_px && hh < height && ww < width) {
        const int64_t at = static_cast<int64_t>(co) * hw + hh * width + ww;
        if (ssq) {
          wsb[at] = sum[mm * PS + co];
          if (co == 0) ssqb[hh * width + ww] = scale[mm];
        } else {
          store_as(yb + static_cast<int64_t>(n0) * hw + at, sum[mm * PS + co] * scale[mm]);
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
  float* red = reinterpret_cast<float*>(smem);                     // [WN][M]
  T* ys = reinterpret_cast<T*>(smem + WN * M * sizeof(float));     // [N][YS]
  float* rss = reinterpret_cast<float*>(smem + C::epi_bytes) - M;  // [M]
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
  // One pass over a cluster of channel tiles: the block's row sums in rss,
  // then each row's total over the cluster's blocks, in rank order (the
  // cluster spans blockIdx.x alone: rank = channel tile).
  if (cct > 1) {
    for (int m = tid; m < M; m += kThreads) {
      float t = 0.f;
#pragma unroll
      for (int wn = 0; wn < WN; ++wn) t += red[wn * M + m];
      rss[m] = t;
    }
    cg::this_cluster().sync();  // every block's row sums are in place
  }
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
  float scales[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = warp_m * 16 * MT + mt * 16 + grp + 8 * r;
      float total = 0.f;
      if (cct > 1) {
#pragma unroll
        for (int rank = 0; rank < kMaxCluster; ++rank) {
          if (rank < cct) total += cg::this_cluster().map_shared_rank(rss, rank)[m];
        }
      } else {
#pragma unroll
        for (int wn = 0; wn < WN; ++wn) total += red[wn * M + m];
      }
      scales[mt][r] = rsqrtf(total / static_cast<float>(cout) + kEps);
    }
  }
  if (cct > 1) cg::this_cluster().sync();  // no block reads another's row sums after this
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = warp_m * 16 * MT + mt * 16 + grp + 8 * r;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = warp_n * 8 * NT + nt * 8 + 2 * tig;
        store_as(ys + col * YS + m, acc[mt][nt][2 * r] * scales[mt][r]);
        store_as(ys + (col + 1) * YS + m, acc[mt][nt][2 * r + 1] * scales[mt][r]);
      }
    }
  }
  __syncthreads();
  if (vec_y) {  // TW and W multiples of 16 bytes of y: a row's pixels, 16 bytes
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    const int per_row = tile.tw / kVec;
    for (int i = tid; i < ncols * tile.th * per_row; i += kThreads) {
      const int c8 = i % per_row, rest = i / per_row;
      const int r = rest % tile.th, co = rest / tile.th;
      const int hh = h0 + r, ww = w0 + kVec * c8;
      if (hh < height && ww < width) {
        *reinterpret_cast<uint4*>(yb + static_cast<int64_t>(n0 + co) * hw + hh * width + ww) =
            *reinterpret_cast<const uint4*>(ys + co * YS + r * tile.tw + kVec * c8);
      }
    }
  } else {
    for (int i = tid; i < ncols * tile_px; i += kThreads) {
      const int m = i % tile_px, co = i / tile_px;
      const int hh = h0 + m / tile.tw, ww = w0 + m % tile.tw;
      if (hh < height && ww < width) {
        yb[static_cast<int64_t>(n0 + co) * hw + hh * width + ww] = ys[co * YS + m];
      }
    }
  }
}

// The instantiations: (MT, NT, WM, WN, TAPS, STAGES, MINB) -> M pixels,
// N channels, by the variant.
#define FUSED_CONV_CONFIGS(X)                                               \
  X(0, 2, 2, 8, 1, 9, 1, 3)  /* M 256, N 16   */                            \
  X(1, 2, 4, 8, 1, 9, 1, 2)  /* M 256, N 32   */                            \
  X(2, 2, 4, 4, 2, 3, 2, 3)  /* M 128, N 64   */                            \
  X(3, 2, 8, 4, 2, 1, 4, 2)  /* M 128, N 128  */                            \
  X(4, 2, 8, 2, 4, 1, 4, 2)  /* M 64,  N 256  */                            \
  X(5, 1, 4, 1, 8, 1, 4, 3)  /* M 16,  N 256: images of 16 pixels or fewer */ \
  X(6, 1, 8, 1, 8, 1, 3, 2)  /* M 16,  N 512: the same */                   \
  X(7, 2, 8, 1, 8, 1, 3, 1)  /* M 32,  N 512  */                            \
  X(8, 1, 16, 1, 8, 1, 1, 1) /* M 16,  N 1024 = kCoutTile */                \
  X(9, 1, 4, 1, 8, 3, 2, 1)  /* M 16,  N 256: wider layers at 16 pixels or fewer */ \
  X(10, 2, 8, 2, 4, 3, 2, 1) /* M 64,  N 256: wider layers (fp32 alone takes 11) */

// fp32 (TF32): twice the shared memory a staged element and a second set of
// accumulators (each chunk's own), so M is halved or quartered from 32
// channels on and the warps take fewer n8 tiles: at most 64 fp32
// accumulators a thread at 2 blocks an SM, 128 at one: past that the
// registers spill inside the K loop. Layers wider than kCoutTile take
// configs of their own, 10 (M 64: 128 accumulators a thread at one block
// an SM, half the weight bytes a pixel of M 32), 11 (M 32, where M 64
// leaves SMs idle: chip_smoke.py's 1536-channel 16 px row read 1.05 ms
// against 1.53 on an H100; bf16's M 64 stays ahead there) and, at 16
// pixels or fewer, 9 (M 16): a block walks
// 9 Cin / KC steps of its tile's weights, so they take 3 taps a step (48 or
// 24 weight rows, 1 block an SM), where 1 tap a step left the wide layers
// bound by the steps' barriers and copies.
#define FUSED_CONV_TF32_CONFIGS(X)                                          \
  X(0, 2, 2, 8, 1, 9, 1, 2)  /* M 256, N 16   */                            \
  X(1, 1, 4, 8, 1, 3, 2, 2)  /* M 128, N 32   */                            \
  X(2, 2, 4, 4, 2, 3, 2, 2)  /* M 128, N 64   */                            \
  X(3, 1, 4, 2, 4, 3, 1, 2)  /* M 32,  N 128  */                            \
  X(4, 2, 4, 1, 8, 1, 4, 2)  /* M 32,  N 256  */                            \
  X(5, 1, 4, 1, 8, 1, 4, 1)  /* M 16,  N 256: images of 16 pixels or fewer */ \
  X(6, 1, 8, 1, 8, 1, 3, 2)  /* M 16,  N 512: the same */                   \
  X(7, 2, 8, 1, 8, 1, 3, 1)  /* M 32,  N 512  */                            \
  X(8, 1, 16, 1, 8, 1, 1, 1) /* M 16,  N 1024: up to kCoutTile */          \
  X(9, 1, 4, 1, 8, 3, 3, 1)  /* M 16,  N 256: wider layers at 16 pixels or fewer */ \
  X(10, 2, 8, 2, 4, 3, 3, 1) /* M 64,  N 256: wider layers */                \
  X(11, 1, 8, 2, 4, 3, 3, 1) /* M 32,  N 256: the same, where M 64 gives too few blocks */

constexpr int kConfigM[] = {256, 256, 128, 128, 64, 16, 16, 32, 16, 16, 64, 32};
constexpr int kTf32ConfigM[] = {256, 128, 128, 32, 32, 16, 16, 32, 16, 16, 64, 32};
constexpr int kConfigN[] = {16, 32, 64, 128, 256, 256, 512, 512, 1024, 256, 256, 256};  // both

int pick_config(int cout, int hw) {
  if (cout <= 16) return 0;
  if (cout <= 32) return 1;
  if (cout <= 64) return 2;
  if (cout <= 128) return 3;
  if (cout <= 256) return hw <= 16 ? 5 : 4;
  if (cout <= 512) return hw <= 16 ? 6 : 7;
  if (cout <= kCoutTile) return 8;
  return hw <= 16 ? 9 : 10;  // channel tiles of kChannelTile
}

struct Plan {
  int config, splits;
  Tile tile;
  int64_t tiles;  // pixel tiles of the whole batch
};

// Cin's chunks cut into `splits` ranges of whole chunks.
void set_splits(Plan& plan, int splits) {
  plan.tile.chunks_per_split = (plan.tile.nchunks + splits - 1) / splits;
  plan.splits = (plan.tile.nchunks + plan.tile.chunks_per_split - 1) / plan.tile.chunks_per_split;
}

// The pixel tile for a block of M pixels (the config's, from `config_m`):
// TW a power of two from 8 below W, or W itself, and as many rows as fit
// in M and in max_halo(M) staged positions; the least (M + halo positions)
// per pixel wins, powers of two (16-byte stores) on a tie. Then the split
// of Cin's chunks of `kc`: in a layer of one channel tile, the fewest
// power-of-two splits (at most the chunks and kMaxCluster, a cluster's
// blocks) that give every SM a block; in a one-pass layer of several
// channel tiles (5 to 8 in its cluster) at 16 pixels or fewer, the fewest
// splits that do, at most kMaxWideCluster blocks a cluster (the launch
// takes fewer where the card cannot hold such a cluster), and none on
// larger images, whose weights each split would stream again; in a
// two-pass layer, as in one tile, counting the channel tiles.
Plan make_plan(int batch, int cin, int cout, int height, int width, int sms, int kc,
               const int* config_m) {
  Plan plan;
  plan.config = pick_config(cout, height * width);
  // fp32: a wide layer whose 64-pixel blocks would leave SMs without one
  // takes 32-pixel blocks (twice the weight bytes a pixel, twice the
  // blocks). bf16's blocks of 64 stay ahead there.
  const int64_t ctiles_wide = (cout + kChannelTile - 1) / kChannelTile;
  if (plan.config == 10 && kc == 8 &&
      batch * ((static_cast<int64_t>(height) * width + 63) / 64) * ctiles_wide < sms) {
    plan.config = 11;
  }
  const int m = config_m[plan.config];
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
  const int ctiles = (cout + kConfigN[plan.config] - 1) / kConfigN[plan.config];
  plan.tile.ctiles = ctiles;
  plan.tile.cluster_ct = cout <= kOnePassWidth ? ctiles : 1;
  plan.tile.nchunks = (cin + kc - 1) / kc;
  int splits = 1;
  if (plan.tile.cluster_ct == 1) {
    while (plan.tiles * ctiles * splits < sms &&
           2 * splits <= min(plan.tile.nchunks, kMaxCluster)) {
      splits *= 2;
    }
  } else if (plan.config == 9) {  // 16 pixels or fewer: too few blocks without splits of K
    const int most = min(plan.tile.nchunks, kMaxWideCluster / plan.tile.cluster_ct);
    while (plan.tiles * ctiles * splits < sms && splits < most) ++splits;
  }
  set_splits(plan, splits);
  return plan;
}

template <typename T, int MT, int NT, int WM, int WN, int TAPS, int STAGES, int MINB>
cudaError_t launch_mma_config(Plan plan, const T* x, const float* w9, const float* bias, T* y,
                              float* ws, float* ssq, int batch, int cin, int cout, int height,
                              int width, cudaStream_t stream) {
  using C = Cfg<T, MT, NT, WM, WN, TAPS, STAGES, MINB>;
  static_assert(C::N <= kCoutTile, "a block holds at most kCoutTile channels");
  // Several channel tiles are tiles of kChannelTile (ssq's tiles).
  if (plan.tile.ctiles > 1 && C::N != kChannelTile) return cudaErrorInvalidValue;
  auto kernel = fused_conv_mma_kernel<T, MT, NT, WM, WN, TAPS, STAGES, MINB>;
  const int npos = (plan.tile.th + 2) * (plan.tile.tw + 2);
  // Every config may take up to 227 KB (bf16 Cout 1024: 199 KB) and a
  // cluster of up to kMaxWideCluster blocks; set once.
  static const cudaError_t attr = [&] {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    return e != cudaSuccess ? e : cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  if (attr != cudaSuccess) return attr;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // y elements a 16-byte store
  const bool vec_w = cout % 4 == 0 && reinterpret_cast<uintptr_t>(w9) % 16 == 0;
  const bool vec_y = plan.tile.tw % kVec == 0 && width % kVec == 0 &&
                     reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  config.attrs = cluster;
  for (;;) {
    config.gridDim =
        dim3(static_cast<unsigned>(plan.tiles / batch * plan.tile.ctiles), batch, plan.splits);
    config.dynamicSmemBytes =
        C::smem(npos, plan.tile.chunks_per_split > 1 ? 2 : 1, plan.splits);
    if (config.dynamicSmemBytes > 227 * 1024) return cudaErrorInvalidValue;
    // A pixel tile's channel tiles (one pass) and its splits of K, one cluster.
    cluster[0].val.clusterDim.x = plan.tile.cluster_ct;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = plan.splits;
    config.numAttrs = plan.splits > 1 || plan.tile.cluster_ct > 1 ? 1 : 0;
    if (plan.tile.cluster_ct * plan.splits <= kMaxCluster) break;
    // Past the portable size, fewer splits where the card holds no such cluster.
    int clusters = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (err != cudaSuccess) return err;
    if (clusters > 0) break;
    set_splits(plan, plan.splits - 1);
  }
  return cudaLaunchKernelEx(&config, kernel, x, w9, bias, y, ws, ssq, cin, cout, height,
                            width, plan.tile, vec_w, vec_y);
}

// T = bf16 runs the tensor-core configs, T = float the TF32 ones; `ctiles`
// receives the number of channel tiles (the second pass's ssq tiles).
template <typename T>
cudaError_t launch_tensor_core(const void* x, const void* w9, const void* bias, void* y,
                               float* ws, float* ssq, int batch, int cin, int cout, int height,
                               int width, int sms, cudaStream_t stream, int* ctiles) {
  constexpr bool kF32 = sizeof(T) == 4;
  const Plan plan = make_plan(batch, cin, cout, height, width, sms, kF32 ? 8 : 16,
                              kF32 ? kTf32ConfigM : kConfigM);
  *ctiles = plan.tile.ctiles;
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w9);
  const float* bt = static_cast<const float*>(bias);
  T* yt = static_cast<T*>(y);
  cudaError_t err = cudaErrorInvalidValue;
#define FUSED_CONV_CASE(id, MT, NT, WM, WN, TAPS, STAGES, MINB)                         \
  case id:                                                                              \
    err = launch_mma_config<T, MT, NT, WM, WN, TAPS, STAGES, MINB>(                     \
        plan, xt, wt, bt, yt, ws, ssq, batch, cin, cout, height, width, stream);        \
    break;
  if constexpr (kF32) {
    switch (plan.config) { FUSED_CONV_TF32_CONFIGS(FUSED_CONV_CASE) }
  } else {
    switch (plan.config) { FUSED_CONV_CONFIGS(FUSED_CONV_CASE) }
  }
#undef FUSED_CONV_CASE
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t check(int dtype, int device, int batch, int cin, int cout, int height, int width,
                  bool two_pass, int* sms) {
  if (batch < 1 || batch > 65535 || cin < 1 || cout < 1 || height < 1 || width < 1 ||
      static_cast<int64_t>(height) * width > INT_MAX - kNormPixels ||
      (cout > kOnePassWidth) != two_pass || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace

// dtype: 0 = float32 (the TF32 variant, 3xTF32), 1 = bfloat16 (the
// tensor-core one), for x and y. x, w9, bias and y are contiguous (see the
// top of the file). Past kOnePassWidth output channels (and only there) ws
// and ssq are the two passes' scratch: ws fp32 [B, Cout, H, W] (y itself
// for fp32), ssq fp32 [ceil(Cout / kChannelTile), B, H W]; else both are
// null. Launches on `stream` (one kernel, or the two passes), writes the
// flash_mma::Variant it launched to `variant`, and returns the cudaError_t
// of cudaGetLastError() after the launches (0 on success).
extern "C" int fused_conv3x3_leaky_pixel_norm(const void* x, const void* w9, const void* bias,
                                              void* y, void* ws, void* ssq, int dtype,
                                              int device, int batch, int cin, int cout,
                                              int height, int width, void* stream,
                                              int* variant) {
  int sms = 0;
  const bool two_pass = ws != nullptr && ssq != nullptr;
  cudaError_t err = check(dtype, device, batch, cin, cout, height, width, two_pass, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  float* ssqf = static_cast<float*>(ssq);
  int ctiles = 0;
  if (dtype == 0) {
    *variant = flash_mma::kTf32x3;
    err = launch_tensor_core<float>(x, w9, bias, y, wsf, ssqf, batch, cin, cout, height, width,
                                    sms, s, &ctiles);
  } else {
    *variant = flash_mma::kTensorCore;
    err = launch_tensor_core<bf16>(x, w9, bias, y, wsf, ssqf, batch, cin, cout, height, width,
                                   sms, s, &ctiles);
  }
  if (err != cudaSuccess || !two_pass) return static_cast<int>(err);
  const int hw = height * width;
  err = dtype == 0 ? launch_pixel_norm_pass<float>(wsf, ssqf, y, batch, cout, hw, ctiles, s)
                   : launch_pixel_norm_pass<bf16>(wsf, ssqf, y, batch, cout, hw, ctiles, s);
  return static_cast<int>(err);
}
