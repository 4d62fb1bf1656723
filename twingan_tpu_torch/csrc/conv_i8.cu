// int8 x int8 -> int32 convolution with the dequantize epilogue fused
// (kernel Q1), on Hopper's int8 tensor cores (sm_90a).
//
// The W8A8 serving path's conv (twingan_tpu_torch/ops/quant.py). The JAX
// package computes it with lax.conv_general_dilated(...,
// preferred_element_type=int32) (twingan_tpu/ops/quant.py:69-85), not with
// a Pallas kernel. PyTorch has no int8 convolution on CUDA, and a float32
// conv of the int8 values is not exact (a 3x3x512 product chain passes
// 2^24), so this kernel computes it:
//
//   acc[b,c,oy,ox] = sum_{ky,kx,ci} xd[b, oy+ky-pad_t, ox+kx-pad_l, ci]
//                                   * w[c, ky, kx, ci]
//
// where xd is x dilated by `dil` (1 or 2): xd[iy, ix] = x[iy/dil, ix/dil]
// where iy and ix are multiples of dil and inside the dilated image
// ((H-1) dil + 1 rows), else 0. dil 2 with padding 2 and a 4x4 kernel is
// the fused nearest-up2 + conv3x3 of the generator; the kernel reads
// x[iy/2] where iy is even and never writes the zero-stuffed tensor.
//
// Two loaders, one kernel:
//   conv_i8 (in_kind 0): x is int8 NHWC [B, H, W, Cp] (Cp a multiple of 4,
//     the caller pads channels with zeros), staged by cp.async;
//   conv_i8q (in_kind 1, 2): x is the layer's float activation, NCHW
//     [B, Cin, H, W] in bfloat16 or float32, quantized as it is staged:
//     code = clamp(rint(x * r), -127, 127) with r the float32 reciprocal of
//     the activation's scale (a device pointer, computed by PyTorch), the
//     product __fmul_rn and rint half to even: ops/quant.py's quantize,
//     operation for operation. The int8 NHWC tensor is never written.
// w is int8 [Cout, KH, KW, Cp]; the output is NCHW [B, Cout, Ho, Wo].
//
// Epilogue (out_kind), the order of the JAX layer (models/layers.py:
// 191-208) and of the plain version:
//   0: the int32 sums, stored as they are;
//   1: float32: v = float(acc) * scale[c] (+ bias[c]);
//   2: bfloat16: v = bf16(float(acc)), v = bf16(v * scale[c]),
//      (v = bf16(v + bias[c])), each product and sum in float32 and
//      rounded to nearest even, as PyTorch computes bf16 arithmetic.
// scale and bias are float32 arrays holding values already rounded to the
// output type. The multiply and the add are __fmul_rn and __fadd_rn, so
// the compiler cannot contract them into an fma that rounds once.
//
// What bounds it on an H100: by the card's limits, bytes at the large
// layers (128-256 px, 16-64 channels: a few products per byte of x and of
// the output) and the grid at the small ones (4-32 px: 16-128 output
// tiles); in practice each block's fixed work, the latency of its first
// copies and its per-element index arithmetic, which the design keeps
// small (PERF.md, section 6). The design:
// - products on mma.sync m16n8k32 s8 into int32 registers (exact, so any
//   tiling and split gives the plain version's bits);
// - a block owns th x tw output pixels of one image (th tw = 128; tw 32 on
//   wide maps) by NT output channels (16, 32 or 64 by Cout); 8 warps, 4
//   along the pixels by 2 along the channels, each 32 pixels by NT / 2;
//   at most 85 registers a thread for NT 16 and 32 (3 blocks an SM);
// - each halo position's source offset (or none: a zero) is computed once
//   a block into a table; the copies' items step by shifts and adds, the
//   taps without division;
// - for each chunk of 32 input channels the block stages the tile's input
//   halo, (th + KH - 1) x (tw + KW - 1) positions of the (dilated) input,
//   in shared memory once and runs every tap from it as shifted ldmatrix
//   reads: x crosses device memory about once, plus the halo. Rows of 48
//   bytes (32 codes) keep ldmatrix free of bank conflicts;
// - the chunk's weights (every tap) arrive by cp.async into the other of
//   two buffers while the current chunk computes; the int8 loader's halo
//   too, the float loader's through registers (loaded before the products,
//   quantized and stored after them);
// - where the grid is small, Cin's chunks are split over the blocks of a
//   thread-block cluster (at most 8), which sum their int32 partials
//   through distributed shared memory, each a slice of the tile's
//   channels;
// - the epilogue goes through shared memory (the tile's scales and biases
//   staged beside the sums): a thread keeps one pixel and walks its
//   channels, so each channel's pixel rows are written contiguously
//   (NCHW).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using flash_mma::cp_async16;
using flash_mma::cp_async4;
using flash_mma::cp_async_commit;
using flash_mma::cp_async_wait;
using flash_mma::ldmatrix_x2;
using flash_mma::ldmatrix_x4;
using flash_mma::mma16832_s8;

constexpr int kThreads = 256;  // 8 warps: 4 along the pixels by 2 along the channels
constexpr int kM = 128;        // output pixels a block: th x tw of one image
constexpr int kKC = 32;        // input channels a chunk: one k32 product a tap
constexpr int kRow = 48;       // bytes a staged position or weight row: 32 codes, 16 spare
constexpr int kMaxHalo = 256;  // staged input positions a chunk
constexpr int kMaxSplits = 8;  // the splits of a tile form a cluster: 8 blocks at most
constexpr int kPS = kM + 4;    // int32 stride of the partial sums [NT][kPS]
constexpr int kXItems = kMaxHalo * (kKC / 4) / kThreads;  // float loader: 4-channel groups a thread
constexpr int kMaxSmem = 227 * 1024;

enum InKind { kInt8 = 0, kBf16 = 1, kFp32 = 2 };

struct Geom {
  int batch, height, width;
  int cin;  // channels of x: Cp (int8, = w's) or the float tensor's Cin
  int cp;   // channels of a weight row, a multiple of 4
  int cout, kh, kw, pad_t, pad_l, dil, ho, wo;
  int th, tw, tw_shift, tiles_w;  // the block's output tile (tw = 1 << tw_shift), tiles along W
  int hh, hw;           // the staged halo: th + kh - 1 rows, tw + kw - 1 columns
  int xbytes;           // one halo buffer in shared memory
  int ntn;              // channel tiles of NT
  int nchunks, chunks_per_split;
  int vec_x, vec_w;  // 16-byte copies where aligned, else 4-byte
  int out_kind;
  int64_t sb, sc, sh, sw;  // the float loader's x strides, in elements
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t quant_code(float v, float r) {
  const int q = __float2int_rn(__fmul_rn(v, r));  // saturates past the int range
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(max(-127, min(127, q)))));
}

// The float loader keeps x's raw bits in registers between its loads and
// the quantize: float32 one a register, bfloat16 two (a bf16 value is the
// top half of the float32 with the same value).
template <int IN>
struct Raw {
  using T = uint32_t;  // float32 bits
  static constexpr int kPerReg = 1;
  __device__ static float value(const uint32_t* r, int j) { return __uint_as_float(r[j]); }
};
template <>
struct Raw<kBf16> {
  using T = unsigned short;  // bfloat16 bits
  static constexpr int kPerReg = 2;
  __device__ static float value(const uint32_t* r, int j) {
    return __uint_as_float(((r[j >> 1] >> (16 * (j & 1))) & 0xffffu) << 16);
  }
};

template <int NT, int IN>
__global__ void __launch_bounds__(kThreads, NT <= 32 ? 3 : 2)
    conv_i8_mma_kernel(const void* __restrict__ x, const float* __restrict__ rscale,
                       const int8_t* __restrict__ w, const float* __restrict__ scale,
                       const float* __restrict__ bias, void* __restrict__ out, const Geom g) {
  using Bits = Raw<IN>;
  using T = typename Bits::T;
  constexpr int MI = 2;        // m16 tiles a warp: its 32 pixels
  constexpr int NI = NT / 16;  // n8 tiles a warp: its NT / 2 channels
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int grp = lane >> 2, tig = lane & 3;
  const int b = blockIdx.y / g.ntn;
  const int n0 = (blockIdx.y - b * g.ntn) * NT;
  const int oy0 = (blockIdx.x / g.tiles_w) * g.th;
  const int ox0 = (blockIdx.x % g.tiles_w) * g.tw;
  const int iy0 = oy0 - g.pad_t, ix0 = ox0 - g.pad_l;  // the halo's origin, dilated
  const int taps = g.kh * g.kw;
  const int npos = g.hh * g.hw;
  const int shift = g.dil - 1;  // dil 1 or 2
  const int last_y = (g.height - 1) * g.dil, last_x = (g.width - 1) * g.dil;
  // Two stages of [halo | weights]; stage s at smem + s * stage_bytes.
  const int stage_bytes = g.xbytes + taps * NT * kRow;
  const int c_lo = blockIdx.z * g.chunks_per_split;
  const int c_hi = min(g.nchunks, c_lo + g.chunks_per_split);

  // The halo's positions, once a block: each one's element offset in x's
  // image (its row and column), or -1 where it reads a zero (outside the
  // image, or between the dilated rows and columns).
  int* src_off = reinterpret_cast<int*>(smem + 2 * stage_bytes);
  for (int pos = tid; pos < npos; pos += kThreads) {
    const int hr = pos / g.hw, hc = pos - hr * g.hw;
    const int iy = iy0 + hr, ix = ix0 + hc;
    const bool in = iy >= 0 && ix >= 0 && iy <= last_y && ix <= last_x &&
                    ((iy | ix) & shift) == 0;
    const int sy = iy >> shift, sx = ix >> shift;
    src_off[pos] = !in ? -1
                   : IN == kInt8 ? (sy * g.width + sx) * g.cin
                                 : static_cast<int>(sy * g.sh + sx * g.sw);
  }
  __syncthreads();

  // The chunk's weights, every tap: rows (tap, n) of 32 codes.
  auto stage_w = [&](int chunk, unsigned char* dst) {
    const int c0 = chunk * kKC;
    const int pshift = g.vec_w ? 1 : 3, bytes = g.vec_w ? 16 : 4;  // 2 or 8 pieces a row
    for (int i = tid; i < (taps * NT) << pshift; i += kThreads) {
      const int row = i >> pshift, piece = i - (row << pshift);
      const int t = row / NT, n = row - t * NT;
      const int ch = c0 + bytes * piece;
      const bool in = n0 + n < g.cout && ch < g.cp;
      const int8_t* src = in ? w + (static_cast<int64_t>(n0 + n) * taps + t) * g.cp + ch : w;
      if (g.vec_w) {
        cp_async16(dst + row * kRow + 16 * piece, src, in ? 16 : 0);
      } else {
        cp_async4(dst + row * kRow + 4 * piece, src, in ? 4 : 0);
      }
    }
  };

  // int8 loader: the chunk's halo of x (NHWC) by cp.async.
  auto stage_x8 = [&](int chunk, unsigned char* dst) {
    const int8_t* xp = static_cast<const int8_t*>(x);
    const int c0 = chunk * kKC;
    const int pshift = g.vec_x ? 1 : 3, bytes = g.vec_x ? 16 : 4;  // 2 or 8 pieces a position
    const int8_t* image = xp + static_cast<int64_t>(b) * g.height * g.width * g.cin;
    for (int i = tid; i < npos << pshift; i += kThreads) {
      const int pos = i >> pshift, piece = i - (pos << pshift);
      const int ch = c0 + bytes * piece;
      const int off = src_off[pos];
      const bool in = off >= 0 && ch < g.cin;
      const int8_t* src = in ? image + off + ch : xp;
      if (g.vec_x) {
        cp_async16(dst + pos * kRow + 16 * piece, src, in ? 16 : 0);
      } else {
        cp_async4(dst + pos * kRow + 4 * piece, src, in ? 4 : 0);
      }
    }
  };

  // Float loader: item i = q npos + pos is 4 channels (4 q ..) of one halo
  // position, so a warp's positions run along W (coalesced reads of each
  // channel plane where x is NCHW; any strides are read). Thread tid's
  // items are tid + 256 it: (q, pos) steps by (256 / npos, 256 % npos).
  // Loaded into registers, then quantized into the halo as 32-bit words.
  uint32_t xv[kXItems][4 / Bits::kPerReg];
  const float rs = IN == kInt8 ? 0.f : __ldg(rscale);
  const int q0 = tid / npos, pos0 = tid - q0 * npos;
  const int q_step = kThreads / npos, pos_step = kThreads - q_step * npos;
  auto next_item = [&](int& q, int& pos) {
    q += q_step;
    pos += pos_step;
    if (pos >= npos) {
      pos -= npos;
      ++q;
    }
  };
  auto load_xf = [&](int chunk) {
    const T* image = static_cast<const T*>(x) + b * g.sb;
    const int c0 = chunk * kKC;
    int q = q0, pos = pos0;
#pragma unroll
    for (int it = 0; it < kXItems; ++it) {
      if (it > 0) next_item(q, pos);
      const int c = c0 + 4 * q;
      const int off = q < 8 ? src_off[pos] : -1;
      const T* src = image + c * g.sc + off;
#pragma unroll
      for (int r = 0; r < 4 / Bits::kPerReg; ++r) xv[it][r] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t v = (off >= 0 && c + j < g.cin) ? src[j * g.sc] : 0u;
        xv[it][j / Bits::kPerReg] |= v << (32 / Bits::kPerReg) * (j % Bits::kPerReg);
      }
    }
  };
  auto store_xf = [&](unsigned char* dst) {
    int q = q0, pos = pos0;
#pragma unroll
    for (int it = 0; it < kXItems; ++it) {
      if (it > 0) next_item(q, pos);
      if (q < 8) {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) word |= quant_code(Bits::value(xv[it], j), rs) << (8 * j);
        *reinterpret_cast<uint32_t*>(dst + pos * kRow + 4 * q) = word;
      }
    }
  };

  // This lane's ldmatrix rows: A, pixels (its halo position at tap 0, the
  // 16-byte half of the 32 codes); B, output channels of a tap.
  int a_off[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int m = warp_m * 32 + mi * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int r = m >> g.tw_shift, c = m - (r << g.tw_shift);
    const int pos = m < g.th * g.tw ? r * g.hw + c : 0;  // past the tile: any row
    a_off[mi] = pos * kRow + 16 * (lane >> 4);
  }
  const int b_off = NI == 1
                        ? (warp_n * 8 + (lane & 7)) * kRow + 16 * ((lane >> 3) & 1)
                        : (warp_n * (NT / 2) + (lane & 7) + 8 * (lane >> 4)) * kRow +
                              16 * ((lane >> 3) & 1);

  int acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NI; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0;

  auto compute = [&](const unsigned char* xsb, const unsigned char* wsb) {
    for (int t = 0, ky = 0, kx = 0; t < taps; ++t) {
      const int tap = (ky * g.hw + kx) * kRow;
      if (++kx == g.kw) {
        kx = 0;
        ++ky;
      }
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) ldmatrix_x4(a[mi], xsb + a_off[mi] + tap);
      uint32_t bf[NI][2];
      const unsigned char* wt = wsb + t * NT * kRow + b_off;
      if constexpr (NI == 1) {
        ldmatrix_x2(bf[0], wt);
      } else {
#pragma unroll
        for (int p = 0; p < NI / 2; ++p) {
          uint32_t r[4];
          ldmatrix_x4(r, wt + 16 * p * kRow);
          bf[2 * p][0] = r[0];
          bf[2 * p][1] = r[1];
          bf[2 * p + 1][0] = r[2];
          bf[2 * p + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nj = 0; nj < NI; ++nj) mma16832_s8(acc[mi][nj], a[mi], bf[nj][0], bf[nj][1]);
    }
  };

  // The chunks, two stages deep.
  if (c_lo < c_hi) {
    if constexpr (IN == kInt8) {
      stage_x8(c_lo, smem);
    } else {
      load_xf(c_lo);
      store_xf(smem);
    }
    stage_w(c_lo, smem + g.xbytes);
    cp_async_commit();
  }
  for (int chunk = c_lo; chunk < c_hi; ++chunk) {
    unsigned char* cur = smem + ((chunk - c_lo) & 1) * stage_bytes;
    unsigned char* next = smem + ((chunk - c_lo + 1) & 1) * stage_bytes;
    const bool more = chunk + 1 < c_hi;
    if (more) {
      stage_w(chunk + 1, next + g.xbytes);
      if constexpr (IN == kInt8) {
        stage_x8(chunk + 1, next);
      } else {
        load_xf(chunk + 1);
      }
    }
    cp_async_commit();
    cp_async_wait<1>();  // this chunk's copies have landed
    __syncthreads();
    compute(cur, cur + g.xbytes);
    if constexpr (IN != kInt8) {
      if (more) store_xf(next);
    }
    __syncthreads();  // this chunk's stage is free
  }
  cp_async_wait<0>();

  // The int32 sums, [NT][kPS] in shared memory (the buffers are retired).
  int* part = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int nj = 0; nj < NI; ++nj) {
      const int m = warp_m * 32 + mi * 16 + grp;
      const int n = warp_n * (NT / 2) + nj * 8 + 2 * tig;
      part[n * kPS + m] = acc[mi][nj][0];
      part[(n + 1) * kPS + m] = acc[mi][nj][1];
      part[n * kPS + m + 8] = acc[mi][nj][2];
      part[(n + 1) * kPS + m + 8] = acc[mi][nj][3];
    }
  }

  // The tile's scales and biases beside the sums.
  float* sc = reinterpret_cast<float*>(part + NT * kPS);
  float* bi = sc + NT;
  if (tid < NT) {
    const bool in = n0 + tid < g.cout && g.out_kind != 0;
    sc[tid] = in ? __ldg(scale + n0 + tid) : 0.f;
    bi[tid] = in && bias != nullptr ? __ldg(bias + n0 + tid) : 0.f;
  }

  // Split K: the gridDim.z blocks of a tile are one cluster; each sums a
  // slice of the tile's channels over the cluster's blocks (distributed
  // shared memory; int32, so exact in any order, read in one unrolled
  // pass) and stores it.
  const int splits = gridDim.z;
  int lo = 0, hi = NT;
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1) {
    cluster.sync();  // every block's partial sums are in place
    const int per = (NT + splits - 1) / splits;
    lo = min(NT, static_cast<int>(cluster.block_rank()) * per);
    hi = min(NT, lo + per);
  } else {
    __syncthreads();
  }
  // A thread keeps one pixel of the tile (consecutive threads, consecutive
  // pixels of a row) and walks its channels.
  const int m = tid % kM;
  const int r = m >> g.tw_shift, c = m - (r << g.tw_shift);
  const int oy = oy0 + r, ox = ox0 + c;
  const int64_t plane = static_cast<int64_t>(g.ho) * g.wo;
  if (m < g.th * g.tw && oy < g.ho && ox < g.wo) {
    const int64_t base = static_cast<int64_t>(b) * g.cout * plane +
                         static_cast<int64_t>(oy) * g.wo + ox;
    const int n_hi = min(hi, g.cout - n0);
    for (int n = lo + tid / kM; n < n_hi; n += kThreads / kM) {
      int v = part[n * kPS + m];
      if (splits > 1) {
        v = 0;
#pragma unroll
        for (int sp = 0; sp < kMaxSplits; ++sp) {
          if (sp < splits) v += cluster.map_shared_rank(part, sp)[n * kPS + m];
        }
      }
      const int64_t idx = base + (n0 + n) * plane;
      if (g.out_kind == 0) {
        static_cast<int32_t*>(out)[idx] = v;
      } else if (g.out_kind == 1) {
        float f = __fmul_rn(__int2float_rn(v), sc[n]);
        if (bias != nullptr) f = __fadd_rn(f, bi[n]);
        static_cast<float*>(out)[idx] = f;
      } else {
        float f = round_bf16(__int2float_rn(v));
        f = round_bf16(__fmul_rn(f, sc[n]));
        if (bias != nullptr) f = round_bf16(__fadd_rn(f, bi[n]));
        static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(f);
      }
    }
  }
  if (splits > 1) cluster.sync();  // no block reads another's sums after this
}

struct Plan {
  Geom g;
  int nt;
  int splits;
  int64_t tiles;  // output tiles of one image
  size_t smem;
};

size_t smem_bytes(const Geom& g, int nt) {
  const size_t pipeline = 2 * (static_cast<size_t>(g.xbytes) +
                               static_cast<size_t>(g.kh) * g.kw * nt * kRow) +
                          kMaxHalo * sizeof(int);  // then the halo's offsets
  const size_t sums = static_cast<size_t>(nt) * (kPS * sizeof(int) + 2 * sizeof(float));
  return pipeline > sums ? pipeline : sums;
}

// The tile: tw the least power of two from 4 that covers Wo, at most 32;
// th = 128 / tw rows (at most Ho), fewer where the halo would pass
// kMaxHalo positions. NT by Cout (16, 32, 64), halved while the buffers
// pass 227 KB. Then the split of Cin: the fewest power-of-two splits (at
// most the chunks and kMaxSplits) that give every SM a block.
int make_plan(Plan& p, int sms, int batch, int height, int width, int cin, int cp,
              int cout, int kh, int kw, int pad_t, int pad_l, int dil, int ho, int wo) {
  Geom& g = p.g;
  g = Geom{};
  g.batch = batch;
  g.height = height;
  g.width = width;
  g.cin = cin;
  g.cp = cp;
  g.cout = cout;
  g.kh = kh;
  g.kw = kw;
  g.pad_t = pad_t;
  g.pad_l = pad_l;
  g.dil = dil;
  g.ho = ho;
  g.wo = wo;
  int tw = 4;
  while (tw < 32 && tw < wo) tw *= 2;
  int th = kM / tw < ho ? kM / tw : ho;
  while (th > 1 && (th + kh - 1) * (tw + kw - 1) > kMaxHalo) --th;
  while (tw > 1 && (th + kh - 1) * (tw + kw - 1) > kMaxHalo) tw /= 2;
  if ((th + kh - 1) * (tw + kw - 1) > kMaxHalo) return static_cast<int>(cudaErrorInvalidValue);
  g.th = th;
  g.tw = tw;
  while ((1 << g.tw_shift) < tw) ++g.tw_shift;
  g.hh = th + kh - 1;
  g.hw = tw + kw - 1;
  g.xbytes = (g.hh * g.hw * kRow + 127) / 128 * 128;
  g.tiles_w = (wo + tw - 1) / tw;
  p.tiles = static_cast<int64_t>(g.tiles_w) * ((ho + th - 1) / th);
  p.nt = cout <= 16 ? 16 : (cout <= 32 ? 32 : 64);
  while (p.nt > 16 && smem_bytes(g, p.nt) > kMaxSmem) p.nt /= 2;
  p.smem = smem_bytes(g, p.nt);
  if (p.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  g.ntn = (cout + p.nt - 1) / p.nt;
  g.nchunks = (cin + kKC - 1) / kKC;
  const int64_t blocks = p.tiles * batch * g.ntn;
  int splits = 1;
  while (blocks * splits < sms && 2 * splits <= (g.nchunks < kMaxSplits ? g.nchunks : kMaxSplits)) {
    splits *= 2;
  }
  g.chunks_per_split = (g.nchunks + splits - 1) / splits;
  p.splits = (g.nchunks + g.chunks_per_split - 1) / g.chunks_per_split;
  if (p.tiles > INT32_MAX || static_cast<int64_t>(batch) * g.ntn > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <int NT, int IN>
cudaError_t launch(const Plan& p, const void* x, const float* rscale, const int8_t* w,
                   const float* scale, const float* bias, void* out, cudaStream_t stream) {
  auto kernel = conv_i8_mma_kernel<NT, IN>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(p.tiles),
                        static_cast<unsigned>(p.g.batch * p.g.ntn),
                        static_cast<unsigned>(p.splits));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = p.smem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = p.splits;  // a tile's splits, one cluster
  config.attrs = cluster;
  config.numAttrs = p.splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&config, kernel, x, rscale, w, scale, bias, out, p.g);
}

template <int IN>
cudaError_t launch_nt(const Plan& p, const void* x, const float* rscale, const int8_t* w,
                      const float* scale, const float* bias, void* out, cudaStream_t stream) {
  switch (p.nt) {
    case 16:
      return launch<16, IN>(p, x, rscale, w, scale, bias, out, stream);
    case 32:
      return launch<32, IN>(p, x, rscale, w, scale, bias, out, stream);
    default:
      return launch<64, IN>(p, x, rscale, w, scale, bias, out, stream);
  }
}

// The card's SM count, asked once a device.
int sm_count(int device) {
  static int cached[64] = {0};
  const bool keep = device >= 0 && device < 64;
  if (keep && cached[device] > 0) return cached[device];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return -1;
  if (keep) cached[device] = n;
  return n;
}

int check_args(int in_kind, int out_kind, int batch, int height, int width, int cin, int cp,
               int cout, int kh, int kw, int pad_t, int pad_l, int dil, int ho, int wo) {
  const bool bad = batch < 1 || height < 1 || width < 1 || cin < 1 || cp < 1 || cp % 4 ||
                   cout < 1 || kh < 1 || kw < 1 || ho < 1 || wo < 1 || pad_t < 0 ||
                   pad_l < 0 || (dil != 1 && dil != 2) || out_kind < 0 || out_kind > 2 ||
                   in_kind < 0 || in_kind > 2 || (in_kind == kInt8 && cin != cp) ||
                   (in_kind != kInt8 && (cin > cp || cp - cin >= 4));
  return bad ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

}  // namespace

// in_kind 0: x int8 NHWC [B, H, W, Cp] (cin = cp), contiguous; 1, 2: x
// bfloat16 or float32 [B, Cin, H, W] with element strides sb, sc, sh, sw
// (NCHW contiguous reads coalesced; Cp = Cin rounded up to 4) and rscale a
// float32 [1] on the card. w int8 [Cout, KH, KW, Cp]; out [B, Cout, Ho, Wo]
// (int32, float32 or bfloat16 by out_kind 0, 1, 2); scale [Cout] float32
// (read for out_kind 1 and 2); bias [Cout] float32 or null. All but a
// float x contiguous, x and w 4-byte aligned. Launches on `stream` and
// returns the cudaError_t of the launch (0 on success).
extern "C" int conv_i8(const void* x, int in_kind, const void* rscale, const void* w,
                       const void* scale, const void* bias, void* out, int out_kind, int device,
                       int batch, int height, int width, int cin, int cp, int cout,
                       int kh, int kw, int pad_t, int pad_l, int dil, int ho, int wo,
                       int64_t sb, int64_t sc, int64_t sh, int64_t sw, void* stream) {
  int err = check_args(in_kind, out_kind, batch, height, width, cin, cp, cout, kh, kw, pad_t,
                       pad_l, dil, ho, wo);
  if (err != 0) return err;
  if (in_kind != kInt8 && rscale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int sms = sm_count(device);
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  Plan p;
  err = make_plan(p, sms, batch, height, width, cin, cp, cout, kh, kw, pad_t, pad_l,
                  dil, ho, wo);
  if (err != 0) return err;
  // The halo's offsets within an image are int32.
  if (in_kind == kInt8 ? static_cast<int64_t>(height) * width * cin > INT32_MAX
                       : (sb < 0 || sc < 0 || sh < 0 || sw < 0 ||
                          (height - 1) * sh + (width - 1) * sw > INT32_MAX)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.g.out_kind = out_kind;
  p.g.sb = sb;
  p.g.sc = sc;
  p.g.sh = sh;
  p.g.sw = sw;
  p.g.vec_x = in_kind == kInt8 && cin % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.g.vec_w = cp % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* rp = static_cast<const float*>(rscale);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  if (in_kind == kInt8) {
    e = launch_nt<kInt8>(p, x, rp, wp, sp, bp, out, s);
  } else if (in_kind == kBf16) {
    e = launch_nt<kBf16>(p, x, rp, wp, sp, bp, out, s);
  } else {
    e = launch_nt<kFp32>(p, x, rp, wp, sp, bp, out, s);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
