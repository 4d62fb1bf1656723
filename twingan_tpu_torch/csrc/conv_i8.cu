// int8 x int8 -> int32 convolution with the dequantize epilogue fused
// (kernel Q1), for Hopper (sm_90a).
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
// Layouts: x is int8 NHWC [B, H, W, Cp] and w int8 [Cout, KH, KW, Cp],
// with Cp a multiple of 4 (the caller pads channels with zeros), both read
// as 32-bit words of 4 channels; the output is NCHW [B, Cout, Ho, Wo].
// Products go through __dp4a into int32 accumulators: exact.
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
// Layout of the work: a block owns 128 output pixels (flattened over B,
// Ho, Wo) and 16 output channels; its 256 threads each hold 2 pixels x 4
// channels of int32 accumulators. The reduction axis k = (ky KW + kx) Cw +
// cw (Cw = Cp / 4 words) is walked 16 words at a time: x's words for the
// block's pixels at those k (zero outside the image and between the
// dilated rows) and w's words are staged in shared memory, x transposed
// (k-major, rows padded to 129 words: conflict-free), then every thread
// runs 16 x 8 dp4a. A simple CUDA-core kernel; the tensor cores' int8
// mma is a later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPixels = 128;  // output pixels per block
constexpr int kChannels = 16;  // output channels per block
constexpr int kWords = 16;  // 4-channel words per k step
constexpr int kThreads = 256;
constexpr int kLoadsPerThread = kPixels * kWords / kThreads;  // 8

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int kOut>
__global__ void __launch_bounds__(kThreads)
    conv_i8_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   void* __restrict__ out, int batch, int height, int width, int cw,
                   int cout, int kh, int kw, int pad_t, int pad_l, int dil, int ho,
                   int wo) {
  __shared__ int32_t xs[kWords][kPixels + 1];
  __shared__ __align__(16) int32_t ws[kWords][kChannels];

  const int tid = threadIdx.x;
  const int tx = tid & 63;  // pixels tx and tx + 64
  const int ty = tid >> 6;  // channels 4 ty .. 4 ty + 3
  const int64_t plane = static_cast<int64_t>(ho) * wo;
  const int64_t npix = plane * batch;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPixels;
  const int c0 = blockIdx.y * kChannels;
  const int k_total = kh * kw * cw;

  // The loader: this thread stages word (tid % 16) of the k step for
  // pixels tid / 16 + 16 r. Their coordinates are fixed for the block.
  const int lk = tid & (kWords - 1);
  int lb[kLoadsPerThread], ly[kLoadsPerThread], lx[kLoadsPerThread];
#pragma unroll
  for (int r = 0; r < kLoadsPerThread; ++r) {
    const int64_t p = p0 + (tid >> 4) + 16 * r;
    if (p < npix) {
      lb[r] = static_cast<int>(p / plane);
      const int rem = static_cast<int>(p - static_cast<int64_t>(lb[r]) * plane);
      ly[r] = rem / wo;
      lx[r] = rem - ly[r] * wo;
    } else {
      lb[r] = -1;
      ly[r] = lx[r] = 0;
    }
  }
  const int dil_h = (height - 1) * dil;  // last row of the dilated image
  const int dil_w = (width - 1) * dil;

  int acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k_total; k0 += kWords) {
    const int k = k0 + lk;
    const bool k_in = k < k_total;
    int tap = 0, word = 0, ky = 0, kx = 0;
    if (k_in) {
      tap = k / cw;
      word = k - tap * cw;
      ky = tap / kw;
      kx = tap - ky * kw;
    }
#pragma unroll
    for (int r = 0; r < kLoadsPerThread; ++r) {
      int32_t v = 0;
      if (k_in && lb[r] >= 0) {
        const int iy = ly[r] + ky - pad_t;
        const int ix = lx[r] + kx - pad_l;
        if (iy >= 0 && ix >= 0 && iy <= dil_h && ix <= dil_w && iy % dil == 0 &&
            ix % dil == 0) {
          const int64_t idx =
              ((static_cast<int64_t>(lb[r]) * height + iy / dil) * width + ix / dil) * cw +
              word;
          v = __ldg(x + idx);
        }
      }
      xs[lk][(tid >> 4) + 16 * r] = v;
    }
    {
      const int c = c0 + (tid >> 4);
      ws[lk][tid >> 4] =
          (k_in && c < cout) ? __ldg(w + static_cast<int64_t>(c) * k_total + k) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWords; ++kk) {
      const int a0 = xs[kk][tx];
      const int a1 = xs[kk][tx + 64];
      const int4 b = *reinterpret_cast<const int4*>(&ws[kk][ty * 4]);
      acc[0][0] = __dp4a(a0, b.x, acc[0][0]);
      acc[0][1] = __dp4a(a0, b.y, acc[0][1]);
      acc[0][2] = __dp4a(a0, b.z, acc[0][2]);
      acc[0][3] = __dp4a(a0, b.w, acc[0][3]);
      acc[1][0] = __dp4a(a1, b.x, acc[1][0]);
      acc[1][1] = __dp4a(a1, b.y, acc[1][1]);
      acc[1][2] = __dp4a(a1, b.z, acc[1][2]);
      acc[1][3] = __dp4a(a1, b.w, acc[1][3]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t p = p0 + tx + 64 * i;
    if (p >= npix) continue;
    const int64_t b = p / plane;
    const int64_t rem = p - b * plane;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + ty * 4 + j;
      if (c >= cout) continue;
      const int64_t idx = (b * cout + c) * plane + rem;
      if (kOut == 0) {
        static_cast<int32_t*>(out)[idx] = acc[i][j];
      } else if (kOut == 1) {
        float v = __fmul_rn(__int2float_rn(acc[i][j]), scale[c]);
        if (bias != nullptr) v = __fadd_rn(v, bias[c]);
        static_cast<float*>(out)[idx] = v;
      } else {
        float v = round_bf16(__int2float_rn(acc[i][j]));
        v = round_bf16(__fmul_rn(v, scale[c]));
        if (bias != nullptr) v = round_bf16(__fadd_rn(v, bias[c]));
        static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
      }
    }
  }
}

}  // namespace

// x [B, H, W, Cw words], w [Cout, KH, KW, Cw words], out [B, Cout, Ho, Wo]
// (int32, float32 or bfloat16 by out_kind 0, 1, 2), all contiguous and
// 4-byte aligned. scale [Cout] float32 (read for out_kind 1 and 2); bias
// [Cout] float32 or null. Launches on `stream` and returns the
// cudaError_t of cudaGetLastError() after the launch (0 on success).
extern "C" int conv_i8(const void* x, const void* w, const void* scale, const void* bias,
                       void* out, int out_kind, int device, int batch, int height, int width,
                       int cw, int cout, int kh, int kw, int pad_t, int pad_l, int dil, int ho,
                       int wo, void* stream) {
  const int64_t npix = static_cast<int64_t>(batch) * ho * wo;
  const int64_t blocks = (npix + kPixels - 1) / kPixels;
  if (batch < 1 || height < 1 || width < 1 || cw < 1 || cout < 1 || kh < 1 || kw < 1 ||
      ho < 1 || wo < 1 || pad_t < 0 || pad_l < 0 || (dil != 1 && dil != 2) ||
      out_kind < 0 || out_kind > 2 || blocks > INT32_MAX ||
      (cout + kChannels - 1) / kChannels > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks), (cout + kChannels - 1) / kChannels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* xp = static_cast<const int32_t*>(x);
  const int32_t* wp = static_cast<const int32_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  if (out_kind == 0) {
    conv_i8_kernel<0><<<grid, kThreads, 0, s>>>(xp, wp, sp, bp, out, batch, height, width, cw,
                                                cout, kh, kw, pad_t, pad_l, dil, ho, wo);
  } else if (out_kind == 1) {
    conv_i8_kernel<1><<<grid, kThreads, 0, s>>>(xp, wp, sp, bp, out, batch, height, width, cw,
                                                cout, kh, kw, pad_t, pad_l, dil, ho, wo);
  } else {
    conv_i8_kernel<2><<<grid, kThreads, 0, s>>>(xp, wp, sp, bp, out, batch, height, width, cw,
                                                cout, kh, kw, pad_t, pad_l, dil, ho, wo);
  }
  return static_cast<int>(cudaGetLastError());
}
