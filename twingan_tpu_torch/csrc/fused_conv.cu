// Fused 3x3 SAME conv + bias + leaky ReLU + pixel norm for Hopper (sm_90a),
// CUDA cores, fp32 math.
//
// Replaces the Pallas TPU kernel `_fused_kernel`, launched by `pallas_block`
// in tools/exp_fused_conv.py. Same function, per pixel (b, h, w):
//   v[c] = bias[c] + sum_{dy,dx,ci} x[b,ci,h+dy-1,w+dx-1] * w9[dy*3+dx, ci, c]
//   v[c] = max(0.2 v[c], v[c])
//   y[b,c,h,w] = v[c] * rsqrt(mean_c(v[c]^2) + 1e-6)
// x outside the image is zero (SAME padding). x and y are contiguous NCHW,
// [B, Cin, H, W] and [B, Cout, H, W], fp32 or bf16 (y in x's type); w9 is
// [9, Cin, Cout] fp32 with the caller's equalized-lr scale folded in, bias
// [Cout] fp32. Every product and sum is fp32, and y is rounded once, on the
// store. Any H, W >= 1 and Cin >= 1; Cout 1..1024, every width of the
// PGGAN generator (1024 // 2^stage channels at most).
//
// What bounds it on the H100: arithmetic. A pixel takes 2 * 9 * Cin * Cout
// FLOPs against 2 * (Cin + Cout) bytes of bf16 in and out: 72 FLOPs per
// byte at 16 -> 16 channels and more at every wider layer of the
// generator, above the ~20 FLOPs per byte at which fp32 CUDA-core math
// (67 TFLOP/s) and memory (3.35 TB/s) balance. So x must be read from
// device memory about once, and the time goes to the multiply-adds and the
// loads that feed them.
//
// Design. The TPU kernel gives each program an 8-row tile of one image with
// its halo rows duplicated in device memory (BlockSpec windows cannot
// overlap) and holds the tile's [8 W, Cout] accumulator in VMEM. Here:
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
// Tensor cores (implicit GEMM over [pixels, 9 Cin] x [9 Cin, Cout] in bf16
// with fp32 accumulation), shared-memory tiles of x and weights, and TMA
// are the next steps for speed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr int kPixels = 32;            // pixels per block (threadIdx.x)
constexpr int kChannelsPerThread = 8;  // output channels of one group
constexpr int kMaxWarps = 32;          // groups side by side (threadIdx.y)
constexpr int kMaxGroupsPerThread = 4;
constexpr int kMaxCout = kChannelsPerThread * kMaxWarps * kMaxGroupsPerThread;
constexpr float kSlope = 0.2f;
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// kFull: Cout is a multiple of kChannelsPerThread, so every group that
// exists has all 8 channels and their weights are 16-byte aligned (float4
// loads). kGroups: groups of 8 channels per thread, threadIdx.y + k *
// blockDim.y for k < kGroups; a group past Cout is skipped, uniformly over
// its warp.
template <typename T, bool kFull, int kGroups>
__global__ void __launch_bounds__(kPixels * kMaxWarps)
fused_conv_kernel(const T* __restrict__ x, const float* __restrict__ w9,
                  const float* __restrict__ bias, T* __restrict__ y, int cin, int cout,
                  int height, int width) {
  __shared__ float partial[kMaxWarps][kPixels];
  const int hw = height * width;
  const int p = blockIdx.x * kPixels + threadIdx.x;
  const bool valid = p < hw;
  const int h = valid ? p / width : 0;
  const int w = valid ? p - h * width : 0;
  int co0[kGroups], n_ch[kGroups];
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    co0[k] = (threadIdx.y + k * blockDim.y) * kChannelsPerThread;
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

  const T* plane = x + static_cast<int64_t>(blockIdx.y) * cin * hw;
  for (int ci = 0; ci < cin; ++ci, plane += hw) {
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const float v = ((inside >> t) & 1u) ? to_float(plane[offset[t]]) : 0.f;
      const float* wtap = w9 + (static_cast<int64_t>(t) * cin + ci) * cout;
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        if (k > 0 && n_ch[k] == 0) continue;  // group threadIdx.y always exists
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
  const float scale = rsqrtf(total / static_cast<float>(cout) + kEps);
  if (!valid) return;
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    T* out = y + (static_cast<int64_t>(blockIdx.y) * cout + co0[k]) * hw + p;
#pragma unroll
    for (int j = 0; j < kChannelsPerThread; ++j) {
      if (j < n_ch[k]) out[static_cast<int64_t>(j) * hw] = from_float<T>(acc[k][j] * scale);
    }
  }
}

template <typename T, int kGroups>
void launch_groups(dim3 grid, dim3 block, bool full, const T* x, const float* w9,
                   const float* bias, T* y, int cin, int cout, int height, int width,
                   cudaStream_t stream) {
  if (full) {
    fused_conv_kernel<T, true, kGroups><<<grid, block, 0, stream>>>(x, w9, bias, y, cin, cout,
                                                                    height, width);
  } else {
    fused_conv_kernel<T, false, kGroups><<<grid, block, 0, stream>>>(x, w9, bias, y, cin, cout,
                                                                     height, width);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w9, const void* bias, void* y, int batch,
                   int cin, int cout, int height, int width, cudaStream_t stream) {
  const int hw = height * width;
  const int groups = (cout + kChannelsPerThread - 1) / kChannelsPerThread;
  const int warps = min(groups, kMaxWarps);
  const int per_thread = (groups + warps - 1) / warps;  // 1..4
  const dim3 block(kPixels, warps);
  const dim3 grid((hw + kPixels - 1) / kPixels, batch);
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w9);
  const float* bt = static_cast<const float*>(bias);
  T* yt = static_cast<T*>(y);
  const bool full =
      cout % kChannelsPerThread == 0 && reinterpret_cast<uintptr_t>(w9) % 16 == 0;
  if (per_thread == 1) {
    launch_groups<T, 1>(grid, block, full, xt, wt, bt, yt, cin, cout, height, width, stream);
  } else if (per_thread == 2) {
    launch_groups<T, 2>(grid, block, full, xt, wt, bt, yt, cin, cout, height, width, stream);
  } else {
    launch_groups<T, 4>(grid, block, full, xt, wt, bt, yt, cin, cout, height, width, stream);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y). x, w9, bias and y are
// contiguous (see the top of the file). Launches on `stream` and returns the
// cudaError_t of cudaGetLastError() after the launch (0 on success).
extern "C" int fused_conv3x3_leaky_pixel_norm(const void* x, const void* w9, const void* bias,
                                              void* y, int dtype, int device, int batch,
                                              int cin, int cout, int height, int width,
                                              void* stream) {
  if (batch < 1 || batch > 65535 || cin < 1 || cout < 1 || cout > kMaxCout || height < 1 ||
      width < 1 || static_cast<int64_t>(height) * width > INT_MAX - kPixels ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch<float>(x, w9, bias, y, batch, cin, cout, height, width, s);
  } else {
    err = launch<__nv_bfloat16>(x, w9, bias, y, batch, cin, cout, height, width, s);
  }
  return static_cast<int>(err);
}
