// SAGAN flash-attention forward for Hopper (sm_90a), CUDA cores, fp32 math.
//
// Replaces the Pallas TPU kernel `_flash_kernel`, launched by
// `_flash_forward` in twingan_tpu/ops/attention.py. Same function:
//   o[b,i,:] = sum_j softmax_j(f[b,i] . g[b,j]) h[b,j]     (no 1/sqrt(d) scale)
//   lse[b,i] = log sum_j exp(f[b,i] . g[b,j])              (fp32, kept for the
//                                                           blockwise backward)
// f, g: [B, N, cbar] and h, o: [B, N, C], fp32 or bf16; lse: [B, N] fp32.
// cbar may be 1..64 and C 1..256; N is any size (the last key tile and the
// last query tile are masked).
//
// What bounds it on the H100: arithmetic. A call does 2*B*N^2*(cbar + C)
// multiply-adds and B*N^2 exponentials but moves only O(B*N*(cbar + C))
// bytes; at the translation path's shapes (N = 4096, cbar = 8, C = 64) that
// is over 1000 operations per byte, far above the card's ~295 ops/byte
// balance point, so the N^2 score matrix must never reach device memory.
//
// Design. The TPU kernel runs its key-block grid axis in sequence and
// carries the online-softmax state in VMEM scratch between grid steps. CUDA
// blocks run in no order, so here that axis is a loop inside one block:
//  - a block owns `rows` query rows of one batch element (blockIdx.x, .y);
//    each thread holds one row's f vector and a slice of 32 columns of its
//    output accumulator in registers, with its running max m and denominator
//    l (all fp32). Threads of one warp share the same column slice, so every
//    shared-memory read in the inner loops is a broadcast;
//  - key tiles of 32 rows of g and h are staged through shared memory as
//    fp32 (zero padded to the compile-time cbar bound CB and to the column
//    groups), loaded with coalesced reads by the whole block;
//  - scores are taken 16 keys at a time: one max, then the chunk's 16
//    probabilities and weighted values are summed apart, and (l, acc) are
//    rescaled and take the chunk's sums once. Added one key at a time, the
//    positive terms of l are lost against the growing total (0.02 % of lse's
//    denominator at N = 65536, a bias every backward probability inherits);
//    chunk sums cut the additions into (l, acc) 16-fold.
// The simple CUDA-core version is exact fp32 online softmax; tensor cores
// (wgmma) and TMA staging are the next step for speed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockK = 32;         // keys per shared-memory tile
constexpr int kChunk = 16;          // keys per online-softmax update
constexpr int kColsPerThread = 32;  // output columns each thread accumulates
constexpr int kMaxCbar = 64;
constexpr int kMaxC = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// blockDim = (rows, groups): threadIdx.x picks the query row, threadIdx.y the
// 32-column slice of the output. rows is a multiple of 32.
template <typename T, int CB>
__global__ void __launch_bounds__(256) flash_attn_fwd_kernel(
    const T* __restrict__ f, const T* __restrict__ g, const T* __restrict__ h,
    T* __restrict__ o, float* __restrict__ lse, int n, int cbar, int c,
    int64_t f_sb, int64_t f_sn, int64_t g_sb, int64_t g_sn, int64_t h_sb,
    int64_t h_sn, int64_t o_sb, int64_t o_sn, int64_t lse_sb) {
  extern __shared__ float smem[];
  const int rows = blockDim.x;
  const int hc = blockDim.y * kColsPerThread;  // padded value width
  float* gs = smem;                             // [kBlockK][CB]
  float* hs = smem + kBlockK * CB;              // [kBlockK][hc]

  const int b = blockIdx.y;
  const int row = blockIdx.x * rows + threadIdx.x;
  const int col0 = threadIdx.y * kColsPerThread;
  const int tid = threadIdx.y * rows + threadIdx.x;
  const int nthreads = rows * blockDim.y;
  const bool valid = row < n;
  f += b * f_sb;
  g += b * g_sb;
  h += b * h_sb;

  float fr[CB];
#pragma unroll
  for (int k = 0; k < CB; ++k) {
    fr[k] = (valid && k < cbar) ? to_float(f[row * f_sn + k]) : 0.f;
  }
  float acc[kColsPerThread];
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) acc[j] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < kBlockK * CB; i += nthreads) {
      const int key = k0 + i / CB;
      const int k = i % CB;
      gs[i] = (key < n && k < cbar) ? to_float(g[key * g_sn + k]) : 0.f;
    }
    for (int i = tid; i < kBlockK * hc; i += nthreads) {
      const int key = k0 + i / hc;
      const int col = i % hc;
      hs[i] = (key < n && col < c) ? to_float(h[key * h_sn + col]) : 0.f;
    }
    __syncthreads();

    const int kmax = min(kBlockK, n - k0);  // keys of this tile inside N
    for (int j0 = 0; j0 < kmax; j0 += kChunk) {
      float s[kChunk];
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float* gj = gs + (j0 + jj) * CB;
        float dot = 0.f;
#pragma unroll
        for (int k = 0; k < CB; ++k) dot = fmaf(fr[k], gj[k], dot);
        s[jj] = (j0 + jj < kmax) ? dot : -INFINITY;
        mx = fmaxf(mx, s[jj]);
      }
      // The chunk holds at least one key inside N, so m_new is finite and
      // exp(-inf - m_new) = 0 covers both the first chunk and masked keys.
      const float m_new = fmaxf(m, mx);
      const float scale = __expf(m - m_new);
      float lsum = 0.f;
      float part[kColsPerThread];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) part[j] = 0.f;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = __expf(s[jj] - m_new);
        lsum += p;
        const float* hj = hs + (j0 + jj) * hc + col0;
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) part[j] = fmaf(p, hj[j], part[j]);
      }
      l = fmaf(l, scale, lsum);
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[j] = fmaf(acc[j], scale, part[j]);
      m = m_new;
    }
  }

  if (valid) {
    T* orow = o + b * o_sb + row * o_sn;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      if (col0 + j < c) orow[col0 + j] = from_float<T>(acc[j] / l);
    }
    if (threadIdx.y == 0) lse[b * lse_sb + row] = m + logf(l);
  }
}

template <typename T, int CB>
cudaError_t launch(const void* f, const void* g, const void* h, void* o, void* lse,
                   int batch, int n, int cbar, int c, const int64_t* st,
                   cudaStream_t stream) {
  const int groups = (c + kColsPerThread - 1) / kColsPerThread;
  // About 128 threads a block, never fewer than one warp of rows.
  const int rows = groups >= 4 ? 32 : 128 / groups / 32 * 32;
  const dim3 block(rows, groups);
  const dim3 grid((n + rows - 1) / rows, batch);
  const size_t smem = sizeof(float) * kBlockK * (CB + groups * kColsPerThread);
  flash_attn_fwd_kernel<T, CB><<<grid, block, smem, stream>>>(
      static_cast<const T*>(f), static_cast<const T*>(g), static_cast<const T*>(h),
      static_cast<T*>(o), static_cast<float*>(lse), n, cbar, c, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_cbar(const void* f, const void* g, const void* h, void* o,
                          void* lse, int batch, int n, int cbar, int c,
                          const int64_t* st, cudaStream_t stream) {
  if (cbar <= 8) return launch<T, 8>(f, g, h, o, lse, batch, n, cbar, c, st, stream);
  if (cbar <= 16) return launch<T, 16>(f, g, h, o, lse, batch, n, cbar, c, st, stream);
  if (cbar <= 32) return launch<T, 32>(f, g, h, o, lse, batch, n, cbar, c, st, stream);
  return launch<T, 64>(f, g, h, o, lse, batch, n, cbar, c, st, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements: batch and row
// strides of f, g, h, o, then the batch stride of lse; the last dimension of
// f, g, h and o must be contiguous. Launches on `stream` and returns the
// cudaError_t of cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attn_fwd(const void* f, const void* g, const void* h, void* o,
                              void* lse, int dtype, int device, int batch, int n,
                              int cbar, int c, int64_t f_sb, int64_t f_sn, int64_t g_sb,
                              int64_t g_sn, int64_t h_sb, int64_t h_sn, int64_t o_sb,
                              int64_t o_sn, int64_t lse_sb, void* stream) {
  if (batch < 1 || n < 1 || cbar < 1 || cbar > kMaxCbar || c < 1 || c > kMaxC ||
      batch > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t st[9] = {f_sb, f_sn, g_sb, g_sn, h_sb, h_sn, o_sb, o_sn, lse_sb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = dispatch_cbar<float>(f, g, h, o, lse, batch, n, cbar, c, st, s);
  } else {
    err = dispatch_cbar<__nv_bfloat16>(f, g, h, o, lse, batch, n, cbar, c, st, s);
  }
  return static_cast<int>(err);
}
