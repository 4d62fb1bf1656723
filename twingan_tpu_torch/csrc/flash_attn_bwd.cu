// SAGAN flash-attention backward for Hopper (sm_90a), CUDA cores, fp32 math.
//
// Replaces the two Pallas TPU kernels of the blockwise backward in
// twingan_tpu/ops/attention.py, launched by `_flash_backward`:
//  - `flash_attn_dq` replaces `_flash_dq_kernel`:
//      df[b,i] = sum_j ds[b,i,j] g[b,j]
//  - `flash_attn_dkv` replaces `_flash_dkv_kernel`:
//      dg[b,j] = sum_i ds[b,i,j] f[b,i],   dh[b,j] = sum_i p[b,i,j] do[b,i]
// with, recomputed tile by tile from the forward's per-row logsumexp,
//      p = exp(f g^T - lse),  dp = do h^T,  ds = p * (dp - delta),
// and delta[b,i] = do[b,i] . o[b,i], which the caller computes (a plain
// fp32 row reduction, as the JAX package does outside its kernels).
// f, g, df, dg: [B, N, cbar]; h, do, dh: [B, N, C], fp32 or bf16; lse,
// delta: [B, N] fp32. cbar may be 1..64 and C 1..256; N is any size (the
// last tile of either side is masked). Outputs are in the input dtype.
//
// What bounds them on the H100: arithmetic, as in the forward. dq does
// 2*B*N^2*(2*cbar + C) and dkv 2*B*N^2*(2*cbar + 2*C) floating-point
// operations plus B*N^2 exponentials each, on O(B*N*(cbar + C)) bytes, so
// the N^2 matrices p, dp and ds must never reach device memory.
//
// Design. The TPU kernels carry their fp32 accumulators across a sequential
// grid axis in VMEM. CUDA blocks run in no order, so that axis becomes a
// loop inside one block, and each output row is owned by one block: no
// atomics, so the results are deterministic, as the two TPU kernels' are.
//  - dq: a block owns `rows` query rows of one batch element and loops over
//    key tiles (g and h staged in shared memory as fp32);
//  - dkv: a block owns `rows` key rows and loops over query tiles (f, do,
//    lse and delta staged in shared memory).
// blockDim = (rows, groups): threadIdx.x picks the owned row, threadIdx.y a
// slice of 32 of the C columns (zero padded), as in flash_attn_fwd.cu. A
// thread keeps its row's do (dq) or h (dkv) slice in registers, computes a
// partial dp over its 32 columns for each of the tile's 16 rows, and the
// partials of the row's `groups` threads are summed through shared memory.
// Each thread then recomputes s and p itself (cbar is small), and the
// cbar-wide accumulator (df or dg) is split across the row's threads by
// column (k % groups == ty). Threads of one warp share threadIdx.y,
// so every read of a staged tile is a shared-memory broadcast.
// This is the simple CUDA-core version; tensor cores (wgmma) and TMA
// staging are the next step for speed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;           // rows of the other side per shared-memory tile
constexpr int kColsPerThread = 32;  // C columns each thread handles
constexpr int kMaxCbar = 64;
constexpr int kMaxC = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  // Element strides: batch and row of f, g, h, do; batch of lse and delta;
  // batch and row of the outputs (df, or dg then dh).
  int64_t f_sb, f_sn, g_sb, g_sn, h_sb, h_sn, do_sb, do_sn, row_sb;
  int64_t o0_sb, o0_sn, o1_sb, o1_sn;
};

// Stage the kTile rows starting at `r0` of a [N, width] row-major matrix
// (row stride `sn`) into a zero-padded [kTile][padded] fp32 tile.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int n, int width,
                                      int padded, int64_t sn, int tid, int nthreads) {
  for (int i = tid; i < kTile * padded; i += nthreads) {
    const int r = r0 + i / padded;
    const int k = i % padded;
    dst[i] = (r < n && k < width) ? to_float(src[r * sn + k]) : 0.f;
  }
}

template <typename T, int CB>
__global__ void __launch_bounds__(256) flash_attn_dq_kernel(
    const T* __restrict__ f, const T* __restrict__ g, const T* __restrict__ h,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ df, int n, int cbar, int c,
    Strides st) {
  extern __shared__ float smem[];
  const int rows = blockDim.x;
  const int groups = blockDim.y;
  const int hc = groups * kColsPerThread;     // padded value width
  float* gs = smem;                            // [kTile][CB]
  float* hs = gs + kTile * CB;                 // [kTile][hc]
  float* red = hs + kTile * hc;                // [groups][kTile][rows]

  const int b = blockIdx.y;
  const int row = blockIdx.x * rows + threadIdx.x;
  const int ty = threadIdx.y;
  const int col0 = ty * kColsPerThread;
  const int tid = ty * rows + threadIdx.x;
  const int nthreads = rows * groups;
  const bool valid = row < n;
  f += b * st.f_sb;
  g += b * st.g_sb;
  h += b * st.h_sb;
  dout += b * st.do_sb;

  float fr[CB];
#pragma unroll
  for (int k = 0; k < CB; ++k) fr[k] = (valid && k < cbar) ? to_float(f[row * st.f_sn + k]) : 0.f;
  float dor[kColsPerThread];
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    dor[j] = (valid && col0 + j < c) ? to_float(dout[row * st.do_sn + col0 + j]) : 0.f;
  }
  const float lse_i = valid ? lse[b * st.row_sb + row] : 0.f;
  const float delta_i = valid ? delta[b * st.row_sb + row] : 0.f;
  float acc[CB];
#pragma unroll
  for (int k = 0; k < CB; ++k) acc[k] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile and partials
    stage(gs, g, k0, n, cbar, CB, st.g_sn, tid, nthreads);
    stage(hs, h, k0, n, c, hc, st.h_sn, tid, nthreads);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) {
      const float* hj = hs + jj * hc + col0;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) part = fmaf(dor[j], hj[j], part);
      red[(ty * kTile + jj) * rows + threadIdx.x] = part;
    }
    __syncthreads();
    const int kmax = min(kTile, n - k0);  // keys of this tile inside N
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      float dp = 0.f;
      for (int y = 0; y < groups; ++y) dp += red[(y * kTile + jj) * rows + threadIdx.x];
      const float* gj = gs + jj * CB;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < CB; ++k) s = fmaf(fr[k], gj[k], s);
      const float p = jj < kmax ? __expf(s - lse_i) : 0.f;
      const float ds = p * (dp - delta_i);
#pragma unroll
      for (int k = 0; k < CB; ++k) {
        if (k % groups == ty) acc[k] = fmaf(ds, gj[k], acc[k]);
      }
    }
  }

  if (valid) {
    T* drow = df + b * st.o0_sb + row * st.o0_sn;
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      if (k < cbar && k % groups == ty) drow[k] = from_float<T>(acc[k]);
    }
  }
}

template <typename T, int CB>
__global__ void __launch_bounds__(256) flash_attn_dkv_kernel(
    const T* __restrict__ f, const T* __restrict__ g, const T* __restrict__ h,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dg, T* __restrict__ dh, int n,
    int cbar, int c, Strides st) {
  extern __shared__ float smem[];
  const int rows = blockDim.x;
  const int groups = blockDim.y;
  const int hc = groups * kColsPerThread;
  float* fs = smem;                            // [kTile][CB]
  float* dos = fs + kTile * CB;                // [kTile][hc]
  float* ls = dos + kTile * hc;                // [kTile] lse
  float* dls = ls + kTile;                     // [kTile] delta
  float* red = dls + kTile;                    // [groups][kTile][rows]

  const int b = blockIdx.y;
  const int row = blockIdx.x * rows + threadIdx.x;  // key row
  const int ty = threadIdx.y;
  const int col0 = ty * kColsPerThread;
  const int tid = ty * rows + threadIdx.x;
  const int nthreads = rows * groups;
  const bool valid = row < n;
  f += b * st.f_sb;
  g += b * st.g_sb;
  h += b * st.h_sb;
  dout += b * st.do_sb;
  lse += b * st.row_sb;
  delta += b * st.row_sb;

  float gr[CB];
#pragma unroll
  for (int k = 0; k < CB; ++k) gr[k] = (valid && k < cbar) ? to_float(g[row * st.g_sn + k]) : 0.f;
  float hr[kColsPerThread];
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    hr[j] = (valid && col0 + j < c) ? to_float(h[row * st.h_sn + col0 + j]) : 0.f;
  }
  float dg_acc[CB];
#pragma unroll
  for (int k = 0; k < CB; ++k) dg_acc[k] = 0.f;
  float dh_acc[kColsPerThread];
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) dh_acc[j] = 0.f;

  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();
    stage(fs, f, q0, n, cbar, CB, st.f_sn, tid, nthreads);
    stage(dos, dout, q0, n, c, hc, st.do_sn, tid, nthreads);
    if (tid < kTile) {
      const int q = q0 + tid;
      ls[tid] = q < n ? lse[q] : 0.f;
      dls[tid] = q < n ? delta[q] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < kTile; ++ii) {
      const float* doi = dos + ii * hc + col0;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) part = fmaf(doi[j], hr[j], part);
      red[(ty * kTile + ii) * rows + threadIdx.x] = part;
    }
    __syncthreads();
    const int qmax = min(kTile, n - q0);  // queries of this tile inside N
#pragma unroll 4
    for (int ii = 0; ii < kTile; ++ii) {
      float dp = 0.f;
      for (int y = 0; y < groups; ++y) dp += red[(y * kTile + ii) * rows + threadIdx.x];
      const float* fi = fs + ii * CB;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < CB; ++k) s = fmaf(gr[k], fi[k], s);
      const float p = ii < qmax ? __expf(s - ls[ii]) : 0.f;
      const float* doi = dos + ii * hc + col0;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) dh_acc[j] = fmaf(p, doi[j], dh_acc[j]);
      const float ds = p * (dp - dls[ii]);
#pragma unroll
      for (int k = 0; k < CB; ++k) {
        if (k % groups == ty) dg_acc[k] = fmaf(ds, fi[k], dg_acc[k]);
      }
    }
  }

  if (valid) {
    T* grow = dg + b * st.o0_sb + row * st.o0_sn;
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      if (k < cbar && k % groups == ty) grow[k] = from_float<T>(dg_acc[k]);
    }
    T* hrow = dh + b * st.o1_sb + row * st.o1_sn;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      if (col0 + j < c) hrow[col0 + j] = from_float<T>(dh_acc[j]);
    }
  }
}

struct Launch {
  dim3 grid, block;
  size_t smem;
};

// About 128 threads a block, never fewer than one warp of rows (as the
// forward); the shared memory stays under the 48 KB of a default launch:
// at most 4 * (16*64 + 16*256 + 32 + 8*16*32) bytes = 36.9 KB.
template <int CB>
Launch config(int batch, int n, int c) {
  const int groups = (c + kColsPerThread - 1) / kColsPerThread;
  const int rows = groups >= 4 ? 32 : 128 / groups / 32 * 32;
  Launch l;
  l.block = dim3(rows, groups);
  l.grid = dim3((n + rows - 1) / rows, batch);
  l.smem = sizeof(float) *
           (kTile * (CB + groups * kColsPerThread) + 2 * kTile + groups * kTile * rows);
  return l;
}

template <typename T, int CB>
cudaError_t launch_dq(const void* const* in, void* df, int batch, int n, int cbar, int c,
                      const Strides& st, cudaStream_t stream) {
  const Launch l = config<CB>(batch, n, c);
  flash_attn_dq_kernel<T, CB><<<l.grid, l.block, l.smem, stream>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
      static_cast<const float*>(in[4]), static_cast<const float*>(in[5]),
      static_cast<T*>(df), n, cbar, c, st);
  return cudaGetLastError();
}

template <typename T, int CB>
cudaError_t launch_dkv(const void* const* in, void* dg, void* dh, int batch, int n, int cbar,
                       int c, const Strides& st, cudaStream_t stream) {
  const Launch l = config<CB>(batch, n, c);
  flash_attn_dkv_kernel<T, CB><<<l.grid, l.block, l.smem, stream>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
      static_cast<const float*>(in[4]), static_cast<const float*>(in[5]),
      static_cast<T*>(dg), static_cast<T*>(dh), n, cbar, c, st);
  return cudaGetLastError();
}

// Instantiates `fn<T, CB>` for the cbar bound (8, 16, 32 or 64) and dtype.
#define DISPATCH(dtype, cbar, fn, ...)                                        \
  do {                                                                        \
    if (dtype == 0) {                                                         \
      if (cbar <= 8) return fn<float, 8>(__VA_ARGS__);                        \
      if (cbar <= 16) return fn<float, 16>(__VA_ARGS__);                      \
      if (cbar <= 32) return fn<float, 32>(__VA_ARGS__);                      \
      return fn<float, 64>(__VA_ARGS__);                                      \
    }                                                                         \
    if (cbar <= 8) return fn<__nv_bfloat16, 8>(__VA_ARGS__);                  \
    if (cbar <= 16) return fn<__nv_bfloat16, 16>(__VA_ARGS__);                \
    if (cbar <= 32) return fn<__nv_bfloat16, 32>(__VA_ARGS__);                \
    return fn<__nv_bfloat16, 64>(__VA_ARGS__);                                \
  } while (0)

cudaError_t check(int dtype, int device, int batch, int n, int cbar, int c) {
  if (batch < 1 || n < 1 || cbar < 1 || cbar > kMaxCbar || c < 1 || c > kMaxC ||
      batch > 65535 || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  return cudaSetDevice(device);
}

cudaError_t dq(const void* const* in, void* df, int dtype, int batch, int n, int cbar, int c,
               const Strides& st, cudaStream_t s) {
  DISPATCH(dtype, cbar, launch_dq, in, df, batch, n, cbar, c, st, s);
}

cudaError_t dkv(const void* const* in, void* dg, void* dh, int dtype, int batch, int n,
                int cbar, int c, const Strides& st, cudaStream_t s) {
  DISPATCH(dtype, cbar, launch_dkv, in, dg, dh, batch, n, cbar, c, st, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements: batch and row
// strides of f, g, h, do, the batch stride of lse and delta (which share
// it), then the batch and row strides of each output. The last dimension of
// every tensor must be contiguous. Each function launches one kernel on
// `stream` and returns the cudaError_t of cudaGetLastError() after the
// launch (0 on success).
extern "C" int flash_attn_dq(const void* f, const void* g, const void* h, const void* dout,
                             const void* lse, const void* delta, void* df, int dtype,
                             int device, int batch, int n, int cbar, int c, int64_t f_sb,
                             int64_t f_sn, int64_t g_sb, int64_t g_sn, int64_t h_sb,
                             int64_t h_sn, int64_t do_sb, int64_t do_sn, int64_t row_sb,
                             int64_t df_sb, int64_t df_sn, void* stream) {
  cudaError_t err = check(dtype, device, batch, n, cbar, c);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* in[6] = {f, g, h, dout, lse, delta};
  const Strides st = {f_sb, f_sn, g_sb, g_sn, h_sb, h_sn, do_sb, do_sn, row_sb,
                      df_sb, df_sn, 0, 0};
  return static_cast<int>(
      dq(in, df, dtype, batch, n, cbar, c, st, static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_attn_dkv(const void* f, const void* g, const void* h, const void* dout,
                              const void* lse, const void* delta, void* dg, void* dh,
                              int dtype, int device, int batch, int n, int cbar, int c,
                              int64_t f_sb, int64_t f_sn, int64_t g_sb, int64_t g_sn,
                              int64_t h_sb, int64_t h_sn, int64_t do_sb, int64_t do_sn,
                              int64_t row_sb, int64_t dg_sb, int64_t dg_sn, int64_t dh_sb,
                              int64_t dh_sn, void* stream) {
  cudaError_t err = check(dtype, device, batch, n, cbar, c);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* in[6] = {f, g, h, dout, lse, delta};
  const Strides st = {f_sb, f_sn, g_sb, g_sn, h_sb, h_sn, do_sb, do_sn, row_sb,
                      dg_sb, dg_sn, dh_sb, dh_sn};
  return static_cast<int>(
      dkv(in, dg, dh, dtype, batch, n, cbar, c, st, static_cast<cudaStream_t>(stream)));
}
