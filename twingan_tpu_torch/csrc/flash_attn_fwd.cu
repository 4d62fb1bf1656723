// SAGAN flash-attention forward for Hopper (sm_90a), in two variants.
//
// Replaces the Pallas TPU kernel `_flash_kernel`, launched by
// `_flash_forward` in twingan_tpu/ops/attention.py. Same function:
//   o[b,i,:] = sum_j softmax_j(f[b,i] . g[b,j]) h[b,j]     (no 1/sqrt(d) scale)
//   lse[b,i] = log sum_j exp(f[b,i] . g[b,j])              (fp32, kept for the
//                                                           blockwise backward)
// f, g: [B, N, cbar] and h, o: [B, N, C], fp32 or bf16; lse: [B, N] fp32.
// Any cbar, C and N (the last key tile and the last query tile are
// masked); the batch is at most 65535 (the grid's y). The two variants below
// take cbar up to 64, the fp32 one C up to 256; past those the entry point
// launches flash_wide.cuh's kernels, which cut every operand into chunks of
// 64 columns (SAGAN's cbar = C / 8 reaches 64 at C 512, the published
// PGGAN's widest layer).
//
// The entry point picks the variant by type: bf16 runs on the tensor
// cores, fp32 on the CUDA cores (the wrapper's VARIANTS table names them). The
// TPU kernel runs its key-block grid axis in sequence and carries the
// online-softmax state in VMEM scratch between grid steps; CUDA blocks run
// in no order, so in both variants that axis is a loop inside one block.
//
// What bounds it on the H100. A call does 2*B*N^2*(cbar + C) FLOPs of
// products and B*N^2 exponentials on O(B*N*(cbar + C)) bytes, so the N^2
// scores never reach device memory. SAGAN's cbar = C/8 makes the products
// cheap per score: at the serving shape (B 4, N 4096, cbar 8, C 64) they
// take 9.8 us at the bf16 tensor-core peak, while the 67 M exponentials take
// 17 us at the special-function unit's 16 a clock per SM. The exponentials
// bound the bf16 variant; the fp32 variant, on CUDA cores, is bound by its
// FMAs (4.8 G of them, 0.14 ms at the fp32 peak).
//
// Tensor-core variant (bf16, `mma`), the FlashAttention-2 layout:
//  - a warp owns 16 query rows and a block 64 rows (256 blocks at the
//    serving shape); f's 16 x cbar A fragment stays in registers;
//  - the serving shape has only 1024 such row warps, under 8 an SM, too few
//    to hide the serial chain of a tile (products, max, shuffles, ex2,
//    products). So each row's keys are split between two warps (8 warps a
//    block, 2 blocks an SM: 16 warps), which merge their (m, l, O) in a
//    fixed order through shared memory at the end;
//  - key tiles of g [128, cbar] and h [128, 64] (64 keys for each of the
//    two warps of a row) are staged in shared memory in bf16,
//    double-buffered by 16-byte cp.async copies (zero filled past N and
//    past cbar and C), one barrier a tile, with padded rows so that ldmatrix
//    reads no bank twice. Copying was a third of the kernel's time while
//    each copy recomputed its row, column, bounds and address (measured by
//    tools/flash_split.py); a thread now sets its addresses up once and
//    spends an add and a copy per 16 bytes; g is read by ldmatrix as the B operand of
//    S = f g^T (m16n8k8 at cbar 8, else m16n8k16), h by ldmatrix.trans as
//    that of P h;
//  - S sits in fp32 accumulators; the row max is reduced over the 4 lanes
//    of a quad by shuffles, and p = 2^(s log2e - m log2e) is one FFMA and one
//    ex2.approx. l takes each tile's fp32 probabilities summed apart, then
//    added (the N-65536 fix of the fp32 variant), and lse = m + log l comes
//    from those fp32 sums, so the backward's p = exp(s - lse) is exact;
//  - the O accumulator is rescaled, and P's accumulator fragments are
//    rounded to bf16 A fragments in registers (no trip through shared
//    memory) for O += P h with m16n8k16. Rounding P to bf16 before the
//    value product is what the JAX einsum path (attention_core, beta cast
//    to h's dtype) and the port's plain version do too;
//  - o = O / l is written once in bf16, lse once in fp32. For C > 64 the
//    grid's third dimension takes 64-column slices of h, each recomputing S
//    (C 512 at the published PGGAN width: 8 slices).
// Each output row is owned by one warp: no atomics, deterministic.
//
// CUDA-core variant (fp32): exact fp32 online softmax, one query row per
// thread:
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "flash_wide.cuh"

namespace {

constexpr int kBlockK = 32;         // keys per shared-memory tile
constexpr int kChunk = 16;          // keys per online-softmax update
constexpr int kColsPerThread = 32;  // output columns each thread accumulates
constexpr int kRegCbar = 64;         // the widest cbar both variants hold in registers
constexpr int kRegCudaCoreC = 256;   // fp32: 8 column slices of 32, a thread each

// ---------------------------------------------------------------------------
// Tensor-core variant (bf16).

using bf16 = __nv_bfloat16;

constexpr int kMmaRowWarps = 4;                     // warps along the query rows
constexpr int kMmaSplit = 2;                        // warps along the keys of each row
constexpr int kMmaThreads = 32 * kMmaRowWarps * kMmaSplit;
constexpr int kMmaRows = 16 * kMmaRowWarps;         // query rows a block owns
constexpr int kMmaKeys = 64;                        // keys per warp and tile
constexpr int kMmaStageKeys = kMmaKeys * kMmaSplit;  // keys per staged tile
constexpr int kMmaCols = 64;                        // value columns a block computes
constexpr int kHStride = kMmaCols + 8;  // padded rows: the 8 rows an ldmatrix
                                        // reads fall in 8 distinct bank groups
constexpr int kMergeFloats = 36;        // per lane: O's 32 accumulators, m and l of 2 rows

// Row stride of the staged g tile: 16 bytes at cbar 8 (8 consecutive rows
// are 128 contiguous bytes), else padded by 16 bytes as h's.
template <int CB>
__host__ __device__ constexpr int g_stride() {
  return CB == 8 ? 8 : CB + 8;
}

template <int CB>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * 2 * kMmaStageKeys * (g_stride<CB>() + kHStride);
}

template <int CB>
__global__ void __launch_bounds__(kMmaThreads, 2) flash_attn_fwd_mma_kernel(
    const bf16* __restrict__ f, const bf16* __restrict__ g, const bf16* __restrict__ h,
    bf16* __restrict__ o, float* __restrict__ lse, int n, int cbar, int c, int64_t f_sb,
    int64_t f_sn, int64_t g_sb, int64_t g_sn, int64_t h_sb, int64_t h_sn, int64_t o_sb,
    int64_t o_sn, int64_t lse_sb, bool vec) {
  using namespace flash_mma;
  constexpr int GS = g_stride<CB>();
  constexpr int KS = CB == 8 ? 1 : CB / 16;  // k steps of S = f g^T
  static_assert(kMmaRowWarps * kMergeFloats * 32 * sizeof(float) <= mma_smem_bytes<CB>(),
                "the merge reuses the staging buffers");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* gs = reinterpret_cast<bf16*>(smem_raw);  // [2][kMmaStageKeys][GS]
  bf16* hs = gs + 2 * kMmaStageKeys * GS;        // [2][kMmaStageKeys][kHStride]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tig = lane % 4, mi = lane / 8, mr = lane % 8;  // mr, mi: ldmatrix row, matrix
  const int row_warp = warp % kMmaRowWarps, split = warp / kMmaRowWarps;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kMmaRows + 16 * row_warp;  // the warp's first query row
  const int c0 = blockIdx.z * kMmaCols;                  // the block's value columns
  f += b * f_sb;
  g += b * g_sb;
  h += b * h_sb;

  uint32_t fa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) load_a_frag(fa[ks], f, q0, 16 * ks, n, cbar, f_sn, lane);

  float acc[8][4];  // O: 16 rows x 64 columns, 8 blocks of 8 columns
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows lane/4 and lane/4 + 8
  float l_run[2] = {0.f, 0.f};              // this lane's share of l

  const TileCopier<kMmaStageKeys, CB, GS, kMmaThreads> g_copier(g, 0, cbar, g_sn, tid);
  const TileCopier<kMmaStageKeys, kMmaCols, kHStride, kMmaThreads> h_copier(h, c0, c, h_sn,
                                                                            tid);
  auto stage = [&](int t, int buf) {
    bf16* gt = gs + buf * kMmaStageKeys * GS;
    bf16* ht = hs + buf * kMmaStageKeys * kHStride;
    if (vec) {
      g_copier.copy(gt, t * kMmaStageKeys, n, g_sn);
      h_copier.copy(ht, t * kMmaStageKeys, n, h_sn);
    } else {
      stage_tile_elements<kMmaStageKeys, CB, GS, kMmaThreads>(gt, g, t * kMmaStageKeys, 0, n,
                                                              cbar, g_sn, tid);
      stage_tile_elements<kMmaStageKeys, kMmaCols, kHStride, kMmaThreads>(
          ht, h, t * kMmaStageKeys, c0, n, c, h_sn, tid);
    }
  };

  // Each staged tile holds kMmaSplit tiles of 64 keys; warp `split` of each
  // row group takes the split-th. One barrier a tile: it both publishes
  // tile t and retires tile t - 1, whose buffer the next copies refill.
  // (A third buffer, copies two tiles ahead, measured no faster.)
  const int ntiles = (n + kMmaStageKeys - 1) / kMmaStageKeys;
  stage(0, 0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();  // tile t has landed (this thread's copies)
    __syncthreads();     // ... and every thread's; tile t - 1 is retired
    if (t + 1 < ntiles) stage(t + 1, (t + 1) & 1);
    cp_async_commit();
    const int k0 = t * kMmaStageKeys + split * kMmaKeys;
    if (k0 >= n) continue;  // the last tile holds no key of this warp
    const int sub = (t & 1) * kMmaStageKeys + split * kMmaKeys;
    const bf16* gt = gs + sub * GS;
    const bf16* ht = hs + sub * kHStride;

    // S = f g^T: 16 rows x 64 keys, 8 blocks of 8 keys.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (CB == 8) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // matrix i of lanes 8i..8i+7: keys 32j + 8i ..
        uint32_t bf[4];
        ldmatrix_x4(bf, gt + (32 * j + lane) * GS);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma1688(s[4 * j + i], fa[0][0], fa[0][1], bf[i]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {  // matrices: (keys +0, k +0), (+0, +8), (+8, +0), (+8, +8)
          uint32_t bf[4];
          ldmatrix_x4(bf, gt + (16 * j + 8 * (mi / 2) + mr) * GS + 16 * ks + 8 * (mi % 2));
          mma16816(s[2 * j], fa[ks], bf[0], bf[1]);
          mma16816(s[2 * j + 1], fa[ks], bf[2], bf[3]);
        }
      }
    }
    if (k0 + kMmaKeys > n) {  // the last keys: those past N score -inf
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + 8 * j + 2 * tig + (e & 1) >= n) s[j][e] = -INFINITY;
        }
      }
    }

    // Online softmax. The tile holds a key inside N, so the new max is
    // finite, and 2^(-inf) = 0 covers the first tile and masked keys.
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float scale[2], msc[2], tsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      scale[r] = ex2((m_run[r] - mx[r]) * kLog2e);
      msc[r] = mx[r] * kLog2e;
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], kLog2e, -msc[e / 2]));
        tsum[e / 2] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = fmaf(l_run[r], scale[r], tsum[r]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= scale[0];
      acc[j][1] *= scale[0];
      acc[j][2] *= scale[1];
      acc[j][3] *= scale[1];
    }

    // O += P h: P's accumulators, in bf16 pairs, are the A fragments.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // matrices: (keys +0, cols +0), (+8, +0), (+0, +8), (+8, +8)
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, ht + (16 * kk + 8 * (mi % 2) + mr) * kHStride + 16 * j + 8 * (mi / 2));
        mma16816(acc[2 * j], pa, bf[0], bf[1]);
        mma16816(acc[2 * j + 1], pa, bf[2], bf[3]);
      }
    }
  }

  // Merge the two key halves of each row in a fixed order (deterministic):
  // the second warp of each row group hands (m, l, O) to the first through
  // shared memory, which now holds no tile (the last copy group was empty).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  float* xs = reinterpret_cast<float*>(smem_raw) + row_warp * kMergeFloats * 32 + lane;
  __syncthreads();  // every warp is done with the staged tiles
  if (split == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(4 * j + e) * 32] = acc[j][e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xs[(32 + r) * 32] = m_run[r];
      xs[(34 + r) * 32] = l_run[r];
    }
  }
  __syncthreads();
  if (split == 1) return;
  float a0[2], a1[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // The first half always holds a key; the second may hold none (m = -inf).
    const float m1 = xs[(32 + r) * 32], m = fmaxf(m_run[r], m1);
    a0[r] = ex2((m_run[r] - m) * kLog2e);
    a1[r] = ex2((m1 - m) * kLog2e);
    l_run[r] = a0[r] * l_run[r] + a1[r] * xs[(34 + r) * 32];
    m_run[r] = m;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = a0[e / 2] * acc[j][e] + a1[e / 2] * xs[(4 * j + e) * 32];
  }

  // Epilogue: o = O / l once in bf16, lse in fp32.
  bf16* ob = o + b * o_sb;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + lane / 4 + 8 * r;
    if (row >= n) continue;
    const float inv = 1.f / l_run[r];
    bf16* orow = ob + row * o_sn;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + 8 * j + 2 * tig;
      const float v0 = acc[j][2 * r] * inv, v1 = acc[j][2 * r + 1] * inv;
      if (vec && col < c) {  // c even: col + 1 < c too, and the pair 4-byte aligned
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < c) orow[col] = __float2bfloat16(v0);
        if (col + 1 < c) orow[col + 1] = __float2bfloat16(v1);
      }
    }
    if (blockIdx.z == 0 && tig == 0) lse[b * lse_sb + row] = m_run[r] + logf(l_run[r]);
  }
}

template <int CB>
cudaError_t launch_mma(const void* f, const void* g, const void* h, void* o, void* lse,
                       int batch, int n, int cbar, int c, const int64_t* st, bool vec,
                       cudaStream_t stream) {
  const dim3 grid((n + kMmaRows - 1) / kMmaRows, batch, (c + kMmaCols - 1) / kMmaCols);
  constexpr size_t smem = mma_smem_bytes<CB>();  // 41 KB at cbar 8, 74 KB at 64
  auto kernel = flash_attn_fwd_mma_kernel<CB>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(f), static_cast<const bf16*>(g), static_cast<const bf16*>(h),
      static_cast<bf16*>(o), static_cast<float*>(lse), n, cbar, c, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ---------------------------------------------------------------------------
// CUDA-core variant.

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

// dtype: 0 = float32 (the CUDA-core variant), 1 = bfloat16 (the tensor-core
// variant). Strides are in elements: batch and row strides of f, g, h, o,
// then the batch stride of lse; the last dimension of f, g, h and o must be
// contiguous. Launches on `stream` and returns the cudaError_t of
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attn_fwd(const void* f, const void* g, const void* h, void* o,
                              void* lse, int dtype, int device, int batch, int n,
                              int cbar, int c, int64_t f_sb, int64_t f_sn, int64_t g_sb,
                              int64_t g_sn, int64_t h_sb, int64_t h_sn, int64_t o_sb,
                              int64_t o_sn, int64_t lse_sb, void* stream) {
  if (batch < 1 || n < 1 || cbar < 1 || c < 1 || batch > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t st[9] = {f_sb, f_sn, g_sb, g_sn, h_sb, h_sn, o_sb, o_sn, lse_sb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cbar > kRegCbar || (dtype == 0 && c > kRegCudaCoreC)) {
    const void* in[6] = {f, g, h, nullptr, nullptr, nullptr};
    const int64_t wst[14] = {f_sb, f_sn, g_sb, g_sn, h_sb, h_sn, 0, 0, 0, o_sb, o_sn, 0, 0,
                             lse_sb};
    return static_cast<int>(flash_wide::launch<flash_wide::kFwd>(
        in, o, nullptr, lse, dtype, batch, n, cbar, c, wst, s));
  }
  if (dtype == 1) {
    // 16-byte staging copies and paired stores need every row to start on a
    // 16-byte boundary; other layouts are staged element by element.
    bool vec = cbar % 8 == 0 && c % 8 == 0 && aligned16(f) && aligned16(g) && aligned16(h) &&
               aligned16(o);
    for (int i = 0; i < 8; ++i) vec = vec && st[i] % 8 == 0;
    if (cbar <= 8) {
      err = launch_mma<8>(f, g, h, o, lse, batch, n, cbar, c, st, vec, s);
    } else if (cbar <= 16) {
      err = launch_mma<16>(f, g, h, o, lse, batch, n, cbar, c, st, vec, s);
    } else if (cbar <= 32) {
      err = launch_mma<32>(f, g, h, o, lse, batch, n, cbar, c, st, vec, s);
    } else {
      err = launch_mma<64>(f, g, h, o, lse, batch, n, cbar, c, st, vec, s);
    }
    return static_cast<int>(err);
  }
  return static_cast<int>(dispatch_cbar<float>(f, g, h, o, lse, batch, n, cbar, c, st, s));
}
