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
// The entry point picks the variant by type: bf16 runs on the bf16 tensor
// cores, fp32 on the TF32 tensor cores with every product split into three
// (3xTF32; the wrapper's VARIANTS table names them). The TPU kernel runs
// its key-block grid axis in sequence and carries the online-softmax state
// in VMEM scratch between grid steps; CUDA blocks run in no order, so in
// both variants that axis is a loop inside one block.
//
// What bounds it on the H100. A call does 2*B*N^2*(cbar + C) FLOPs of
// products and B*N^2 exponentials on O(B*N*(cbar + C)) bytes, so the N^2
// scores never reach device memory. SAGAN's cbar = C/8 makes the products
// cheap per score: at the serving shape (B 4, N 4096, cbar 8, C 64) they
// take 9.8 us at the bf16 tensor-core peak, while the 67 M exponentials take
// 17 us at the special-function unit's 16 a clock per SM. The exponentials
// bound the bf16 variant. The fp32 variant's products are three TF32
// products each, 3 x 9.7 GFLOP at the serving shape: 59 us at the TF32
// peak (one product each on the CUDA cores would take 0.14 ms).
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
// TF32 tensor-core variant (fp32), the bf16 variant's layout with fp32
// products to fp32 accuracy (3xTF32, flash_mma.cuh):
//  - the same warps, blocks and pipeline: a warp owns 16 query rows, two
//    warps split each row's 64-key tiles and merge at the end in a fixed
//    order; f's A fragment, split into tf32 hi and lo halves, stays in
//    registers;
//  - g and h tiles are staged in fp32 by 16-byte cp.async copies (4
//    floats a copy), rows padded by 4 words so that the 32 lanes' 32-bit
//    reads of a B fragment fall in 32 banks (ldmatrix moves 16-bit
//    elements and cannot transpose fp32 ones);
//  - S = f_lo g_hi + f_hi g_lo + f_hi g_hi with m16n8k8 tf32 products and
//    fp32 accumulators; the B operands are split as they are read;
//  - the online softmax is the bf16 variant's, l summed from the unsplit
//    fp32 probabilities, so lse stays exact;
//  - O += P_lo h_hi + P_hi h_lo + P_hi h_hi: a C fragment of S is an A
//    fragment of the tf32 product in a permuted k order (flash_mma.cuh), so
//    P never leaves registers, and h's rows are read in that order. Each
//    tile's product is summed in fresh accumulators and added to O by fp32
//    FMAs: the tensor cores' own sums cut toward zero, which over every
//    tile of a long N drifts;
//  - o and lse are written once in fp32; for C > 64 the grid's third
//    dimension takes 64-column slices, each recomputing S, up to C 256.
// The split costs three products where one TF32 product would lose the
// fp32 accuracy the JAX package's default type promises (2^-11 relative
// per product against about 2^-21).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "flash_wide.cuh"

namespace {

constexpr int kRegCbar = 64;   // the widest cbar both variants hold in registers
constexpr int kRegTf32C = 256;  // fp32 past this C: flash_wide.cuh's kernels

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
// TF32 tensor-core variant (fp32, 3xTF32).

constexpr int kTfHStride = kMmaCols + 4;  // h tile row stride in words (flash_mma.cuh)

// Row stride of the staged g tile, in words: cbar padded, plus 4.
template <int CB>
__host__ __device__ constexpr int tf32_g_stride() {
  return CB + 4;
}

template <int CB>
__host__ __device__ constexpr size_t tf32_smem_bytes() {
  return sizeof(float) * 2 * kMmaStageKeys * (tf32_g_stride<CB>() + kTfHStride);
}

template <int CB>
__global__ void __launch_bounds__(kMmaThreads, CB <= 32 ? 2 : 1) flash_attn_fwd_tf32_kernel(
    const float* __restrict__ f, const float* __restrict__ g, const float* __restrict__ h,
    float* __restrict__ o, float* __restrict__ lse, int n, int cbar, int c, int64_t f_sb,
    int64_t f_sn, int64_t g_sb, int64_t g_sn, int64_t h_sb, int64_t h_sn, int64_t o_sb,
    int64_t o_sn, int64_t lse_sb, bool vec) {
  using namespace flash_mma;
  constexpr int GS = tf32_g_stride<CB>();
  constexpr int HS = kTfHStride;
  constexpr int KS = CB / 8;  // k steps of S = f g^T
  static_assert(kMmaRowWarps * kMergeFloats * 32 * sizeof(float) <= tf32_smem_bytes<CB>(),
                "the merge reuses the staging buffers");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* gs = reinterpret_cast<float*>(smem_raw);  // [2][kMmaStageKeys][GS]
  float* hs = gs + 2 * kMmaStageKeys * GS;         // [2][kMmaStageKeys][HS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tig = lane % 4;
  const int row_warp = warp % kMmaRowWarps, split = warp / kMmaRowWarps;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kMmaRows + 16 * row_warp;  // the warp's first query row
  const int c0 = blockIdx.z * kMmaCols;                  // the block's value columns
  f += b * f_sb;
  g += b * g_sb;
  h += b * h_sb;

  Tf32Frag fa[KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) fa[ks] = load_a_frag_tf32(f, q0, 8 * ks, n, cbar, f_sn, lane);

  float acc[8][4];  // O: 16 rows x 64 columns, 8 blocks of 8 columns
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows grp and grp + 8
  float l_run[2] = {0.f, 0.f};              // this lane's share of l

  const TileCopier<kMmaStageKeys, CB, GS, kMmaThreads, float> g_copier(g, 0, cbar, g_sn, tid);
  const TileCopier<kMmaStageKeys, kMmaCols, HS, kMmaThreads, float> h_copier(h, c0, c, h_sn,
                                                                             tid);
  auto stage = [&](int t, int buf) {
    float* gt = gs + buf * kMmaStageKeys * GS;
    float* ht = hs + buf * kMmaStageKeys * HS;
    if (vec) {
      g_copier.copy(gt, t * kMmaStageKeys, n, g_sn);
      h_copier.copy(ht, t * kMmaStageKeys, n, h_sn);
    } else {
      stage_tile_elements<kMmaStageKeys, CB, GS, kMmaThreads>(gt, g, t * kMmaStageKeys, 0, n,
                                                              cbar, g_sn, tid);
      stage_tile_elements<kMmaStageKeys, kMmaCols, HS, kMmaThreads>(ht, h, t * kMmaStageKeys,
                                                                    c0, n, c, h_sn, tid);
    }
  };

  // The bf16 variant's pipeline: two warps per row group take alternate
  // 64-key halves of each staged tile; one barrier a tile.
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
    const float* gt = gs + sub * GS;
    const float* ht = hs + sub * HS;

    // S = f g^T: 16 rows x 64 keys, 8 blocks of 8 keys; b0, b1 of block j
    // are g[key 8 j + grp][k tig, tig + 4].
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const float* gr = gt + (8 * j + grp) * GS + tig;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) mma1688_tf32x3(s[j], fa[ks], gr[8 * ks], gr[8 * ks + 4]);
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

    // Online softmax, as the bf16 variant's: l from the fp32 probabilities.
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

    // O = O scale + P h. The tile's product is summed apart, then added to
    // O by fp32 FMAs: the tensor cores cut the addends of their sums
    // toward zero, and a sum that took every tile drifted with N (on an
    // H100: 6 % of the fp32 tolerance at N 4096, 23 % at 16384, 76 % at
    // 65536).
    // P's block kk (keys 8 kk ..) is the A fragment in permuted k order,
    // so h is read at keys 8 kk + 2 tig (b0) and + 1 (b1).
    float pv[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) pv[j][0] = pv[j][1] = pv[j][2] = pv[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const Tf32Frag pa = split_frag(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
      const float* hr = ht + (8 * kk + 2 * tig) * HS + grp;
#pragma unroll
      for (int j = 0; j < 8; ++j) mma1688_tf32x3(pv[j], pa, hr[8 * j], hr[HS + 8 * j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(acc[j][e], scale[e / 2], pv[j][e]);
    }
  }

  // Merge the two key halves of each row in a fixed order (deterministic),
  // as the bf16 variant does.
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

  // Epilogue: o = O / l and lse, once, in fp32.
  float* ob = o + b * o_sb;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + grp + 8 * r;
    if (row >= n) continue;
    const float inv = 1.f / l_run[r];
    float* orow = ob + row * o_sn;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + 8 * j + 2 * tig;
      const float v0 = acc[j][2 * r] * inv, v1 = acc[j][2 * r + 1] * inv;
      if (vec && col < c) {  // c a multiple of 4: col + 1 < c too, the pair 8-byte aligned
        *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
      } else {
        if (col < c) orow[col] = v0;
        if (col + 1 < c) orow[col + 1] = v1;
      }
    }
    if (blockIdx.z == 0 && tig == 0) lse[b * lse_sb + row] = m_run[r] + logf(l_run[r]);
  }
}

template <int CB>
cudaError_t launch_tf32(const void* f, const void* g, const void* h, void* o, void* lse,
                        int batch, int n, int cbar, int c, const int64_t* st, bool vec,
                        cudaStream_t stream) {
  const dim3 grid((n + kMmaRows - 1) / kMmaRows, batch, (c + kMmaCols - 1) / kMmaCols);
  constexpr size_t smem = tf32_smem_bytes<CB>();  // 80 KB at cbar 8, 136 KB at 64
  auto kernel = flash_attn_fwd_tf32_kernel<CB>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const float*>(f), static_cast<const float*>(g), static_cast<const float*>(h),
      static_cast<float*>(o), static_cast<float*>(lse), n, cbar, c, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], vec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the 3xTF32 tensor-core variant), 1 = bfloat16 (the
// bf16 tensor-core variant); past cbar 64, or C 256 for float32,
// flash_wide.cuh's kernels, in the same two variants. Strides are in elements: batch and row strides of f, g, h, o,
// then the batch stride of lse; the last dimension of f, g, h and o must be
// contiguous. Launches on `stream`, writes the flash_mma::Variant it
// launched to `variant`, and returns the cudaError_t of cudaGetLastError()
// after the launch (0 on success).
extern "C" int flash_attn_fwd(const void* f, const void* g, const void* h, void* o,
                              void* lse, int dtype, int device, int batch, int n,
                              int cbar, int c, int64_t f_sb, int64_t f_sn, int64_t g_sb,
                              int64_t g_sn, int64_t h_sb, int64_t h_sn, int64_t o_sb,
                              int64_t o_sn, int64_t lse_sb, void* stream, int* variant) {
  if (batch < 1 || n < 1 || cbar < 1 || c < 1 || batch > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t st[9] = {f_sb, f_sn, g_sb, g_sn, h_sb, h_sn, o_sb, o_sn, lse_sb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *variant = dtype == 1 ? flash_mma::kTensorCore : flash_mma::kTf32x3;
  if (cbar > kRegCbar || (dtype == 0 && c > kRegTf32C)) {
    const void* in[6] = {f, g, h, nullptr, nullptr, nullptr};
    const int64_t wst[14] = {f_sb, f_sn, g_sb, g_sn, h_sb, h_sn, 0, 0, 0, o_sb, o_sn, 0, 0,
                             lse_sb};
    return static_cast<int>(flash_wide::launch<flash_wide::kFwd>(
        in, o, nullptr, lse, dtype, batch, n, cbar, c, wst, s));
  }
  // 16-byte staging copies and paired stores need every row to start on a
  // 16-byte boundary; other layouts are staged element by element.
  const int per16 = dtype == 1 ? 8 : 4;  // elements in 16 bytes
  bool vec = cbar % per16 == 0 && c % per16 == 0 && aligned16(f) && aligned16(g) &&
             aligned16(h) && aligned16(o);
  for (int i = 0; i < 8; ++i) vec = vec && st[i] % per16 == 0;
  if (dtype == 1) {
    if (cbar <= 8) {
      err = launch_mma<8>(f, g, h, o, lse, batch, n, cbar, c, st, vec, s);
    } else if (cbar <= 16) {
      err = launch_mma<16>(f, g, h, o, lse, batch, n, cbar, c, st, vec, s);
    } else if (cbar <= 32) {
      err = launch_mma<32>(f, g, h, o, lse, batch, n, cbar, c, st, vec, s);
    } else {
      err = launch_mma<64>(f, g, h, o, lse, batch, n, cbar, c, st, vec, s);
    }
  } else if (cbar <= 8) {
    err = launch_tf32<8>(f, g, h, o, lse, batch, n, cbar, c, st, vec, s);
  } else if (cbar <= 16) {
    err = launch_tf32<16>(f, g, h, o, lse, batch, n, cbar, c, st, vec, s);
  } else if (cbar <= 32) {
    err = launch_tf32<32>(f, g, h, o, lse, batch, n, cbar, c, st, vec, s);
  } else {
    err = launch_tf32<64>(f, g, h, o, lse, batch, n, cbar, c, st, vec, s);
  }
  return static_cast<int>(err);
}
