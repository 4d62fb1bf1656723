// SAGAN flash-attention backward for Hopper (sm_90a).
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
// delta: [B, N] fp32. Any cbar, C and N (the last tile of either side is
// masked); the batch is at most 65535 (the grid's y). Outputs are in the
// input dtype. The kernels below take cbar up to 64 and C up to 256, whose
// fragments and accumulators they hold in registers; past those the entry
// points launch flash_wide.cuh's kernels, which cut every operand into
// chunks of 64 columns.
//
// What bounds them on the H100. dq does 2*B*N^2*(2*cbar + C) and dkv
// 2*B*N^2*(2*cbar + 2*C) FLOPs of products plus B*N^2 exponentials each, on
// O(B*N*(cbar + C)) bytes, so the N^2 matrices p, dp and ds never reach
// device memory. At the training shape (B 3, N 4096, cbar 8, C 64) dkv's
// 14.5 GFLOP take 14.7 us at the bf16 tensor-core peak and its 50 M
// exponentials 12.9 us at the special-function unit's rate: its products
// bound it, closely followed by the exponentials. In fp32 the dkv
// variant's products are three TF32 products each: 88 us at the TF32
// peak.
//
// The TPU kernels carry their fp32 accumulators across a sequential grid
// axis in VMEM. CUDA blocks run in no order, so that axis becomes a loop
// inside one block, and each output row is owned by one warp (its sums
// over the split halves added in a fixed order): no atomics, so the
// results are deterministic, as the two TPU kernels' are.
//
// dkv, tensor-core variant (bf16), the key-owning
// FlashAttention-2 backward:
//  - a warp owns 16 key rows and keeps g's (16 x cbar) and h's (16 x C) A
//    fragments in registers, with fp32 accumulators for dg and dh. The
//    training shape (B 3, N 4096) has only 768 such key warps, about 1.5 a
//    scheduler of the 132 SMs, too few to hide a tile's serial chain; so
//    each key row's queries are split between two warps, whose dg and dh
//    are summed in a fixed order through shared memory at the end. A block
//    is 2 key warps x 2 query halves (32 keys, 4 warps): 384 blocks at the
//    training shape, and at 3 blocks an SM (at most 170 registers a
//    thread, 43 KB of shared memory a block) all of them are resident in
//    one wave on 132 SMs, 2.9 an SM on average (64-key blocks would make
//    192, 72 SMs holding one and 60 two);
//  - it loops over query tiles of 128 (64 for each half): f [128, cbar],
//    do [128, C], lse and delta [128], double-buffered by 16-byte cp.async
//    copies in shared memory, one barrier a tile (zero filled past N;
//    queries past N get p = 0). Copying was over 40 % of the kernel's time
//    while each copy recomputed its row, column, bounds and address
//    (tools/flash_split.py); a thread now sets its addresses up once;
//  - per tile, with m16n8k16 (m16n8k8 for S at cbar 8):
//      S^T = g f^T (f by ldmatrix, as stored);
//      P^T = 2^(S^T log2e - lse log2e), one FFMA and one ex2.approx each;
//      dP^T = h do^T (h from registers, do by ldmatrix, as stored);
//      dS^T = P^T (dP^T - delta);
//      dh += P^T do (P^T's accumulators rounded to bf16 A fragments in
//        registers, do by ldmatrix.trans);
//      dg += dS^T f (dS^T likewise, f by ldmatrix.trans; n = cbar).
//    P and dS are rounded to bf16 only as product operands; sums are fp32,
//    and dg and dh are written once. For C > 64 the grid's third dimension
//    takes 64-column slices of dh (dP still runs over all of C; the first
//    slice also computes dg).
//
// dq, tensor-core variant (bf16), dkv's transposed twin, the query-owning
// FlashAttention-2 backward. dq's products are 2 B N^2 (2 cbar + C) FLOPs,
// 8.05 GFLOP at the training shape (8 us at the bf16 tensor-core peak), so
// its 50 M exponentials bound it (12 us), as they bound the forward:
//  - a warp owns 16 query rows and keeps f's (16 x cbar) and do's (16 x C)
//    A fragments in registers, with the rows' lse log2e and delta and an
//    fp32 (16 x cbar) accumulator for df; each row's keys are split
//    between two warps that take alternate 64-key tiles and sum their df
//    in a fixed order through shared memory at the end (768 query warps
//    at the training shape would leave the SMs as short of warps as dkv's
//    key warps). A block is 2 query warps x 2 key halves, 384 blocks at the
//    training shape, 3 an SM;
//  - it loops over key tiles of 128 (64 for each half): g [128, cbar] and
//    h [128, C], double-buffered by the same 16-byte cp.async copier, zero
//    filled past N; keys past N get p = 0;
//  - per tile, with m16n8k16 (m16n8k8 for S at cbar 8):
//      S = f g^T (g by ldmatrix, as stored);
//      P = 2^(S log2e - lse log2e);
//      dP = do h^T (do from registers, h by ldmatrix, as stored);
//      dS = P (dP - delta);
//      df += dS g (dS's accumulators rounded to bf16 A fragments in
//        registers, g by ldmatrix.trans; n = cbar).
//    dS is rounded to bf16 only as a product operand; sums are fp32, and
//    df is written once. At C 256 do's fragments take 64 registers a
//    thread; that instantiation has its own launch bound (one block an
//    SM, up to 255 registers) instead of 3 blocks an SM.
//
// dkv, TF32 tensor-core variant (fp32): the bf16 variant's warps and
// order of sums, with every product to fp32 accuracy as three TF32
// products of split operands (3xTF32, flash_mma.cuh):
//  - a warp owns 16 key rows with g's A fragment (tf32 hi and lo) in
//    registers; two warps split each key row's queries and sum in a fixed
//    order at the end; fp32 accumulators for dg and dh;
//  - h's A fragments would take 2 x C/2 registers a thread in hi and lo:
//    instead the block's 32 h rows (all of C) stay in shared memory, and
//    dP^T reads each k step's fragment once for the warp's 4 query blocks;
//  - query tiles of 64 (32 for each half): f, do (all of C), lse and delta,
//    fp32, double-buffered by 16-byte cp.async copies, rows padded by 4
//    words so that the lanes' 32-bit B-fragment reads fall in 32 banks; 50
//    KB a block at cbar 8, C 64 (3 blocks an SM, all 384 blocks of the
//    training shape resident), 202 KB at cbar 64, C 256;
//  - per tile: S^T = g f^T, P^T = 2^(S^T log2e - lse log2e), dP^T = h do^T,
//    dS^T = P^T (dP^T - delta), dh += P^T do and dg += dS^T f, each product
//    x_lo y_hi + x_hi y_lo + x_hi y_hi; P^T's and dS^T's C fragments are
//    the A fragments of the last two in permuted k order (do and f read
//    in that order). A tile's dh and dg are summed apart and added by fp32
//    adds (the tensor cores' own sums cut toward zero and would drift over
//    every tile of a long N). For C > 64 the grid's third dimension takes
//    64-column slices of dh, as in the bf16 variant.
//
// dq, TF32 tensor-core variant (fp32): dkv_tf32's transposed twin, as the
// bf16 dq is the bf16 dkv's. Its products are three TF32 products each:
// 0.049 ms at the TF32 peak at the training shape.
//  - a warp owns 16 query rows with f's and (C 64) do's A fragments, tf32
//    hi and lo, in registers, the rows' lse log2e and delta, and an fp32
//    accumulator for df; two warps split each query row's keys, taking
//    alternate 16-key halves of each staged tile, and sum df in a fixed
//    order at the end. A block is 2 query warps x 2 key halves (32 query
//    rows, 4 warps): 384 blocks at the training shape, 3 an SM. At C 256
//    do's fragments would take 256 registers a thread: the block's 32 do
//    rows stay in shared memory instead, and dP reads and splits each k
//    step's A fragment once for the warp's key blocks;
//  - key tiles of 32 (16 for each half): g [32, cbar] and h [32, C] by
//    16-byte cp.async, double-buffered (a third buffer was no faster). The
//    B operands' split was a third of fp32 B1 and B3, where every warp
//    repeats it (tools/flash_split.py): here each thread splits the chunks
//    it copied, in place (hi over the copy, lo beside it), once for the
//    block's four warps, and waits only for its own copies to do so; one
//    barrier a tile. g's rows are padded by 4 words and h's 16-byte chunks
//    swizzled by the row (chunk ^ row % 8): both read orders of the B
//    fragments fall in 32 banks. 38 KB a block at cbar 8, C 64, 195 KB at
//    cbar 64, C 256;
//  - per tile: S = f g^T, P = 2^(S log2e - lse log2e), dP = do h^T, dS =
//    P (dP - delta), df += dS g, each product x_lo y_hi + x_hi y_lo + x_hi
//    y_hi; dS's C fragments are the A fragments of the last in permuted k
//    order (g read at keys 2 tig and 2 tig + 1). Each 8-key block's df
//    products are summed apart and added by fp32 adds (the tensor cores'
//    sums cut toward zero: with one accumulator dq's error at N 65536
//    reached 98 % of its tolerance). A 16-key tile gives a warp only two
//    independent accumulators a product, too few to cover the mma's
//    latency: dP sums its even and odd k steps apart, and the three TF32
//    products of each are issued across the accumulators in turn.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "flash_wide.cuh"

namespace {

constexpr int kRegCbar = 64;        // the widest cbar held in registers
constexpr int kRegC = 256;          // the widest C held in registers (CK)

struct Strides {
  // Element strides: batch and row of f, g, h, do; batch of lse and delta;
  // batch and row of the outputs (df, or dg then dh).
  int64_t f_sb, f_sn, g_sb, g_sn, h_sb, h_sn, do_sb, do_sn, row_sb;
  int64_t o0_sb, o0_sn, o1_sb, o1_sn;
};

// ---------------------------------------------------------------------------
// dkv, tensor-core variant (bf16).

using bf16 = __nv_bfloat16;

constexpr int kMmaRowWarps = 2;                 // warps along the key rows
constexpr int kMmaSplit = 2;                    // warps along the queries of each key row
constexpr int kMmaThreads = 32 * kMmaRowWarps * kMmaSplit;
constexpr int kMmaKeys = 16 * kMmaRowWarps;     // key rows a block owns
constexpr int kMmaQ = 64;                       // queries per warp and tile
constexpr int kMmaStageQ = kMmaQ * kMmaSplit;   // queries per staged tile
constexpr int kMmaCols = 64;                    // dh columns a block computes

// Row stride of the staged f tile: 16 bytes at cbar 8, else padded by 16
// bytes so that the 8 rows an ldmatrix reads fall in distinct bank groups.
template <int CB>
__host__ __device__ constexpr int f_stride() {
  return CB == 8 ? 8 : CB + 8;
}

template <int CB, int CK>
__host__ __device__ constexpr size_t dkv_mma_smem_bytes() {
  return 2 * kMmaStageQ * (sizeof(bf16) * (f_stride<CB>() + CK + 8) + 2 * sizeof(float));
}

// CB: cbar padded to 8, 16, 32 or 64; CK: C padded to 64 or 256 (dP's depth).
template <int CB, int CK>
__global__ void __launch_bounds__(kMmaThreads, CK == 64 ? 3 : 1) flash_attn_dkv_mma_kernel(
    const bf16* __restrict__ f, const bf16* __restrict__ g, const bf16* __restrict__ h,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dg, bf16* __restrict__ dh, int n,
    int cbar, int c, Strides st, bool vec) {
  using namespace flash_mma;
  constexpr int FS = f_stride<CB>();
  constexpr int DS = CK + 8;                 // do tile row stride
  constexpr int KS = CB == 8 ? 1 : CB / 16;  // k steps of S^T = g f^T
  constexpr int HK = CK / 16;                // k steps of dP^T = h do^T
  constexpr int NG = CB / 8;                 // 8-column blocks of dg
  constexpr int kMerge = 4 * (8 + NG);       // per lane: dh's and dg's accumulators
  static_assert(kMmaRowWarps * kMerge * 32 * sizeof(float) <= dkv_mma_smem_bytes<CB, CK>(),
                "the merge reuses the staging buffers");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* fs = reinterpret_cast<bf16*>(smem_raw);                     // [2][kMmaStageQ][FS]
  bf16* dos = fs + 2 * kMmaStageQ * FS;                             // [2][kMmaStageQ][DS]
  float* ls = reinterpret_cast<float*>(dos + 2 * kMmaStageQ * DS);  // [2][kMmaStageQ] lse
  float* dls = ls + 2 * kMmaStageQ;                                 // [2][kMmaStageQ] delta

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tig = lane % 4, mi = lane / 8, mr = lane % 8;  // mr, mi: ldmatrix row, matrix
  const int row_warp = warp % kMmaRowWarps, split = warp / kMmaRowWarps;
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * kMmaKeys + 16 * row_warp;  // the warp's first key row
  const int c0 = blockIdx.z * kMmaCols;                  // the block's dh columns
  const bool with_dg = blockIdx.z == 0;
  f += b * st.f_sb;
  g += b * st.g_sb;
  h += b * st.h_sb;
  dout += b * st.do_sb;
  lse += b * st.row_sb;
  delta += b * st.row_sb;

  uint32_t ga[KS][4], ha[HK][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) load_a_frag(ga[ks], g, k0, 16 * ks, n, cbar, st.g_sn, lane);
#pragma unroll
  for (int ks = 0; ks < HK; ++ks) load_a_frag(ha[ks], h, k0, 16 * ks, n, c, st.h_sn, lane);
  float dga[NG][4], dha[8][4];
#pragma unroll
  for (int j = 0; j < NG; ++j) dga[j][0] = dga[j][1] = dga[j][2] = dga[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) dha[j][0] = dha[j][1] = dha[j][2] = dha[j][3] = 0.f;

  const TileCopier<kMmaStageQ, CB, FS, kMmaThreads> f_copier(f, 0, cbar, st.f_sn, tid);
  const TileCopier<kMmaStageQ, CK, DS, kMmaThreads> do_copier(dout, 0, c, st.do_sn, tid);
  auto stage = [&](int t, int buf) {
    const int q0 = t * kMmaStageQ;
    bf16* ft = fs + buf * kMmaStageQ * FS;
    bf16* dt = dos + buf * kMmaStageQ * DS;
    if (vec) {
      f_copier.copy(ft, q0, n, st.f_sn);
      do_copier.copy(dt, q0, n, st.do_sn);
    } else {
      stage_tile_elements<kMmaStageQ, CB, FS, kMmaThreads>(ft, f, q0, 0, n, cbar, st.f_sn, tid);
      stage_tile_elements<kMmaStageQ, CK, DS, kMmaThreads>(dt, dout, q0, 0, n, c, st.do_sn,
                                                           tid);
    }
    stage_row<kMmaStageQ, kMmaThreads>(ls + buf * kMmaStageQ, lse, q0, n, vec, tid);
    stage_row<kMmaStageQ, kMmaThreads>(dls + buf * kMmaStageQ, delta, q0, n, vec, tid);
  };

  // Each staged tile holds kMmaSplit tiles of 64 queries; warp `split` of
  // each key group takes the split-th. One barrier a tile: it both
  // publishes tile t and retires tile t - 1, whose buffer the next copies
  // refill.
  const int ntiles = (n + kMmaStageQ - 1) / kMmaStageQ;
  stage(0, 0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();  // tile t has landed (this thread's copies)
    __syncthreads();     // ... and every thread's; tile t - 1 is retired
    if (t + 1 < ntiles) stage(t + 1, (t + 1) & 1);
    cp_async_commit();
    const int q0 = t * kMmaStageQ + split * kMmaQ;
    if (q0 >= n) continue;  // the last tile holds no query of this warp
    const int sub = (t & 1) * kMmaStageQ + split * kMmaQ;
    const bf16* ft = fs + sub * FS;
    const bf16* dt = dos + sub * DS;
    const float* lt = ls + sub;
    const float* dlt = dls + sub;

    // S^T = g f^T: 16 keys x 64 queries, 8 blocks of 8 queries.
    float p[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
    if constexpr (CB == 8) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // matrix i of lanes 8i..8i+7: queries 32j + 8i ..
        uint32_t bf[4];
        ldmatrix_x4(bf, ft + (32 * j + lane) * FS);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma1688(p[4 * j + i], ga[0][0], ga[0][1], bf[i]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {  // matrices: (queries +0, k +0), (+0, +8), (+8, +0), (+8, +8)
          uint32_t bf[4];
          ldmatrix_x4(bf, ft + (16 * j + 8 * (mi / 2) + mr) * FS + 16 * ks + 8 * (mi % 2));
          mma16816(p[2 * j], ga[ks], bf[0], bf[1]);
          mma16816(p[2 * j + 1], ga[ks], bf[2], bf[3]);
        }
      }
    }

    // P^T = 2^(S^T log2e - lse log2e); queries past N get 0.
    const bool ragged = q0 + kMmaQ > n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lq = *reinterpret_cast<const float2*>(lt + 8 * j + 2 * tig);
      const float l0 = lq.x * kLog2e, l1 = lq.y * kLog2e;
      p[j][0] = ex2(fmaf(p[j][0], kLog2e, -l0));
      p[j][1] = ex2(fmaf(p[j][1], kLog2e, -l1));
      p[j][2] = ex2(fmaf(p[j][2], kLog2e, -l0));
      p[j][3] = ex2(fmaf(p[j][3], kLog2e, -l1));
      if (ragged) {
        const int q = q0 + 8 * j + 2 * tig;
        if (q >= n) p[j][0] = p[j][2] = 0.f;
        if (q + 1 >= n) p[j][1] = p[j][3] = 0.f;
      }
    }

    // dP^T = h do^T: 16 keys x 64 queries, over C.
    float ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HK; ++ks) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // matrices: (queries +0, C +0), (+0, +8), (+8, +0), (+8, +8)
        uint32_t bf[4];
        ldmatrix_x4(bf, dt + (16 * j + 8 * (mi / 2) + mr) * DS + 16 * ks + 8 * (mi % 2));
        mma16816(ds[2 * j], ha[ks], bf[0], bf[1]);
        mma16816(ds[2 * j + 1], ha[ks], bf[2], bf[3]);
      }
    }
    // dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dq = *reinterpret_cast<const float2*>(dlt + 8 * j + 2 * tig);
      ds[j][0] = p[j][0] * (ds[j][0] - dq.x);
      ds[j][1] = p[j][1] * (ds[j][1] - dq.y);
      ds[j][2] = p[j][2] * (ds[j][2] - dq.x);
      ds[j][3] = p[j][3] * (ds[j][3] - dq.y);
    }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 queries a step
      // dh += P^T do: the slice's 64 columns of do, transposed.
      const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                              pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                              pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                              pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // matrices: (queries +0, cols +0), (+8, +0), (+0, +8), (+8, +8)
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, dt + (16 * kk + 8 * (mi % 2) + mr) * DS + c0 + 16 * j + 8 * (mi / 2));
        mma16816(dha[2 * j], pa, bf[0], bf[1]);
        mma16816(dha[2 * j + 1], pa, bf[2], bf[3]);
      }
      // dg += dS^T f
      if (with_dg) {
        const uint32_t da[4] = {pack_bf16(ds[2 * kk][0], ds[2 * kk][1]),
                                pack_bf16(ds[2 * kk][2], ds[2 * kk][3]),
                                pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]),
                                pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3])};
        if constexpr (CB == 8) {  // matrices: queries +0, +8 (lanes 0-15 address them)
          uint32_t bf[2];
          ldmatrix_x2_trans(bf, ft + (16 * kk + 8 * (mi % 2) + mr) * FS);
          mma16816(dga[0], da, bf[0], bf[1]);
        } else {
#pragma unroll
          for (int j = 0; j < CB / 16; ++j) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, ft + (16 * kk + 8 * (mi % 2) + mr) * FS + 16 * j + 8 * (mi / 2));
            mma16816(dga[2 * j], da, bf[0], bf[1]);
            mma16816(dga[2 * j + 1], da, bf[2], bf[3]);
          }
        }
      }
    }
  }

  // Sum the two query halves of each key row in a fixed order
  // (deterministic): the second warp of each key group hands its
  // accumulators to the first through shared memory, which now holds no
  // tile (the last copy group was empty).
  float* xs = reinterpret_cast<float*>(smem_raw) + row_warp * kMerge * 32 + lane;
  __syncthreads();  // every warp is done with the staged tiles
  if (split == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(4 * j + e) * 32] = dha[j][e];
    }
#pragma unroll
    for (int j = 0; j < NG; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(32 + 4 * j + e) * 32] = dga[j][e];
    }
  }
  __syncthreads();
  if (split == 1) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dha[j][e] += xs[(4 * j + e) * 32];
  }
#pragma unroll
  for (int j = 0; j < NG; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dga[j][e] += xs[(32 + 4 * j + e) * 32];
  }

  // Epilogue: dh's slice and (first slice) dg, each written once.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + lane / 4 + 8 * r;
    if (row >= n) continue;
    bf16* hrow = dh + b * st.o1_sb + row * st.o1_sn;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + 8 * j + 2 * tig;
      if (vec && col < c) {  // c even: col + 1 < c too, and the pair 4-byte aligned
        *reinterpret_cast<__nv_bfloat162*>(hrow + col) =
            __floats2bfloat162_rn(dha[j][2 * r], dha[j][2 * r + 1]);
      } else {
        if (col < c) hrow[col] = __float2bfloat16(dha[j][2 * r]);
        if (col + 1 < c) hrow[col + 1] = __float2bfloat16(dha[j][2 * r + 1]);
      }
    }
    if (!with_dg) continue;
    bf16* grow = dg + b * st.o0_sb + row * st.o0_sn;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int col = 8 * j + 2 * tig;
      if (vec && col < cbar) {
        *reinterpret_cast<__nv_bfloat162*>(grow + col) =
            __floats2bfloat162_rn(dga[j][2 * r], dga[j][2 * r + 1]);
      } else {
        if (col < cbar) grow[col] = __float2bfloat16(dga[j][2 * r]);
        if (col + 1 < cbar) grow[col + 1] = __float2bfloat16(dga[j][2 * r + 1]);
      }
    }
  }
}

template <int CB, int CK>
cudaError_t launch_dkv_mma(const void* const* in, void* dg, void* dh, int batch, int n,
                           int cbar, int c, const Strides& st, bool vec, cudaStream_t stream) {
  const dim3 grid((n + kMmaKeys - 1) / kMmaKeys, batch, (c + kMmaCols - 1) / kMmaCols);
  constexpr size_t smem = dkv_mma_smem_bytes<CB, CK>();  // 43 KB at cbar 8, C 64
  auto kernel = flash_attn_dkv_mma_kernel<CB, CK>;
  if (smem > 48 * 1024) {  // up to 174 KB at cbar 64, C 256
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(in[0]), static_cast<const bf16*>(in[1]),
      static_cast<const bf16*>(in[2]), static_cast<const bf16*>(in[3]),
      static_cast<const float*>(in[4]), static_cast<const float*>(in[5]), static_cast<bf16*>(dg),
      static_cast<bf16*>(dh), n, cbar, c, st, vec);
  return cudaGetLastError();
}

template <int CB>
cudaError_t dispatch_dkv_mma(const void* const* in, void* dg, void* dh, int batch, int n,
                             int cbar, int c, const Strides& st, bool vec, cudaStream_t s) {
  if (c <= 64) return launch_dkv_mma<CB, 64>(in, dg, dh, batch, n, cbar, c, st, vec, s);
  return launch_dkv_mma<CB, 256>(in, dg, dh, batch, n, cbar, c, st, vec, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

cudaError_t dkv_mma(const void* const* in, void* dg, void* dh, int batch, int n, int cbar,
                    int c, const Strides& st, cudaStream_t s) {
  // 16-byte staging copies and paired stores need every row of f, do, dg
  // and dh to start on a 16-byte boundary (and lse, delta on 4 floats);
  // other layouts are staged element by element.
  bool vec = cbar % 8 == 0 && c % 8 == 0 && st.row_sb % 4 == 0 && aligned16(dg) && aligned16(dh);
  for (int i = 0; i < 6; ++i) vec = vec && aligned16(in[i]);
  const int64_t strides[12] = {st.f_sb, st.f_sn, st.g_sb, st.g_sn, st.h_sb, st.h_sn,
                               st.do_sb, st.do_sn, st.o0_sb, st.o0_sn, st.o1_sb, st.o1_sn};
  for (int i = 0; i < 12; ++i) vec = vec && strides[i] % 8 == 0;
  if (cbar <= 8) return dispatch_dkv_mma<8>(in, dg, dh, batch, n, cbar, c, st, vec, s);
  if (cbar <= 16) return dispatch_dkv_mma<16>(in, dg, dh, batch, n, cbar, c, st, vec, s);
  if (cbar <= 32) return dispatch_dkv_mma<32>(in, dg, dh, batch, n, cbar, c, st, vec, s);
  return dispatch_dkv_mma<64>(in, dg, dh, batch, n, cbar, c, st, vec, s);
}

// ---------------------------------------------------------------------------
// dkv, TF32 tensor-core variant (fp32, 3xTF32).

constexpr int kTfQ = 32;                      // queries per warp and tile
constexpr int kTfStageQ = kTfQ * kMmaSplit;   // queries per staged tile

// Shared memory: f [2][kTfStageQ][CB + 4], do [2][kTfStageQ][CK + 4], lse
// and delta [2][kTfStageQ] each, and the block's h rows [kMmaKeys][CK + 4],
// all fp32 (rows padded by 4 words: flash_mma.cuh).
template <int CB, int CK>
__host__ __device__ constexpr size_t dkv_tf32_smem_bytes() {
  return sizeof(float) * (2 * kTfStageQ * ((CB + 4) + (CK + 4) + 2) + kMmaKeys * (CK + 4));
}

// CB: cbar padded to 8, 16, 32 or 64; CK: C padded to 64 or 256 (dP's depth).
template <int CB, int CK>
__global__ void __launch_bounds__(kMmaThreads, CK == 64 ? (CB <= 16 ? 3 : 2) : 1)
    flash_attn_dkv_tf32_kernel(const float* __restrict__ f, const float* __restrict__ g,
                               const float* __restrict__ h, const float* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ dg, float* __restrict__ dh, int n, int cbar,
                               int c, Strides st, bool vec) {
  using namespace flash_mma;
  constexpr int FS = CB + 4;       // f tile row stride
  constexpr int DS = CK + 4;       // do tile and h row stride
  constexpr int KS = CB / 8;       // k steps of S^T = g f^T
  constexpr int HK = CK / 8;       // k steps of dP^T = h do^T
  constexpr int NG = CB / 8;       // 8-column blocks of dg
  constexpr int NQ = kTfQ / 8;     // 8-query blocks of a warp's tile
  constexpr int kMerge = 4 * (8 + NG);  // per lane: dh's and dg's accumulators
  static_assert(kMmaRowWarps * kMerge * 32 * sizeof(float) <= dkv_tf32_smem_bytes<CB, CK>(),
                "the merge reuses the staging buffers");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* fs = reinterpret_cast<float*>(smem_raw);  // [2][kTfStageQ][FS]
  float* dos = fs + 2 * kTfStageQ * FS;            // [2][kTfStageQ][DS]
  float* ls = dos + 2 * kTfStageQ * DS;            // [2][kTfStageQ] lse
  float* dls = ls + 2 * kTfStageQ;                 // [2][kTfStageQ] delta
  float* hs = dls + 2 * kTfStageQ;                 // [kMmaKeys][DS] the block's h rows

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tig = lane % 4;
  const int row_warp = warp % kMmaRowWarps, split = warp / kMmaRowWarps;
  const int b = blockIdx.y;
  const int kb = blockIdx.x * kMmaKeys;  // the block's first key row
  const int k0 = kb + 16 * row_warp;     // the warp's first key row
  const int c0 = blockIdx.z * kMmaCols;  // the block's dh columns
  const bool with_dg = blockIdx.z == 0;
  f += b * st.f_sb;
  g += b * st.g_sb;
  h += b * st.h_sb;
  dout += b * st.do_sb;
  lse += b * st.row_sb;
  delta += b * st.row_sb;

  Tf32Frag ga[KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) ga[ks] = load_a_frag_tf32(g, k0, 8 * ks, n, cbar, st.g_sn, lane);
  float dga[NG][4], dha[8][4];
#pragma unroll
  for (int j = 0; j < NG; ++j) dga[j][0] = dga[j][1] = dga[j][2] = dga[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) dha[j][0] = dha[j][1] = dha[j][2] = dha[j][3] = 0.f;

  const TileCopier<kTfStageQ, CB, FS, kMmaThreads, float> f_copier(f, 0, cbar, st.f_sn, tid);
  const TileCopier<kTfStageQ, CK, DS, kMmaThreads, float> do_copier(dout, 0, c, st.do_sn, tid);
  auto stage = [&](int t, int buf) {
    const int q0 = t * kTfStageQ;
    float* ft = fs + buf * kTfStageQ * FS;
    float* dt = dos + buf * kTfStageQ * DS;
    if (vec) {
      f_copier.copy(ft, q0, n, st.f_sn);
      do_copier.copy(dt, q0, n, st.do_sn);
    } else {
      stage_tile_elements<kTfStageQ, CB, FS, kMmaThreads>(ft, f, q0, 0, n, cbar, st.f_sn, tid);
      stage_tile_elements<kTfStageQ, CK, DS, kMmaThreads>(dt, dout, q0, 0, n, c, st.do_sn, tid);
    }
    stage_row<kTfStageQ, kMmaThreads>(ls + buf * kTfStageQ, lse, q0, n, vec, tid);
    stage_row<kTfStageQ, kMmaThreads>(dls + buf * kTfStageQ, delta, q0, n, vec, tid);
  };

  // The block's h rows (all of C) stay in shared memory: dP^T = h do^T
  // reads its A fragments from them, a k step at a time. They land with
  // the first tile.
  if (vec) {
    const TileCopier<kMmaKeys, CK, DS, kMmaThreads, float> h_copier(h, 0, c, st.h_sn, tid);
    h_copier.copy(hs, kb, n, st.h_sn);
  } else {
    stage_tile_elements<kMmaKeys, CK, DS, kMmaThreads>(hs, h, kb, 0, n, c, st.h_sn, tid);
  }
  const float* hr = hs + (16 * row_warp + grp) * DS + tig;  // A fragment rows grp, grp + 8

  // The bf16 variant's pipeline, at 32 queries a warp and tile.
  const int ntiles = (n + kTfStageQ - 1) / kTfStageQ;
  stage(0, 0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();  // tile t has landed (this thread's copies)
    __syncthreads();     // ... and every thread's; tile t - 1 is retired
    if (t + 1 < ntiles) stage(t + 1, (t + 1) & 1);
    cp_async_commit();
    const int q0 = t * kTfStageQ + split * kTfQ;
    if (q0 >= n) continue;  // the last tile holds no query of this warp
    const int sub = (t & 1) * kTfStageQ + split * kTfQ;
    const float* ft = fs + sub * FS;
    const float* dt = dos + sub * DS;
    const float* lt = ls + sub;
    const float* dlt = dls + sub;

    // S^T = g f^T: 16 keys x 32 queries, 4 blocks of 8 queries; b0, b1 of
    // block j are f[query 8 j + grp][k tig, tig + 4].
    float p[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
      const float* fr = ft + (8 * j + grp) * FS + tig;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) mma1688_tf32x3(p[j], ga[ks], fr[8 * ks], fr[8 * ks + 4]);
    }

    // P^T = 2^(S^T log2e - lse log2e); queries past N get 0.
    const bool ragged = q0 + kTfQ > n;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float2 lq = *reinterpret_cast<const float2*>(lt + 8 * j + 2 * tig);
      const float l0 = lq.x * kLog2e, l1 = lq.y * kLog2e;
      p[j][0] = ex2(fmaf(p[j][0], kLog2e, -l0));
      p[j][1] = ex2(fmaf(p[j][1], kLog2e, -l1));
      p[j][2] = ex2(fmaf(p[j][2], kLog2e, -l0));
      p[j][3] = ex2(fmaf(p[j][3], kLog2e, -l1));
      if (ragged) {
        const int q = q0 + 8 * j + 2 * tig;
        if (q >= n) p[j][0] = p[j][2] = 0.f;
        if (q + 1 >= n) p[j][1] = p[j][3] = 0.f;
      }
    }

    // dP^T = h do^T: 16 keys x 32 queries, over C; h's fragment of a k
    // step is split once for the 4 query blocks.
    float ds[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HK; ++ks) {
      const Tf32Frag ha = split_frag(hr[8 * ks], hr[8 * DS + 8 * ks], hr[8 * ks + 4],
                                     hr[8 * DS + 8 * ks + 4]);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float* dr = dt + (8 * j + grp) * DS + 8 * ks + tig;
        mma1688_tf32x3(ds[j], ha, dr[0], dr[4]);
      }
    }
    // dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float2 dq = *reinterpret_cast<const float2*>(dlt + 8 * j + 2 * tig);
      ds[j][0] = p[j][0] * (ds[j][0] - dq.x);
      ds[j][1] = p[j][1] * (ds[j][1] - dq.y);
      ds[j][2] = p[j][2] * (ds[j][2] - dq.x);
      ds[j][3] = p[j][3] * (ds[j][3] - dq.y);
    }

    // P^T's and dS^T's block kk (queries 8 kk ..) are A fragments in
    // permuted k order, so do and f are read at queries 8 kk + 2 tig and + 1.
    // The tile's products are summed apart and added to dh and dg by fp32
    // adds, as the forward does (the tensor cores' sums cut toward zero).
    float th[8][4], tg[NG][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) th[j][0] = th[j][1] = th[j][2] = th[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NG; ++j) tg[j][0] = tg[j][1] = tg[j][2] = tg[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
      // dh += P^T do: the slice's 64 columns of do.
      const Tf32Frag pa = split_frag(p[kk][0], p[kk][2], p[kk][1], p[kk][3]);
      const float* dr = dt + (8 * kk + 2 * tig) * DS + c0 + grp;
#pragma unroll
      for (int j = 0; j < 8; ++j) mma1688_tf32x3(th[j], pa, dr[8 * j], dr[DS + 8 * j]);
      // dg += dS^T f
      if (with_dg) {
        const Tf32Frag da = split_frag(ds[kk][0], ds[kk][2], ds[kk][1], ds[kk][3]);
        const float* fr = ft + (8 * kk + 2 * tig) * FS + grp;
#pragma unroll
        for (int j = 0; j < NG; ++j) mma1688_tf32x3(tg[j], da, fr[8 * j], fr[FS + 8 * j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dha[j][e] += th[j][e];
    }
#pragma unroll
    for (int j = 0; j < NG; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dga[j][e] += tg[j][e];
    }
  }

  // Sum the two query halves of each key row in a fixed order
  // (deterministic), as the bf16 variant does.
  float* xs = reinterpret_cast<float*>(smem_raw) + row_warp * kMerge * 32 + lane;
  __syncthreads();  // every warp is done with the staged tiles
  if (split == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(4 * j + e) * 32] = dha[j][e];
    }
#pragma unroll
    for (int j = 0; j < NG; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(32 + 4 * j + e) * 32] = dga[j][e];
    }
  }
  __syncthreads();
  if (split == 1) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dha[j][e] += xs[(4 * j + e) * 32];
  }
#pragma unroll
  for (int j = 0; j < NG; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dga[j][e] += xs[(32 + 4 * j + e) * 32];
  }

  // Epilogue: dh's slice and (first slice) dg, each written once in fp32.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + grp + 8 * r;
    if (row >= n) continue;
    float* hrow = dh + b * st.o1_sb + row * st.o1_sn;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + 8 * j + 2 * tig;
      if (vec && col < c) {  // c a multiple of 4: col + 1 < c too, the pair 8-byte aligned
        *reinterpret_cast<float2*>(hrow + col) = make_float2(dha[j][2 * r], dha[j][2 * r + 1]);
      } else {
        if (col < c) hrow[col] = dha[j][2 * r];
        if (col + 1 < c) hrow[col + 1] = dha[j][2 * r + 1];
      }
    }
    if (!with_dg) continue;
    float* grow = dg + b * st.o0_sb + row * st.o0_sn;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int col = 8 * j + 2 * tig;
      if (vec && col < cbar) {
        *reinterpret_cast<float2*>(grow + col) = make_float2(dga[j][2 * r], dga[j][2 * r + 1]);
      } else {
        if (col < cbar) grow[col] = dga[j][2 * r];
        if (col + 1 < cbar) grow[col + 1] = dga[j][2 * r + 1];
      }
    }
  }
}

template <int CB, int CK>
cudaError_t launch_dkv_tf32(const void* const* in, void* dg, void* dh, int batch, int n,
                            int cbar, int c, const Strides& st, bool vec, cudaStream_t stream) {
  const dim3 grid((n + kMmaKeys - 1) / kMmaKeys, batch, (c + kMmaCols - 1) / kMmaCols);
  constexpr size_t smem = dkv_tf32_smem_bytes<CB, CK>();  // 50 KB at cbar 8, C 64
  auto kernel = flash_attn_dkv_tf32_kernel<CB, CK>;
  if (smem > 48 * 1024) {  // up to 202 KB at cbar 64, C 256
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
      static_cast<const float*>(in[2]), static_cast<const float*>(in[3]),
      static_cast<const float*>(in[4]), static_cast<const float*>(in[5]),
      static_cast<float*>(dg), static_cast<float*>(dh), n, cbar, c, st, vec);
  return cudaGetLastError();
}

template <int CB>
cudaError_t dispatch_dkv_tf32(const void* const* in, void* dg, void* dh, int batch, int n,
                              int cbar, int c, const Strides& st, bool vec, cudaStream_t s) {
  if (c <= 64) return launch_dkv_tf32<CB, 64>(in, dg, dh, batch, n, cbar, c, st, vec, s);
  return launch_dkv_tf32<CB, 256>(in, dg, dh, batch, n, cbar, c, st, vec, s);
}

cudaError_t dkv_tf32(const void* const* in, void* dg, void* dh, int batch, int n, int cbar,
                     int c, const Strides& st, cudaStream_t s) {
  // 16-byte staging copies (4 floats) and paired stores need every row of
  // f, h, do, dg and dh to start on a 16-byte boundary (and lse, delta on
  // 4 floats); other layouts are staged element by element.
  bool vec = cbar % 4 == 0 && c % 4 == 0 && st.row_sb % 4 == 0 && aligned16(dg) && aligned16(dh);
  for (int i = 0; i < 6; ++i) vec = vec && aligned16(in[i]);
  const int64_t strides[12] = {st.f_sb, st.f_sn, st.g_sb, st.g_sn, st.h_sb, st.h_sn,
                               st.do_sb, st.do_sn, st.o0_sb, st.o0_sn, st.o1_sb, st.o1_sn};
  for (int i = 0; i < 12; ++i) vec = vec && strides[i] % 4 == 0;
  if (cbar <= 8) return dispatch_dkv_tf32<8>(in, dg, dh, batch, n, cbar, c, st, vec, s);
  if (cbar <= 16) return dispatch_dkv_tf32<16>(in, dg, dh, batch, n, cbar, c, st, vec, s);
  if (cbar <= 32) return dispatch_dkv_tf32<32>(in, dg, dh, batch, n, cbar, c, st, vec, s);
  return dispatch_dkv_tf32<64>(in, dg, dh, batch, n, cbar, c, st, vec, s);
}

// ---------------------------------------------------------------------------
// dq, tensor-core variant (bf16).

template <int CB, int CK>
__host__ __device__ constexpr size_t dq_mma_smem_bytes() {
  return 2 * kMmaStageQ * sizeof(bf16) * (f_stride<CB>() + CK + 8);
}

// CB: cbar padded to 8, 16, 32 or 64; CK: C padded to 64 or 256 (dP's depth).
// kMmaKeys, kMmaQ and kMmaStageQ name dkv's roles: here a block owns
// kMmaKeys query rows and a staged tile holds kMmaStageQ keys.
template <int CB, int CK>
__global__ void __launch_bounds__(kMmaThreads, CK == 64 ? 3 : 1) flash_attn_dq_mma_kernel(
    const bf16* __restrict__ f, const bf16* __restrict__ g, const bf16* __restrict__ h,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ df, int n, int cbar, int c,
    Strides st, bool vec) {
  using namespace flash_mma;
  constexpr int GS = f_stride<CB>();         // g tile row stride
  constexpr int HS = CK + 8;                 // h tile row stride
  constexpr int KS = CB == 8 ? 1 : CB / 16;  // k steps of S = f g^T
  constexpr int DK = CK / 16;                // k steps of dP = do h^T
  constexpr int NG = CB / 8;                 // 8-column blocks of df
  constexpr int kMerge = 4 * NG;             // per lane: df's accumulators
  static_assert(kMmaRowWarps * kMerge * 32 * sizeof(float) <= dq_mma_smem_bytes<CB, CK>(),
                "the merge reuses the staging buffers");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* gs = reinterpret_cast<bf16*>(smem_raw);  // [2][kMmaStageQ][GS]
  bf16* hs = gs + 2 * kMmaStageQ * GS;           // [2][kMmaStageQ][HS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tig = lane % 4, mi = lane / 8, mr = lane % 8;  // mr, mi: ldmatrix row, matrix
  const int row_warp = warp % kMmaRowWarps, split = warp / kMmaRowWarps;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kMmaKeys + 16 * row_warp;  // the warp's first query row
  f += b * st.f_sb;
  g += b * st.g_sb;
  h += b * st.h_sb;
  dout += b * st.do_sb;

  uint32_t fa[KS][4], doa[DK][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) load_a_frag(fa[ks], f, q0, 16 * ks, n, cbar, st.f_sn, lane);
#pragma unroll
  for (int ks = 0; ks < DK; ++ks) load_a_frag(doa[ks], dout, q0, 16 * ks, n, c, st.do_sn, lane);
  // The thread's two rows (grp and grp + 8): lse log2e and delta. A row
  // past N has f = do = 0, so its dS is 0 whatever p is.
  const int r0 = q0 + lane / 4, r1 = r0 + 8;
  const float l0 = r0 < n ? lse[b * st.row_sb + r0] * kLog2e : 0.f;
  const float l1 = r1 < n ? lse[b * st.row_sb + r1] * kLog2e : 0.f;
  const float d0 = r0 < n ? delta[b * st.row_sb + r0] : 0.f;
  const float d1 = r1 < n ? delta[b * st.row_sb + r1] : 0.f;
  float dfa[NG][4];
#pragma unroll
  for (int j = 0; j < NG; ++j) dfa[j][0] = dfa[j][1] = dfa[j][2] = dfa[j][3] = 0.f;

  const TileCopier<kMmaStageQ, CB, GS, kMmaThreads> g_copier(g, 0, cbar, st.g_sn, tid);
  const TileCopier<kMmaStageQ, CK, HS, kMmaThreads> h_copier(h, 0, c, st.h_sn, tid);
  auto stage = [&](int t, int buf) {
    const int k0 = t * kMmaStageQ;
    bf16* gt = gs + buf * kMmaStageQ * GS;
    bf16* ht = hs + buf * kMmaStageQ * HS;
    if (vec) {
      g_copier.copy(gt, k0, n, st.g_sn);
      h_copier.copy(ht, k0, n, st.h_sn);
    } else {
      stage_tile_elements<kMmaStageQ, CB, GS, kMmaThreads>(gt, g, k0, 0, n, cbar, st.g_sn, tid);
      stage_tile_elements<kMmaStageQ, CK, HS, kMmaThreads>(ht, h, k0, 0, n, c, st.h_sn, tid);
    }
  };

  // Each staged tile holds kMmaSplit tiles of 64 keys; warp `split` of each
  // query group takes the split-th. One barrier a tile, as in dkv.
  const int ntiles = (n + kMmaStageQ - 1) / kMmaStageQ;
  stage(0, 0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();  // tile t has landed (this thread's copies)
    __syncthreads();     // ... and every thread's; tile t - 1 is retired
    if (t + 1 < ntiles) stage(t + 1, (t + 1) & 1);
    cp_async_commit();
    const int k0 = t * kMmaStageQ + split * kMmaQ;
    if (k0 >= n) continue;  // the last tile holds no key of this warp
    const int sub = (t & 1) * kMmaStageQ + split * kMmaQ;
    const bf16* gt = gs + sub * GS;
    const bf16* ht = hs + sub * HS;

    // S = f g^T: 16 queries x 64 keys, 8 blocks of 8 keys.
    float p[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
    if constexpr (CB == 8) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // matrix i of lanes 8i..8i+7: keys 32j + 8i ..
        uint32_t bf[4];
        ldmatrix_x4(bf, gt + (32 * j + lane) * GS);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma1688(p[4 * j + i], fa[0][0], fa[0][1], bf[i]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // matrices: (keys +0, k +0), (+0, +8), (+8, +0), (+8, +8)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t bf[4];
          ldmatrix_x4(bf, gt + (16 * j + 8 * (mi / 2) + mr) * GS + 16 * ks + 8 * (mi % 2));
          mma16816(p[2 * j], fa[ks], bf[0], bf[1]);
          mma16816(p[2 * j + 1], fa[ks], bf[2], bf[3]);
        }
      }
    }

    // P = 2^(S log2e - lse log2e); keys past N get 0.
    const bool ragged = k0 + kMmaQ > n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      p[j][0] = ex2(fmaf(p[j][0], kLog2e, -l0));
      p[j][1] = ex2(fmaf(p[j][1], kLog2e, -l0));
      p[j][2] = ex2(fmaf(p[j][2], kLog2e, -l1));
      p[j][3] = ex2(fmaf(p[j][3], kLog2e, -l1));
      if (ragged) {
        const int key = k0 + 8 * j + 2 * tig;
        if (key >= n) p[j][0] = p[j][2] = 0.f;
        if (key + 1 >= n) p[j][1] = p[j][3] = 0.f;
      }
    }

    // dP = do h^T: 16 queries x 64 keys, over C.
    float ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DK; ++ks) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // matrices: (keys +0, C +0), (+0, +8), (+8, +0), (+8, +8)
        uint32_t bf[4];
        ldmatrix_x4(bf, ht + (16 * j + 8 * (mi / 2) + mr) * HS + 16 * ks + 8 * (mi % 2));
        mma16816(ds[2 * j], doa[ks], bf[0], bf[1]);
        mma16816(ds[2 * j + 1], doa[ks], bf[2], bf[3]);
      }
    }
    // dS = P (dP - delta)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ds[j][0] = p[j][0] * (ds[j][0] - d0);
      ds[j][1] = p[j][1] * (ds[j][1] - d0);
      ds[j][2] = p[j][2] * (ds[j][2] - d1);
      ds[j][3] = p[j][3] * (ds[j][3] - d1);
    }

    // df += dS g, 16 keys a step (g transposed).
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t da[4] = {pack_bf16(ds[2 * kk][0], ds[2 * kk][1]),
                              pack_bf16(ds[2 * kk][2], ds[2 * kk][3]),
                              pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]),
                              pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3])};
      if constexpr (CB == 8) {  // matrices: keys +0, +8 (lanes 0-15 address them)
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, gt + (16 * kk + 8 * (mi % 2) + mr) * GS);
        mma16816(dfa[0], da, bf[0], bf[1]);
      } else {
#pragma unroll
        for (int j = 0; j < CB / 16; ++j) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, gt + (16 * kk + 8 * (mi % 2) + mr) * GS + 16 * j + 8 * (mi / 2));
          mma16816(dfa[2 * j], da, bf[0], bf[1]);
          mma16816(dfa[2 * j + 1], da, bf[2], bf[3]);
        }
      }
    }
  }

  // Sum the two key halves of each query row in a fixed order
  // (deterministic), as dkv does.
  float* xs = reinterpret_cast<float*>(smem_raw) + row_warp * kMerge * 32 + lane;
  __syncthreads();  // every warp is done with the staged tiles
  if (split == 1) {
#pragma unroll
    for (int j = 0; j < NG; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(4 * j + e) * 32] = dfa[j][e];
    }
  }
  __syncthreads();
  if (split == 1) return;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dfa[j][e] += xs[(4 * j + e) * 32];
  }

  // Epilogue: df, written once.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + lane / 4 + 8 * r;
    if (row >= n) continue;
    bf16* frow = df + b * st.o0_sb + row * st.o0_sn;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int col = 8 * j + 2 * tig;
      if (vec && col < cbar) {  // cbar a multiple of 8: col + 1 < cbar, the pair aligned
        *reinterpret_cast<__nv_bfloat162*>(frow + col) =
            __floats2bfloat162_rn(dfa[j][2 * r], dfa[j][2 * r + 1]);
      } else {
        if (col < cbar) frow[col] = __float2bfloat16(dfa[j][2 * r]);
        if (col + 1 < cbar) frow[col + 1] = __float2bfloat16(dfa[j][2 * r + 1]);
      }
    }
  }
}

template <int CB, int CK>
cudaError_t launch_dq_mma(const void* const* in, void* df, int batch, int n, int cbar, int c,
                          const Strides& st, bool vec, cudaStream_t stream) {
  const dim3 grid((n + kMmaKeys - 1) / kMmaKeys, batch);
  constexpr size_t smem = dq_mma_smem_bytes<CB, CK>();  // 40 KB at cbar 8, C 64
  auto kernel = flash_attn_dq_mma_kernel<CB, CK>;
  if (smem > 48 * 1024) {  // up to 172 KB at cbar 64, C 256
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(in[0]), static_cast<const bf16*>(in[1]),
      static_cast<const bf16*>(in[2]), static_cast<const bf16*>(in[3]),
      static_cast<const float*>(in[4]), static_cast<const float*>(in[5]),
      static_cast<bf16*>(df), n, cbar, c, st, vec);
  return cudaGetLastError();
}

template <int CB>
cudaError_t dispatch_dq_mma(const void* const* in, void* df, int batch, int n, int cbar, int c,
                            const Strides& st, bool vec, cudaStream_t s) {
  if (c <= 64) return launch_dq_mma<CB, 64>(in, df, batch, n, cbar, c, st, vec, s);
  return launch_dq_mma<CB, 256>(in, df, batch, n, cbar, c, st, vec, s);
}

cudaError_t dq_mma(const void* const* in, void* df, int batch, int n, int cbar, int c,
                   const Strides& st, cudaStream_t s) {
  // As dkv_mma: 16-byte staging copies of g and h and paired stores of df
  // need 16-byte aligned rows; other layouts are staged element by element.
  bool vec = cbar % 8 == 0 && c % 8 == 0 && aligned16(df);
  for (int i = 0; i < 4; ++i) vec = vec && aligned16(in[i]);
  const int64_t strides[10] = {st.f_sb, st.f_sn, st.g_sb, st.g_sn, st.h_sb, st.h_sn,
                               st.do_sb, st.do_sn, st.o0_sb, st.o0_sn};
  for (int i = 0; i < 10; ++i) vec = vec && strides[i] % 8 == 0;
  if (cbar <= 8) return dispatch_dq_mma<8>(in, df, batch, n, cbar, c, st, vec, s);
  if (cbar <= 16) return dispatch_dq_mma<16>(in, df, batch, n, cbar, c, st, vec, s);
  if (cbar <= 32) return dispatch_dq_mma<32>(in, df, batch, n, cbar, c, st, vec, s);
  return dispatch_dq_mma<64>(in, df, batch, n, cbar, c, st, vec, s);
}

// ---------------------------------------------------------------------------
// dq, TF32 tensor-core variant (fp32, 3xTF32).

constexpr int kTfK = 16;                      // keys per warp and tile
constexpr int kTfStageK = kTfK * kMmaSplit;   // keys per staged tile

// Shared memory: two staged key tiles, each split: g hi and lo
// [kTfStageK][CB + 4], then h hi and lo [kTfStageK][CK] (h's rows unpadded,
// their 16-byte chunks swizzled by the row: chunk ^ (row % 8)); at CK 256
// also the block's do rows [kMmaKeys][CK + 4], unsplit. All fp32.
template <int CB, int CK>
__host__ __device__ constexpr size_t dq_tf32_smem_bytes() {
  return sizeof(float) *
         (2 * 2 * kTfStageK * ((CB + 4) + CK) + (CK == 64 ? 0 : kMmaKeys * (CK + 4)));
}

// The 16-byte chunks of a staged [kTfStageK, COLS] tile of an fp32 matrix
// that one thread copies (cp.async, zero filled past N and the width; or
// element by element) and then splits in place: hi over the copy, lo `lo`
// floats further on. A thread keeps one column chunk of rows row, row +
// kRowStep, ..., its source address set up once (a tile then costs it one
// 64-bit multiply-add, as TileCopier's). With kSwizzle, a row's chunks are
// permuted by the row: chunk ^ (row % 8).
template <int COLS, int STRIDE, bool kSwizzle>
struct SplitTileCopier {
  static constexpr int kChunks = COLS / 4;
  static_assert(kMmaThreads % kChunks == 0, "a thread keeps one column chunk");
  static constexpr int kRowStep = kMmaThreads / kChunks;
  static constexpr int kPerThread = (kTfStageK + kRowStep - 1) / kRowStep;

  const float* base;  // the matrix: a valid address for zero fills
  const float* src;   // this thread's chunk in row `row` of tile 0
  int64_t step;       // kRowStep rows of the source
  int row, chunk;

  __device__ __forceinline__ SplitTileCopier(const float* matrix, int64_t sn, int tid)
      : base(matrix), step(kRowStep * sn), row(tid / kChunks), chunk(tid % kChunks) {
    src = matrix + row * sn + 4 * chunk;
  }
  __device__ __forceinline__ bool has(int k) const {
    return kTfStageK % kRowStep == 0 || row + k * kRowStep < kTfStageK;
  }
  __device__ __forceinline__ int offset(int k) const {
    const int r = row + k * kRowStep;
    return r * STRIDE + 4 * (kSwizzle ? chunk ^ (r % 8) : chunk);
  }
  // Rows [r0, r0 + kTfStageK) into tile, in the current cp.async group.
  __device__ __forceinline__ void copy(float* tile, int r0, int n, int width, int64_t sn,
                                       bool vec) const {
    const float* s = src + r0 * sn;
    const int col = 4 * chunk;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (!has(k)) break;
      const bool in = r0 + row + k * kRowStep < n;
      float* d = tile + offset(k);
      if (vec) {  // width a multiple of 4: a chunk is all in or all out
        const bool any = in && col < width;
        flash_mma::cp_async16(d, any ? s + k * step : base, any ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] = in && col + e < width ? s[k * step + e] : 0.f;
      }
    }
  }
  __device__ __forceinline__ void split(float* tile, int lo) const {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (!has(k)) break;
      float* d = tile + offset(k);
      const float4 v = *reinterpret_cast<const float4*>(d);
      const flash_mma::Tf32Split s0 = flash_mma::split_tf32(v.x), s1 = flash_mma::split_tf32(v.y),
                                 s2 = flash_mma::split_tf32(v.z), s3 = flash_mma::split_tf32(v.w);
      *reinterpret_cast<uint4*>(d) = make_uint4(s0.hi, s1.hi, s2.hi, s3.hi);
      *reinterpret_cast<uint4*>(d + lo) = make_uint4(s0.lo, s1.lo, s2.lo, s3.lo);
    }
  }
};

// CB: cbar padded to 8, 16, 32 or 64; CK: C padded to 64 or 256 (dP's depth).
// As in the bf16 dq, kMmaKeys names the query rows a block owns.
template <int CB, int CK>
__global__ void __launch_bounds__(kMmaThreads, CK == 64 ? (CB <= 16 ? 3 : 2) : 1)
    flash_attn_dq_tf32_kernel(const float* __restrict__ f, const float* __restrict__ g,
                              const float* __restrict__ h, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ df, int n, int cbar, int c, Strides st,
                              bool vec) {
  using namespace flash_mma;
  constexpr int GS = CB + 4;       // g tile row stride
  constexpr int DS = CK + 4;       // do row stride (CK 256)
  constexpr int KS = CB / 8;       // k steps of S = f g^T
  constexpr int DK = CK / 8;       // k steps of dP = do h^T
  constexpr int NG = CB / 8;       // 8-column blocks of df
  constexpr int NK = kTfK / 8;     // 8-key blocks of a warp's tile
  constexpr bool kDoRegs = CK == 64;  // do's A fragments in registers, else its rows in smem
  constexpr int kGTile = kTfStageK * GS, kHTile = kTfStageK * CK;  // one half (hi or lo)
  constexpr int kBuf = 2 * (kGTile + kHTile);  // a staged tile: g hi, g lo, h hi, h lo
  constexpr int kMerge = 4 * NG;   // per lane: df's accumulators
  static_assert(CK >= 32, "the swizzle permutes 8 chunks of a row");
  static_assert(kMmaRowWarps * kMerge * 32 * sizeof(float) <= dq_tf32_smem_bytes<CB, CK>(),
                "the merge reuses the staging buffers");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tiles = reinterpret_cast<float*>(smem_raw);  // [2][kBuf]
  float* dos = tiles + 2 * kBuf;                      // CK 256: [kMmaKeys][DS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tig = lane % 4;
  const int row_warp = warp % kMmaRowWarps, split = warp / kMmaRowWarps;
  const int b = blockIdx.y;
  const int qb = blockIdx.x * kMmaKeys;  // the block's first query row
  const int q0 = qb + 16 * row_warp;     // the warp's
  f += b * st.f_sb;
  g += b * st.g_sb;
  h += b * st.h_sb;
  dout += b * st.do_sb;

  Tf32Frag fa[KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) fa[ks] = load_a_frag_tf32(f, q0, 8 * ks, n, cbar, st.f_sn, lane);
  Tf32Frag doa[kDoRegs ? DK : 1];
  if constexpr (kDoRegs) {
#pragma unroll
    for (int ks = 0; ks < DK; ++ks) {
      doa[ks] = load_a_frag_tf32(dout, q0, 8 * ks, n, c, st.do_sn, lane);
    }
  }
  // The thread's two rows (grp and grp + 8): lse log2e and delta. A row
  // past N has f = do = 0, so its dS is 0 whatever p is.
  const int r0 = q0 + grp, r1 = r0 + 8;
  const float l0 = r0 < n ? lse[b * st.row_sb + r0] * kLog2e : 0.f;
  const float l1 = r1 < n ? lse[b * st.row_sb + r1] * kLog2e : 0.f;
  const float d0 = r0 < n ? delta[b * st.row_sb + r0] : 0.f;
  const float d1 = r1 < n ? delta[b * st.row_sb + r1] : 0.f;
  float dfa[NG][4];
#pragma unroll
  for (int j = 0; j < NG; ++j) dfa[j][0] = dfa[j][1] = dfa[j][2] = dfa[j][3] = 0.f;

  // Each staged tile of g and h: a thread copies its chunks (16-byte
  // cp.async, zero filled past N and the widths) and then splits them in
  // place, so each tile is split once for the block's four warps, and a
  // thread waits only for its own copies to do so.
  const SplitTileCopier<CB, GS, false> g_copier(g, st.g_sn, tid);
  const SplitTileCopier<CK, CK, true> h_copier(h, st.h_sn, tid);
  auto copy = [&](int t, int buf) {
    float* base = tiles + buf * kBuf;
    g_copier.copy(base, t * kTfStageK, n, cbar, st.g_sn, vec);
    h_copier.copy(base + 2 * kGTile, t * kTfStageK, n, c, st.h_sn, vec);
  };
  auto split_tile = [&](int buf) {
    float* base = tiles + buf * kBuf;
    g_copier.split(base, kGTile);
    h_copier.split(base + 2 * kGTile, kHTile);
  };

  // At CK 256 the block's do rows (all of C) stay in shared memory, and
  // dP reads each k step's A fragment from them, split once for the warp's
  // key blocks. They land with the first tile.
  if constexpr (!kDoRegs) {
    if (vec) {
      const TileCopier<kMmaKeys, CK, DS, kMmaThreads, float> do_copier(dout, 0, c, st.do_sn, tid);
      do_copier.copy(dos, qb, n, st.do_sn);
    } else {
      stage_tile_elements<kMmaKeys, CK, DS, kMmaThreads>(dos, dout, qb, 0, n, c, st.do_sn, tid);
    }
  }
  const float* dr = dos + (16 * row_warp + grp) * DS + tig;  // A fragment rows grp, grp + 8

  // Tile t computes from buffer t & 1 while tile t + 1 lands in the other;
  // then each thread splits its own copies of t + 1, and after the one
  // barrier of a tile, tile t + 2 is copied into the retired buffer.
  const int ntiles = (n + kTfStageK - 1) / kTfStageK;
  copy(0, 0);
  cp_async_commit();
  if (ntiles > 1) copy(1, 1);
  cp_async_commit();
  cp_async_wait<1>();  // tile 0 (and do's rows) have landed: this thread's copies
  split_tile(0);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    const int k0 = t * kTfStageK + split * kTfK;  // the warp's first key
    if (k0 < n) {
      const float* ghi = tiles + buf * kBuf + split * kTfK * GS;
      const float* glo = ghi + kGTile;
      const float* hhi = tiles + buf * kBuf + 2 * kGTile + split * kTfK * CK;
      const float* hlo = hhi + kHTile;

      // The three TF32 products of each 3xTF32 product (lo hi, hi lo, hi
      // hi) are issued for every independent accumulator in turn, so that
      // no mma waits on the one before it.
      // S = f g^T: 16 queries x 16 keys, 2 blocks of 8 keys; b0, b1 of
      // block j are g[key 8 j + grp][k tig, tig + 4].
      float p[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t bh[NK][2], bl[NK][2];
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const int r = (8 * j + grp) * GS + 8 * ks + tig;
          bh[j][0] = __float_as_uint(ghi[r]);
          bh[j][1] = __float_as_uint(ghi[r + 4]);
          bl[j][0] = __float_as_uint(glo[r]);
          bl[j][1] = __float_as_uint(glo[r + 4]);
        }
#pragma unroll
        for (int j = 0; j < NK; ++j) mma1688_tf32(p[j], fa[ks].lo, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < NK; ++j) mma1688_tf32(p[j], fa[ks].hi, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < NK; ++j) mma1688_tf32(p[j], fa[ks].hi, bh[j][0], bh[j][1]);
      }

      // P = 2^(S log2e - lse log2e); keys past N get 0.
      const bool ragged = k0 + kTfK > n;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        p[j][0] = ex2(fmaf(p[j][0], kLog2e, -l0));
        p[j][1] = ex2(fmaf(p[j][1], kLog2e, -l0));
        p[j][2] = ex2(fmaf(p[j][2], kLog2e, -l1));
        p[j][3] = ex2(fmaf(p[j][3], kLog2e, -l1));
        if (ragged) {
          const int key = k0 + 8 * j + 2 * tig;
          if (key >= n) p[j][0] = p[j][2] = 0.f;
          if (key + 1 >= n) p[j][1] = p[j][3] = 0.f;
        }
      }

      // dP = do h^T: 16 queries x 16 keys, over C, the even and odd k steps
      // into two sets of accumulators (four independent chains), added at
      // the end. h[key 8 j + grp][k tig, tig + 4] sits at word (k ^ 4 grp)
      // of its row (the swizzle), so the 32 lanes' reads fall in 32 banks.
      float ds[2][NK][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < NK; ++j) ds[i][j][0] = ds[i][j][1] = ds[i][j][2] = ds[i][j][3] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < DK; ks += 2) {
        Tf32Frag da[2];
        uint32_t bh[2][NK][2], bl[2][NK][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if constexpr (kDoRegs) {
            da[i] = doa[ks + i];
          } else {
            const float* d = dr + 8 * (ks + i);
            da[i] = split_frag(d[0], d[8 * DS], d[4], d[8 * DS + 4]);
          }
          const int col = (8 * (ks + i) + tig) ^ (4 * grp);
#pragma unroll
          for (int j = 0; j < NK; ++j) {
            const int r = (8 * j + grp) * CK;
            bh[i][j][0] = __float_as_uint(hhi[r + col]);
            bh[i][j][1] = __float_as_uint(hhi[r + (col ^ 4)]);
            bl[i][j][0] = __float_as_uint(hlo[r + col]);
            bl[i][j][1] = __float_as_uint(hlo[r + (col ^ 4)]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < NK; ++j) mma1688_tf32(ds[i][j], da[i].lo, bh[i][j][0], bh[i][j][1]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < NK; ++j) mma1688_tf32(ds[i][j], da[i].hi, bl[i][j][0], bl[i][j][1]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < NK; ++j) mma1688_tf32(ds[i][j], da[i].hi, bh[i][j][0], bh[i][j][1]);
        }
      }
      // dS = P (dP - delta)
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        ds[0][j][0] = p[j][0] * ((ds[0][j][0] + ds[1][j][0]) - d0);
        ds[0][j][1] = p[j][1] * ((ds[0][j][1] + ds[1][j][1]) - d0);
        ds[0][j][2] = p[j][2] * ((ds[0][j][2] + ds[1][j][2]) - d1);
        ds[0][j][3] = p[j][3] * ((ds[0][j][3] + ds[1][j][3]) - d1);
      }

      // df += dS g: dS's block kk (keys 8 kk ..) is an A fragment in
      // permuted k order, so g is read at keys 8 kk + 2 tig and + 1. Each
      // block's products are summed apart and added to df by fp32 adds (the
      // tensor cores' sums cut toward zero and would drift over N).
      float tq[NK][NG][4];
      Tf32Frag sa[NK];
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        sa[kk] = split_frag(ds[0][kk][0], ds[0][kk][2], ds[0][kk][1], ds[0][kk][3]);
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          tq[kk][j][0] = tq[kk][j][1] = tq[kk][j][2] = tq[kk][j][3] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        uint32_t bh[NK][2], bl[NK][2];
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          const int r = (8 * kk + 2 * tig) * GS + 8 * j + grp;
          bh[kk][0] = __float_as_uint(ghi[r]);
          bh[kk][1] = __float_as_uint(ghi[r + GS]);
          bl[kk][0] = __float_as_uint(glo[r]);
          bl[kk][1] = __float_as_uint(glo[r + GS]);
        }
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) mma1688_tf32(tq[kk][j], sa[kk].lo, bh[kk][0], bh[kk][1]);
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) mma1688_tf32(tq[kk][j], sa[kk].hi, bl[kk][0], bl[kk][1]);
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) mma1688_tf32(tq[kk][j], sa[kk].hi, bh[kk][0], bh[kk][1]);
      }
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
        for (int j = 0; j < NG; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dfa[j][e] += tq[kk][j][e];
        }
      }
    }
    if (t + 1 < ntiles) {
      cp_async_wait<0>();  // tile t + 1 has landed (this thread's copies)
      split_tile(buf ^ 1);
    }
    __syncthreads();  // tile t is retired and tile t + 1 split, for every warp
    if (t + 2 < ntiles) copy(t + 2, buf);
    cp_async_commit();
  }

  // Sum the two key halves of each query row in a fixed order
  // (deterministic), as the other variants do. The loop's last barrier
  // retired the staged tiles.
  float* xs = reinterpret_cast<float*>(smem_raw) + row_warp * kMerge * 32 + lane;
  if (split == 1) {
#pragma unroll
    for (int j = 0; j < NG; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(4 * j + e) * 32] = dfa[j][e];
    }
  }
  __syncthreads();
  if (split == 1) return;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dfa[j][e] += xs[(4 * j + e) * 32];
  }

  // Epilogue: df, written once in fp32.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + grp + 8 * r;
    if (row >= n) continue;
    float* frow = df + b * st.o0_sb + row * st.o0_sn;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int col = 8 * j + 2 * tig;
      if (vec && col < cbar) {  // cbar a multiple of 4: col + 1 < cbar, the pair 8-byte aligned
        *reinterpret_cast<float2*>(frow + col) = make_float2(dfa[j][2 * r], dfa[j][2 * r + 1]);
      } else {
        if (col < cbar) frow[col] = dfa[j][2 * r];
        if (col + 1 < cbar) frow[col + 1] = dfa[j][2 * r + 1];
      }
    }
  }
}

template <int CB, int CK>
cudaError_t launch_dq_tf32(const void* const* in, void* df, int batch, int n, int cbar, int c,
                           const Strides& st, bool vec, cudaStream_t stream) {
  const dim3 grid((n + kMmaKeys - 1) / kMmaKeys, batch);
  constexpr size_t smem = dq_tf32_smem_bytes<CB, CK>();  // 38 KB at cbar 8, C 64
  auto kernel = flash_attn_dq_tf32_kernel<CB, CK>;
  if (smem > 48 * 1024) {  // up to 195 KB at cbar 64, C 256
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
      static_cast<const float*>(in[2]), static_cast<const float*>(in[3]),
      static_cast<const float*>(in[4]), static_cast<const float*>(in[5]),
      static_cast<float*>(df), n, cbar, c, st, vec);
  return cudaGetLastError();
}

template <int CB>
cudaError_t dispatch_dq_tf32(const void* const* in, void* df, int batch, int n, int cbar, int c,
                             const Strides& st, bool vec, cudaStream_t s) {
  if (c <= 64) return launch_dq_tf32<CB, 64>(in, df, batch, n, cbar, c, st, vec, s);
  return launch_dq_tf32<CB, 256>(in, df, batch, n, cbar, c, st, vec, s);
}

cudaError_t dq_tf32(const void* const* in, void* df, int batch, int n, int cbar, int c,
                    const Strides& st, cudaStream_t s) {
  // As dkv_tf32: 16-byte staging copies (4 floats) of g, h (and do at C
  // 256) and paired stores of df need 16-byte aligned rows; other layouts
  // are staged element by element.
  bool vec = cbar % 4 == 0 && c % 4 == 0 && aligned16(df);
  for (int i = 0; i < 4; ++i) vec = vec && aligned16(in[i]);
  const int64_t strides[10] = {st.f_sb, st.f_sn, st.g_sb, st.g_sn, st.h_sb, st.h_sn,
                               st.do_sb, st.do_sn, st.o0_sb, st.o0_sn};
  for (int i = 0; i < 10; ++i) vec = vec && strides[i] % 4 == 0;
  if (cbar <= 8) return dispatch_dq_tf32<8>(in, df, batch, n, cbar, c, st, vec, s);
  if (cbar <= 16) return dispatch_dq_tf32<16>(in, df, batch, n, cbar, c, st, vec, s);
  if (cbar <= 32) return dispatch_dq_tf32<32>(in, df, batch, n, cbar, c, st, vec, s);
  return dispatch_dq_tf32<64>(in, df, batch, n, cbar, c, st, vec, s);
}

cudaError_t check(int dtype, int device, int batch, int n, int cbar, int c) {
  if (batch < 1 || n < 1 || cbar < 1 || c < 1 || batch > 65535 || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  return cudaSetDevice(device);
}

// Past the widths the kernels above hold in registers: flash_wide.cuh.
bool wide(int cbar, int c) { return cbar > kRegCbar || c > kRegC; }

const int64_t* wide_strides(const Strides& st, int64_t (&w)[14]) {
  const int64_t v[14] = {st.f_sb, st.f_sn, st.g_sb, st.g_sn, st.h_sb, st.h_sn, st.do_sb,
                         st.do_sn, st.row_sb, st.o0_sb, st.o0_sn, st.o1_sb, st.o1_sn, 0};
  for (int i = 0; i < 14; ++i) w[i] = v[i];
  return w;
}

// bf16 runs the tensor-core variants, fp32 the TF32 tensor-core ones; past
// the register-held widths flash_wide.cuh's kernels: bf16 its cluster
// variant (wide_bf16_kernel), fp32 its TF32 one. Each writes the variant it
// launches to `variant`.
cudaError_t dq(const void* const* in, void* df, int dtype, int batch, int n, int cbar, int c,
               const Strides& st, cudaStream_t s, int* variant) {
  *variant = dtype == 0 ? flash_mma::kTf32x3
             : wide(cbar, c) ? flash_mma::kTensorCoreCluster : flash_mma::kTensorCore;
  if (wide(cbar, c)) {
    int64_t w[14];
    return flash_wide::launch<flash_wide::kDq>(in, df, nullptr, nullptr, dtype, batch, n, cbar,
                                               c, wide_strides(st, w), s);
  }
  if (dtype == 1) return dq_mma(in, df, batch, n, cbar, c, st, s);
  return dq_tf32(in, df, batch, n, cbar, c, st, s);
}

cudaError_t dkv(const void* const* in, void* dg, void* dh, int dtype, int batch, int n,
                int cbar, int c, const Strides& st, cudaStream_t s, int* variant) {
  *variant = dtype == 0 ? flash_mma::kTf32x3
             : wide(cbar, c) ? flash_mma::kTensorCoreCluster : flash_mma::kTensorCore;
  if (wide(cbar, c)) {
    int64_t w[14];
    return flash_wide::launch<flash_wide::kDkv>(in, dg, dh, nullptr, dtype, batch, n, cbar, c,
                                                wide_strides(st, w), s);
  }
  if (dtype == 1) return dkv_mma(in, dg, dh, batch, n, cbar, c, st, s);
  return dkv_tf32(in, dg, dh, batch, n, cbar, c, st, s);
}

}  // namespace

// dtype: 0 = float32 (the TF32 tensor-core variants, 3xTF32), 1 =
// bfloat16 (the bf16 tensor-core ones). Strides are in elements: batch and row strides of
// f, g, h, do, the batch stride of lse and delta (which share it), then the
// batch and row strides of each output. The last dimension of
// every tensor must be contiguous. Each function launches one kernel on
// `stream`, writes the flash_mma::Variant it launched to `variant`, and
// returns the cudaError_t of cudaGetLastError() after the launch (0 on
// success).
extern "C" int flash_attn_dq(const void* f, const void* g, const void* h, const void* dout,
                             const void* lse, const void* delta, void* df, int dtype,
                             int device, int batch, int n, int cbar, int c, int64_t f_sb,
                             int64_t f_sn, int64_t g_sb, int64_t g_sn, int64_t h_sb,
                             int64_t h_sn, int64_t do_sb, int64_t do_sn, int64_t row_sb,
                             int64_t df_sb, int64_t df_sn, void* stream, int* variant) {
  cudaError_t err = check(dtype, device, batch, n, cbar, c);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* in[6] = {f, g, h, dout, lse, delta};
  const Strides st = {f_sb, f_sn, g_sb, g_sn, h_sb, h_sn, do_sb, do_sn, row_sb,
                      df_sb, df_sn, 0, 0};
  return static_cast<int>(
      dq(in, df, dtype, batch, n, cbar, c, st, static_cast<cudaStream_t>(stream), variant));
}

extern "C" int flash_attn_dkv(const void* f, const void* g, const void* h, const void* dout,
                              const void* lse, const void* delta, void* dg, void* dh,
                              int dtype, int device, int batch, int n, int cbar, int c,
                              int64_t f_sb, int64_t f_sn, int64_t g_sb, int64_t g_sn,
                              int64_t h_sb, int64_t h_sn, int64_t do_sb, int64_t do_sn,
                              int64_t row_sb, int64_t dg_sb, int64_t dg_sn, int64_t dh_sb,
                              int64_t dh_sn, void* stream, int* variant) {
  cudaError_t err = check(dtype, device, batch, n, cbar, c);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* in[6] = {f, g, h, dout, lse, delta};
  const Strides st = {f_sb, f_sn, g_sb, g_sn, h_sb, h_sn, do_sb, do_sn, row_sb,
                      dg_sb, dg_sn, dh_sb, dh_sn};
  return static_cast<int>(
      dkv(in, dg, dh, dtype, batch, n, cbar, c, st, static_cast<cudaStream_t>(stream),
          variant));
}
