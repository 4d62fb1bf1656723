// SAGAN flash attention at any width: the forward (B1) and the two
// backward kernels (B2 dq, B3 dkv) for cbar above 64 or, in the backward
// and the fp32 forward, C above 256, the widths past what the kernels of
// flash_attn_fwd.cu and flash_attn_bwd.cu hold in registers. Those take
// f's or g's A fragment, and dq's do or dkv's h, whole into registers, with
// their cbar- and C-wide accumulators; here every operand is cut into
// chunks of columns. Included by both sources; no PyTorch headers.
//
// Same functions (see those files): with s = f g^T (no 1/sqrt(d) scale),
//   forward: o = softmax(s) h and lse = logsumexp(s), online over key tiles;
//   dq:      df = ds g;                 dkv: dg = ds^T f, dh = p^T do;
//   p = exp(s - lse), dp = do h^T, ds = p (dp - delta).
//
// Three kernels, each owning every output element by one thread or adding
// a cluster's partial outputs in rank order (no atomics, deterministic). A
// block owns 64 rows of its own side (queries for the forward and dq, keys
// for dkv), 16 a warp, and walks tiles of 64 rows of the other side, each a
// sequence of steps of one chunk: the score chunks s += A B^T (A the own
// rows of f, g for dkv; B the tile's rows of g, f), chunk kc of cbar; for
// dq and dkv's dg outputs the dp chunks, dp += A B^T with A = do (h) and B
// = h (do), chunk kc of C; then the output's V steps, the tile's rows of
// the output's operand (h for o, g for df, f for dg, do for dh), out += P V
// with P the probabilities (forward: the online softmax's; dh) or ds (df,
// dg). Chunks are zero filled past N, cbar and C.
//  - bf16 forward (`wide_mma_kernel<kFwd>`, mma.sync m16n8k16, fp32
//    accumulators; P rounded to bf16 only as the last product's operand):
//    one 64-column slice of o a block (blockIdx.z), s recomputed for each;
//    a step stages a [64, 64] chunk of A and one of B (the last step V
//    alone), double-buffered, one barrier a step.
//  - bf16 dq and dkv (`wide_bf16_kernel<Mode, SUBS>`, the same products;
//    P and ds rounded to bf16 only as the last product's operand): the
//    TF32 kernel's plan below in bf16. A block owns a group of up to 4
//    output slices of 64 columns, their accumulators in registers, so that
//    s and dp are computed once a group (dq's and dkv's dg groups hold all
//    of cbar up to 256: at cbar 256, C 2048 the dq products are the 0.67
//    GFLOP the function needs, where one slice a block recomputed s and dp
//    for each of 4: 2.5). A cluster of up to 8 blocks (portable) splits
//    the other side's tiles, each block a contiguous range, and the blocks
//    add their partial outputs in rank order through distributed shared
//    memory; where the other side has one or two tiles (N 16-128, the wide
//    configurations' own shapes, whose few blocks cannot fill the card)
//    the cluster instead splits dp's C-deep chunks, each block adding the
//    blocks' partial dp of every tile in rank order (so that each holds
//    the same dp), and the group's V slices, each written by its block.
//    Five staging buffers (four steps of copies in flight), of unpadded
//    8 KB chunks whose 16-byte pieces are swizzled by row; where the block
//    walks several tiles and they fit in 113 KB (two blocks an SM), the own
//    rows' A chunks are staged once, in the first tile, and stay: every
//    later step copies its B chunk alone.
//  - fp32 on the TF32 tensor cores (`wide_tf32_kernel`, mma.sync m16n8k8
//    tf32, 3xTF32 as in flash_mma.cuh: hi by cvt.rna, lo = x - hi cut to
//    TF32, x_lo y_hi + x_hi y_lo + x_hi y_hi). The same roles and 64-row
//    tiles, with steps of 32- or 64-column chunks:
//      * the products run on the tensor cores, three TF32 products a
//        multiply-add (494.5 TFLOP/s of TF32, against 67 of fp32 FMA);
//      * a block owns a group of output slices of 32 columns, so s and dp
//        are computed once a group, not once a slice: six slices (192
//        columns; 105 KB of shared memory, so that two blocks share an SM),
//        or four of 64 columns where dq's or dkv's dg groups need them to
//        hold all of cbar. The group's accumulators live in shared
//        memory: each tile's products of a slice go to fresh registers,
//        added to them by fp32 adds on the CUDA cores (with the forward's
//        rescale folded in), since the tensor cores' own fp32 sums cut
//        toward zero (PERF.md, Findings). The s and dp chunks likewise: each
//        chunk's products are summed apart and added in fp32;
//      * the other side's tiles are split over the blocks of a cluster as
//        in the bf16 kernel, by the same rule (tile_splits): the fewest
//        splits that fill the card's block slots and leave no block's
//        chain of steps longer than a slot's share (dkv's dg groups, which
//        also take dp, have the longest). The forward merges the blocks'
//        softmax states first: m = max m_k, w_k = 2^((m_k - m) log2e), l =
//        sum w_k l_k, o = sum w_k o_k / l;
//      * each staged operand is split once in shared memory: a thread
//        splits the B (or V) chunk elements it copied, in place (hi over
//        the copy, lo beside it), after its own copies land and before the
//        step's barrier; an A chunk's elements are each read by one warp
//        alone, which splits them as it loads its fragments. P and ds are
//        split once a tile, in registers, into the A fragments of the last
//        product (a C fragment is an A fragment with its k order permuted:
//        V is read at keys 2 tig and 2 tig + 1). Rows are padded to 36
//        words, so that both read orders of the B fragments (rows grp, k
//        tig and tig + 4; rows 2 tig and 2 tig + 1, column grp) hit 32
//        banks.
//
// What bounds them: the products and the bytes are far below the time the
// blocks' serial chains of steps take at these N. At (B 2, N 256, cbar
// 256, C 2048) dq needs 0.67 GFLOP, 0.68 us at bf16's 989 TFLOP/s and 4.1
// us at three TF32 products a multiply-add; its inputs are 4.5 MB in bf16
// (1.4 us at 3.35 TB/s) and 9 MB in fp32. The exponentials (B N^2 a group)
// are under 0.3 % of the products. At a large N the bf16 kernel's copies
// bound it (B 4, N 4096, C 512: 45 % of dkv's time, though blocks of twice
// the rows, half the bytes a product, were no faster: their latency), then
// its V products. tools/flash_split.py --wide times the parts of a step.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "flash_mma.cuh"

namespace flash_wide {
// Internal linkage: each source that includes the header has its own copy
// (and its own function-local statics, such as the shared-memory attribute
// a launcher sets once), however many libraries a process loads.
namespace {

using bf16 = __nv_bfloat16;

enum Mode { kFwd = 0, kDq = 1, kDkv = 2 };

constexpr int kRows = 64;   // own rows a block owns
constexpr int kTileN = 64;  // other-side rows a tile
constexpr int kK = 64;      // columns of a bf16 chunk and of a bf16 output slice
constexpr int kMmaThreads = 32 * kRows / 16;  // 4 warps, 16 own rows each
constexpr int kWarps = kMmaThreads / 32;
constexpr int kMaxSplits = 8;                 // a cluster's blocks (portable)
constexpr size_t kPairSmem = 113 * 1024;      // two blocks an SM up to this much shared memory

// Pointers and element strides. The forward writes o (out0) and lse; dq
// df (out0); dkv dg (out0) and dh (out1).
template <typename T>
struct Args {
  const T *f, *g, *h, *dout;
  const float *lse, *delta;
  T *out0, *out1;
  float* lse_out;
  int n, cbar, c;
  int64_t f_sb, f_sn, g_sb, g_sn, h_sb, h_sn, do_sb, do_sn, row_sb;
  int64_t o0_sb, o0_sn, o1_sb, o1_sn, lse_sb;
};

// What one step stages: chunk `c0` of matrix A's own rows and of matrix B's
// tile rows (a = null on a V step, where B is V).
template <typename T>
struct Step {
  const T* a;
  int64_t a_sn;
  int a_width;
  const T* b;
  int64_t b_sn;
  int b_width;
  int c0;
  bool last;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ void zero(float (&a)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
}

// ---------------------------------------------------------------------------
// A cluster's blocks (shared by the bf16 and the TF32 kernels).

// `p` of the cluster's block `rank` (this block's own when splits is 1).
template <typename T>
__device__ __forceinline__ T* peer(T* p, int rank, int splits) {
  if (splits == 1) return p;
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

__device__ __forceinline__ void cluster_sync(int splits) {
  if (splits > 1) {
    cooperative_groups::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// The cluster's copies of `accs`: block k's at srcs[k], k < splits.
__device__ __forceinline__ void peer_sources(const float4* (&srcs)[kMaxSplits], float4* accs,
                                             int splits) {
#pragma unroll
  for (int k = 0; k < kMaxSplits; ++k) srcs[k] = k < splits ? peer(accs, k, splits) : accs;
}

// Unit u (a float4) of every block's copy, the loads issued together
// (unrolled to the largest cluster), not one after another.
__device__ __forceinline__ void peer_units(float4 (&a)[kMaxSplits],
                                           const float4* const (&srcs)[kMaxSplits], int u,
                                           int splits) {
#pragma unroll
  for (int k = 0; k < kMaxSplits; ++k) {
    if (k < splits) a[k] = srcs[k][u];
  }
}

// The fewest splits of the other side's tiles (a power of two, at most
// `cap`) that fill every block slot of the card and leave no block's chain
// of steps longer than a slot's share of them all: `blocks` before the
// split, `spt_max` the longest chain of steps a tile, `steps` the launch's.
inline int tile_splits(int64_t blocks, int ntiles, int spt_max, int64_t steps, int64_t slots,
                       int cap) {
  int splits = 1;
  while (2 * splits <= cap &&
         (blocks * splits < slots ||
          static_cast<int64_t>(spt_max) * cdiv(ntiles, splits) * slots > steps)) {
    splits *= 2;
  }
  return splits;
}

// A launch of kMmaThreads a block whose blocks form clusters of `splits`
// along x (none at 1).
inline cudaLaunchConfig_t cluster_config(dim3 grid, size_t smem, int splits, cudaStream_t stream,
                                         cudaLaunchAttribute (&attr)[1]) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kMmaThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;  // a row block's splits, one cluster
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = splits > 1 ? 1 : 0;
  return config;
}

// ---------------------------------------------------------------------------
// bf16 tensor-core building blocks.

// A staged chunk holds 64 rows of 64 bf16 columns in one of two layouts:
// the forward's, rows padded to kS elements, or the dq and dkv
// kernel's (SWZ), unpadded 8 KB chunks whose 16-byte pieces are swizzled,
// piece c of row r at piece c ^ (r % 8). Either way the 8 rows an ldmatrix
// matrix (or 8 threads' copies) touch at one piece hit 8 distinct sets of
// banks.
constexpr int kS = kK + 8;
constexpr int kPadElems = kRows * kS;  // a padded chunk (the forward)
constexpr int kChunkElems = kRows * kK;  // a swizzled chunk
constexpr int kChunkBytes = kChunkElems * static_cast<int>(sizeof(bf16));
constexpr size_t kMmaSmem = 2 * 2 * kPadElems * sizeof(bf16);  // the forward's [2 bufs][A, B]
static_assert(kMmaSmem <= 48 * 1024, "a default launch's shared memory");

// The element offset of (row, col) in a staged chunk: col's piece (col / 8)
// and its element.
template <bool SWZ>
__device__ __forceinline__ int chunk_at(int row, int col) {
  if constexpr (SWZ) return row * kK + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
  return row * kS + col;
}

// Rows [r0, r0 + ROWS), columns [c0, c0 + 64) of a row-major [n, width]
// bf16 matrix into a staged chunk (ROWS / 64 stacked, by THREADS threads),
// zero filled past n and width: 16-byte cp.async copies where `vec`
// (width, c0 and the row stride multiples of 8, a 16-byte aligned matrix),
// else element by element.
template <bool SWZ, int ROWS = kRows, int THREADS = kMmaThreads>
__device__ __forceinline__ void stage_chunk(bf16* tile, const bf16* src, int r0, int c0, int n,
                                            int width, int64_t sn, bool vec, int tid) {
  if (!vec) {
    for (int i = tid; i < ROWS * kK; i += THREADS) {
      const int r = i / kK, col = c0 + i % kK, row = r0 + r;
      tile[chunk_at<SWZ>(r, i % kK)] =
          row < n && col < width ? src[row * sn + col] : __float2bfloat16(0.f);
    }
    return;
  }
  for (int i = tid; i < ROWS * kK / 8; i += THREADS) {
    const int r = i / (kK / 8), piece = 8 * (i % (kK / 8)), col = c0 + piece, row = r0 + r;
    const bool in = row < n && col < width;
    flash_mma::cp_async16(tile + chunk_at<SWZ>(r, piece), in ? src + row * sn + col : src,
                          in ? 16 : 0);
  }
}

// The ldmatrix rows of a lane are mr (lane % 8) modulo 8, so a swizzled
// piece p of them sits at p ^ mr: the element offset of piece p in a row.
template <bool SWZ>
__device__ __forceinline__ int piece_at(int p, int mr) {
  return (SWZ ? p ^ mr : p) << 3;
}

// acc (16 rows x 64 columns, 8 blocks of 8) += A B^T over one 64-deep
// chunk: A the warp's 16 rows of the staged chunk `at`, B the 64 rows of
// `bt`.
template <bool SWZ>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const bf16* at, const bf16* bt,
                                        int warp, int lane) {
  using namespace flash_mma;
  constexpr int kStride = SWZ ? kK : kS;
  const int mi = lane / 8, mr = lane % 8;
  const bf16* arow = at + (16 * warp + 8 * (mi % 2) + mr) * kStride;
  const bf16* brow = bt + (8 * (mi / 2) + mr) * kStride;
#pragma unroll
  for (int ks = 0; ks < kK / 16; ++ks) {
    uint32_t a[4];  // matrices: (rows +0, k +0), (+8, +0), (+0, +8), (+8, +8)
    ldmatrix_x4(a, arow + piece_at<SWZ>(2 * ks + mi / 2, mr));
    const bf16* bk = brow + piece_at<SWZ>(2 * ks + mi % 2, mr);
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // matrices: (B rows +0, k +0), (+0, +8), (+8, +0), (+8, +8)
      uint32_t bf[4];
      ldmatrix_x4(bf, bk + 16 * j * kStride);
      mma16816(acc[2 * j], a, bf[0], bf[1]);
      mma16816(acc[2 * j + 1], a, bf[2], bf[3]);
    }
  }
}

// P's accumulators (16 rows x 64 tile rows) rounded to bf16, as the A
// fragments of the four 16-deep k steps of the last product.
__device__ __forceinline__ void p_frags(uint32_t (&pa)[4][4], const float (&p)[8][4]) {
  using flash_mma::pack_bf16;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

// out (16 x 64) += P V: P as A fragments (p_frags), V the staged chunk of
// 64 tile rows, transposed.
template <bool SWZ>
__device__ __forceinline__ void mma_pv(float (&out)[8][4], const uint32_t (&pa)[4][4],
                                       const bf16* vt, int lane) {
  using namespace flash_mma;
  constexpr int kStride = SWZ ? kK : kS;
  const int mi = lane / 8, mr = lane % 8;
  const bf16* vrow = vt + (8 * (mi % 2) + mr) * kStride;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // matrices: (rows +0, cols +0), (+8, +0), (+0, +8), (+8, +8)
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, vrow + 16 * kk * kStride + piece_at<SWZ>(2 * j + mi / 2, mr));
      mma16816(out[2 * j], pa[kk], bf[0], bf[1]);
      mma16816(out[2 * j + 1], pa[kk], bf[2], bf[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward: one 64-column slice of o a block (blockIdx.z).

// Step j of a tile for the block's slice z: the score chunks of cbar, then
// V, h at the slice.
__device__ __forceinline__ Step<bf16> fwd_step(const Args<bf16>& p, int j, int z, int kcb) {
  if (j < kcb) return {p.f, p.f_sn, p.cbar, p.g, p.g_sn, p.cbar, kK * j, false};
  return {nullptr, 0, 0, p.h, p.h_sn, p.c, kK * z, true};
}

template <Mode M>
__global__ void __launch_bounds__(kMmaThreads) wide_mma_kernel(Args<bf16> p, bool vec) {
  static_assert(M == kFwd, "the bf16 dq and dkv run wide_bf16_kernel");
  using namespace flash_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);  // [2][A, B] padded chunks

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, tig = lane % 4;
  const int b = blockIdx.y, z = blockIdx.z;
  const int r0 = blockIdx.x * kRows;  // the block's first own row
  const int n = p.n;
  const int kcb = cdiv(p.cbar, kK);
  const int spt = kcb + 1;  // steps a tile
  const int ntiles = cdiv(n, kTileN);
  p.f += b * p.f_sb;
  p.g += b * p.g_sb;
  p.h += b * p.h_sb;

  // The thread's two own rows (grp and grp + 8 of its warp's 16).
  const int row0 = r0 + 16 * warp + lane / 4, row1 = row0 + 8;
  float s[8][4], out[8][4];
  zero(s);
  zero(out);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // the online softmax

  auto stage = [&](int gs) {
    const int t = gs / spt;
    const Step<bf16> st = fwd_step(p, gs - t * spt, z, kcb);
    bf16* buf = tiles + (gs & 1) * 2 * kPadElems;
    if (st.a) stage_chunk<false>(buf, st.a, r0, st.c0, n, st.a_width, st.a_sn, vec, tid);
    stage_chunk<false>(buf + kPadElems, st.b, t * kTileN, st.c0, n, st.b_width, st.b_sn, vec,
                       tid);
  };

  const int total = ntiles * spt;
  stage(0);
  cp_async_commit();
  for (int gs = 0; gs < total; ++gs) {
    cp_async_wait<0>();  // step gs has landed (this thread's copies)
    __syncthreads();     // ... and every thread's; step gs - 1 is retired
    if (gs + 1 < total) stage(gs + 1);
    cp_async_commit();
    const int t = gs / spt, j = gs - t * spt;
    const bf16* at = tiles + (gs & 1) * 2 * kPadElems;
    const bf16* bt = at + kPadElems;
    if (j < kcb) {
      mma_abt<false>(s, at, bt, warp, lane);
      continue;
    }
    // The last step of the tile: bt holds V. Online softmax: keys past N
    // score -inf; the tile's first key is inside N, so the new max is
    // finite.
    const int o0 = t * kTileN;  // the tile's first key
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (o0 + 8 * jj + 2 * tig + (e & 1) >= n) s[jj][e] = -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[jj][e]);
      }
    }
    float scale[2], msc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      scale[r] = ex2((m_run[r] - mx[r]) * kLog2e);
      msc[r] = mx[r] * kLog2e;
      m_run[r] = mx[r];
    }
    float tsum[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[jj][e] = ex2(fmaf(s[jj][e], kLog2e, -msc[e / 2]));
        tsum[e / 2] += s[jj][e];
        out[jj][e] *= scale[e / 2];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = fmaf(l_run[r], scale[r], tsum[r]);
    uint32_t pa[4][4];
    p_frags(pa, s);
    mma_pv<false>(out, pa, bt, lane);
    zero(s);
  }

  // Epilogue: the block's slice of o, written once in bf16, and lse.
  bf16* ob = p.out0 + b * p.o0_sb;
  const int c0 = kK * z;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    if (z == 0 && tig == 0 && row < n) p.lse_out[b * p.lse_sb + row] = m_run[r] + logf(l);
    if (row >= n) continue;
    bf16* orow = ob + row * p.o0_sn;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = c0 + 8 * jj + 2 * tig;
      const float v0 = out[jj][2 * r] * inv, v1 = out[jj][2 * r + 1] * inv;
      if (vec && col < p.c) {  // C even: col + 1 < C, the pair 4-byte aligned
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < p.c) orow[col] = __float2bfloat16(v0);
        if (col + 1 < p.c) orow[col + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dq and dkv: a group of up to kBf16Subs output slices of 64 columns
// (accumulators in registers), the other side's tiles or dp's chunks split
// over a cluster (the launch's plan, plan_bf16).

constexpr int kBf16Subs = 4;    // slices of the widest group (256 columns)
constexpr int kBf16Stages = 5;  // staging buffers: four steps of copies in flight
constexpr int kXUnits = kWarps * 8 * 32;  // float4 units of a block's 16 x 64 fp32 tile a warp
constexpr int kUnitBytes = kXUnits * static_cast<int>(sizeof(float4));  // a slice's accumulators, or dp

// The kernel instance (SUBS) that holds a group of `subs` slices.
__host__ __device__ constexpr int subs_instance(int subs) {
  return subs <= 1 ? 1 : subs <= 2 ? 2 : kBf16Subs;
}

// Shared memory of a block, in bytes: the B chunks' ring; the A chunks'
// ring, or with `a_res` the own rows' kcb + kcc chunks, resident; then,
// where the cluster splits dp (`dsplit`), the warps' partial dp and the
// block's share of the cluster's sums. The epilogue's accumulators
// ([warps][kBf16Subs][8][32] float4) reuse the front.
__host__ __device__ constexpr int bf16_xbuf_offset(bool a_res, int kcb, int kcc) {
  return (kBf16Stages + (a_res ? kcb + kcc : kBf16Stages)) * kChunkBytes > kBf16Subs * kUnitBytes
             ? (kBf16Stages + (a_res ? kcb + kcc : kBf16Stages)) * kChunkBytes
             : kBf16Subs * kUnitBytes;
}

__host__ __device__ constexpr size_t bf16_smem(bool a_res, bool dsplit, int kcb, int kcc) {
  return static_cast<size_t>(bf16_xbuf_offset(a_res, kcb, kcc)) + (dsplit ? 2 * kUnitBytes : 0);
}

// One block's group: `subs` slices of 64 columns of the output from column
// c0 of a `width`-wide output (DP: df's of cbar, or dkv's dg, with dp;
// else dh's of C), NS slices at most. Without `dsplit` the block (rank k
// of the cluster) takes the other side's tiles [k ntiles / splits, (k + 1)
// ntiles / splits) and every slice of the group, and the ranks' partial
// outputs are added in rank order at the end. With `dsplit` every rank
// takes every tile, dp's chunks [k kcc / splits, (k + 1) kcc / splits) and
// the group's slices [k nsub / splits, (k + 1) nsub / splits): at the end
// of a tile's products the ranks' partial dp are added in rank order (each
// rank with slices gets the same dp), and each rank writes its own slices.
// With `a_res` the own rows' A chunks are staged in the first tile only,
// into slots of their own. A tile's steps: the score chunks, dp's chunks,
// then one V step a slice (unrolled, so that each slice's accumulators
// stay registers).
template <Mode M, bool DP, int NS>
__device__ __forceinline__ void bf16_group(Args<bf16> p, unsigned char* smem_raw, int splits,
                                           int subs, int c0, int width, bool dsplit, bool a_res,
                                           bool vec) {
  using namespace flash_mma;
  constexpr int S = kBf16Stages;
  const int n = p.n, kcb = cdiv(p.cbar, kK), kcc = cdiv(p.c, kK);
  bf16* ring_b = reinterpret_cast<bf16*>(smem_raw);  // [S] staged chunks
  bf16* area_a = ring_b + S * kChunkElems;            // the A ring, or the resident chunks
  // With dsplit: this rank's partial dp ([warps][8][32] float4), and its
  // share of the cluster's sums at the same units.
  float4* xbuf = reinterpret_cast<float4*>(smem_raw + bf16_xbuf_offset(a_res, kcb, kcc));
  float4* xsum = xbuf + kXUnits;
  float4* accs = reinterpret_cast<float4*>(smem_raw);  // the epilogue's [warps][kBf16Subs][8][32]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, tig = lane % 4;
  const int b = blockIdx.y;
  const int rank = blockIdx.x % splits, r0 = (blockIdx.x / splits) * kRows;
  const int gw = min(kK * subs, width - c0), nsub = cdiv(gw, kK);
  const int ntiles = cdiv(n, kTileN);
  // The block's share: tiles [t_begin, t_end), dp chunks [d_begin, d_end),
  // the group's slices [v_begin, v_begin + nv).
  int t_begin = 0, t_end = ntiles, d_begin = 0, d_end = DP ? kcc : 0, v_begin = 0, v_end = nsub;
  if (dsplit) {
    if (DP) {
      d_begin = rank * kcc / splits;
      d_end = (rank + 1) * kcc / splits;
    }
    v_begin = rank * nsub / splits;
    v_end = (rank + 1) * nsub / splits;
  } else {
    t_begin = rank * ntiles / splits;
    t_end = (rank + 1) * ntiles / splits;
  }
  const int nv = v_end - v_begin;
  const int kscore = nv > 0 ? kcb : 0;         // score chunks a tile (none without slices)
  const int kprod = kscore + d_end - d_begin;  // score and dp chunks a tile
  const int spt = kprod + nv;                  // steps a tile
  p.f += b * p.f_sb;
  p.g += b * p.g_sb;
  p.h += b * p.h_sb;
  p.dout += b * p.do_sb;
  p.lse += b * p.row_sb;
  p.delta += b * p.row_sb;
  // The chunks' matrices: the scores' (A own rows, B tile rows), dp's, V.
  const bf16 *own_s = M == kDkv ? p.g : p.f, *other_s = M == kDkv ? p.f : p.g;
  const int64_t own_s_sn = M == kDkv ? p.g_sn : p.f_sn, other_s_sn = M == kDkv ? p.f_sn : p.g_sn;
  const bf16 *own_d = M == kDq ? p.dout : p.h, *other_d = M == kDq ? p.h : p.dout;
  const int64_t own_d_sn = M == kDq ? p.do_sn : p.h_sn, other_d_sn = M == kDq ? p.h_sn : p.do_sn;
  const bf16* vm = M == kDq ? p.g : DP ? p.f : p.dout;
  const int64_t v_sn = M == kDq ? p.g_sn : DP ? p.f_sn : p.do_sn;

  // The thread's two own rows (grp and grp + 8 of its warp's 16).
  const int row0 = r0 + 16 * warp + lane / 4, row1 = row0 + 8;
  float l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;  // dq: lse log2e and delta of the rows
  if (M == kDq) {
    l0 = row0 < n ? p.lse[row0] * kLog2e : 0.f;
    l1 = row1 < n ? p.lse[row1] * kLog2e : 0.f;
    d0 = row0 < n ? p.delta[row0] : 0.f;
    d1 = row1 < n ? p.delta[row1] : 0.f;
  }

  float acc[NS][8][4], s[8][4], dp[DP ? 8 : 1][4];
#pragma unroll
  for (int i = 0; i < NS; ++i) zero(acc[i]);
  zero(s);
  if constexpr (DP) zero(dp);
  uint32_t pa[4][4];  // the tile's P or ds as the last product's A fragments

  auto stage = [&](int gs) {
    const int t = t_begin + gs / spt, j = gs % spt, slot = gs % S;
    bf16* bt = ring_b + slot * kChunkElems;
    const int o0 = t * kTileN;  // the tile's first other-side row
    if (j < kprod) {
      const bool score = j < kscore;
      const int col = kK * (score ? j : d_begin + j - kscore), w = score ? p.cbar : p.c;
      if (!a_res || t == t_begin) {
        stage_chunk<true>(area_a + (a_res ? j : slot) * kChunkElems, score ? own_s : own_d, r0,
                          col, n, w, score ? own_s_sn : own_d_sn, vec, tid);
      }
      stage_chunk<true>(bt, score ? other_s : other_d, o0, col, n, w,
                        score ? other_s_sn : other_d_sn, vec, tid);
    } else {
      stage_chunk<true>(bt, vm, o0, c0 + kK * (v_begin + j - kprod), n, width, v_sn, vec, tid);
    }
  };

  const int total = (t_end - t_begin) * spt;
  for (int gs = 0; gs < S - 1; ++gs) {  // the first steps' copies, one group each
    if (gs < total) stage(gs);
    cp_async_commit();
  }
  int gs = 0;  // the step whose chunks come next
  auto next = [&] {
    cp_async_wait<S - 2>();  // this thread's copies of step gs have landed
    __syncthreads();         // ... and every thread's; step gs - 1, whose buffer the next copy takes, is retired
    if (gs + S - 1 < total) stage(gs + S - 1);
    cp_async_commit();
  };
  for (int t = t_begin; t < t_end; ++t) {
    for (int j = 0; j < kprod; ++j, ++gs) {
      next();
      const int slot = gs % S;
      const bf16 *at = area_a + (a_res ? j : slot) * kChunkElems, *bt = ring_b + slot * kChunkElems;
      if (j < kscore) {
        mma_abt<true>(s, at, bt, warp, lane);
      } else {
        if constexpr (DP) mma_abt<true>(dp, at, bt, warp, lane);
      }
    }
    if (kprod == 0) continue;  // with dsplit, a rank of no slices in a group without dp
    if constexpr (DP) {
      // With dp split, the ranks' partial dp added in rank order: each
      // rank sums its share of the units over the cluster, then each rank
      // with slices gathers the sums (two rounds of loads issued together;
      // the next tile's first barrier keeps either buffer until every rank
      // is done with it).
      if (dsplit) {
        const int mine = warp * 8 * 32 + lane;  // unit (warp, jj 0, lane)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          xbuf[mine + jj * 32] = make_float4(dp[jj][0], dp[jj][1], dp[jj][2], dp[jj][3]);
        }
        cooperative_groups::this_cluster().sync();
        for (int u = rank * kXUnits / splits + tid; u < (rank + 1) * kXUnits / splits;
             u += kMmaThreads) {
          const float4* srcs[kMaxSplits];
          peer_sources(srcs, xbuf, splits);
          float4 a[kMaxSplits];
          peer_units(a, srcs, u, splits);
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int k = 0; k < kMaxSplits; ++k) {
            if (k < splits) {
              v.x += a[k].x;
              v.y += a[k].y;
              v.z += a[k].z;
              v.w += a[k].w;
            }
          }
          xsum[u] = v;
        }
        cooperative_groups::this_cluster().sync();
        if (nv > 0) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int u = mine + jj * 32;
            const float4 v = peer(xsum, u * splits / kXUnits, splits)[u];  // its summing rank's
            dp[jj][0] = v.x;
            dp[jj][1] = v.y;
            dp[jj][2] = v.z;
            dp[jj][3] = v.w;
          }
        }
      }
      if (nv == 0) {  // a rank without slices lends its dp chunks alone
        zero(dp);
        continue;
      }
    }
    // p = 2^(s log2e - lse log2e), 0 past N; dq's lse is its own rows',
    // dkv's the tile's (the queries, by column); ds = p (dp - delta).
    const int o0 = t * kTileN;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int q = o0 + 8 * jj + 2 * tig;
      float lq[2] = {l0, l1}, dq[2] = {d0, d1};
      if (M == kDkv) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          lq[e] = q + e < n ? p.lse[q + e] * kLog2e : 0.f;
          dq[e] = q + e < n && DP ? p.delta[q + e] : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // dq: rows e / 2 of the thread; dkv: columns e & 1.
        const float l = M == kDq ? lq[e / 2] : lq[e & 1];
        const float pe = q + (e & 1) < n ? ex2(fmaf(s[jj][e], kLog2e, -l)) : 0.f;
        if constexpr (DP) {
          s[jj][e] = pe * (dp[jj][e] - (M == kDq ? dq[e / 2] : dq[e & 1]));
        } else {
          s[jj][e] = pe;
        }
      }
    }
    p_frags(pa, s);
    zero(s);
    if constexpr (DP) zero(dp);
    // The V steps: slice v_begin + i of the group, out += P V.
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (i < nv) {
        next();
        mma_pv<true>(acc[i], pa, ring_b + (gs % S) * kChunkElems, lane);
        ++gs;
      }
    }
  }

  // Epilogue. The block's accumulators into shared memory (over the
  // staging buffers, once every warp is past its last step), then each
  // output element written once in bf16: without dsplit the block's share
  // of the group, summed over the cluster's blocks in rank order; with
  // dsplit its own slices.
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    if (i < nv) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        accs[((warp * kBf16Subs + i) * 8 + jj) * 32 + lane] =
            make_float4(acc[i][jj][0], acc[i][jj][1], acc[i][jj][2], acc[i][jj][3]);
      }
    }
  }
  const int merge = dsplit ? 1 : splits, mrank = dsplit ? 0 : rank;
  cluster_sync(merge);  // every block's accumulators are in place
  bf16* ob = M == kDkv && !DP ? p.out1 + b * p.o1_sb : p.out0 + b * p.o0_sb;
  const int64_t osn = M == kDkv && !DP ? p.o1_sn : p.o0_sn;
  const float4* srcs[kMaxSplits];
  peer_sources(srcs, accs, merge);
  const int units = kWarps * nv * 8 * 32;
  for (int u = mrank * units / merge + tid; u < (mrank + 1) * units / merge; u += kMmaThreads) {
    const int ln = u % 32, jj = (u / 32) % 8, i = (u / 256) % nv, w = u / (256 * nv);
    const int col = kK * (v_begin + i) + 8 * jj + 2 * (ln % 4), r = 16 * w + ln / 4;
    if (col >= gw) continue;
    float4 a[kMaxSplits];
    peer_units(a, srcs, ((w * kBf16Subs + i) * 8 + jj) * 32 + ln, merge);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k) {
      if (k < merge) {
        v.x += a[k].x;
        v.y += a[k].y;
        v.z += a[k].z;
        v.w += a[k].w;
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {  // rows r and r + 8
      const int row = r0 + r + 8 * hf;
      if (row >= n) continue;
      const float v0 = hf ? v.z : v.x, v1 = hf ? v.w : v.y;
      bf16* o = ob + row * osn + c0 + col;
      if (vec) {  // the group's width even: col + 1 < gw, the pair 4-byte aligned
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      } else {
        o[0] = __float2bfloat16(v0);
        if (col + 1 < gw) o[1] = __float2bfloat16(v1);
      }
    }
  }
  // No block exits while another reads its shared memory (its accumulators,
  // or with dsplit its partial dp and sums).
  if (splits > 1) cooperative_groups::this_cluster().sync();
}

// gridDim: x = 64-row blocks of the own side times `splits` (a cluster
// along x: blockIdx.x % splits is the rank), y = batch, z = output groups:
// df's of cbar (dq); dg's of cbar (`subs` slices each, SUBS at most), then
// dh's of C (`dh_subs`, at most kBf16Subs; no dp) (dkv).
template <Mode M, int SUBS>
__global__ void __launch_bounds__(kMmaThreads, 1)
    wide_bf16_kernel(Args<bf16> p, int splits, int subs, int dh_subs, bool dsplit, bool a_res,
                     bool vec) {
  static_assert(M != kFwd, "the bf16 forward runs wide_mma_kernel");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int z = blockIdx.z, kdg = cdiv(p.cbar, kK * subs);
  if constexpr (M == kDkv) {
    if (z >= kdg) {
      bf16_group<M, false, kBf16Subs>(p, smem_raw, splits, dh_subs, kK * dh_subs * (z - kdg),
                                      p.c, dsplit, a_res, vec);
      return;
    }
  }
  bf16_group<M, true, SUBS>(p, smem_raw, splits, subs, kK * subs * z, p.cbar, dsplit, a_res, vec);
}

// The launch's plan: the slices of a group (dq's and dkv's dg groups hold
// all of cbar up to 256 columns, so that dp is computed once; dkv's dh
// groups up to 256 columns of C), the groups, the cluster's blocks and
// what they split, and whether the A chunks stay resident.
struct Bf16Plan {
  int subs, dh_subs, groups, splits;
  bool dsplit;  // the cluster splits dp's chunks and the V slices, not the tiles
  bool a_res;   // the own rows' A chunks stay in shared memory across tiles
};

template <Mode M>
Bf16Plan plan_bf16(int batch, int n, int cbar, int c, int sms, int max_splits) {
  Bf16Plan plan;
  const int kcb = cdiv(cbar, kK), kcc = cdiv(c, kK);
  plan.subs = min(kcb, kBf16Subs);
  plan.dh_subs = M == kDkv ? min(kcc, kBf16Subs) : 0;
  const int kdg = cdiv(cbar, kK * plan.subs), kdh = M == kDkv ? cdiv(c, kK * plan.dh_subs) : 0;
  plan.groups = kdg + kdh;
  const int rows = cdiv(n, kRows), ntiles = cdiv(n, kTileN);
  const int64_t blocks = static_cast<int64_t>(rows) * batch * plan.groups;
  const int64_t slots = 2 * static_cast<int64_t>(sms);  // every layout fits two blocks an SM
  // One or two tiles (N up to 128) leave too few blocks for the card: the
  // cluster splits dp's chunks instead, as many ways (a power of two, at
  // most a cluster and kcc) as the block slots hold (its steps are few and
  // wait on their copies: two blocks an SM hide them).
  plan.splits = 1;
  if (ntiles <= 2) {
    while (2 * plan.splits <= min(max_splits, kcc) && blocks * 2 * plan.splits <= slots) {
      plan.splits *= 2;
    }
  }
  plan.dsplit = plan.splits > 1;
  if (!plan.dsplit) {
    // Steps a tile of each group: the longest, and the sum over the groups.
    int spt_max = 0;
    int64_t spt_sum = 0;
    for (int z = 0; z < plan.groups; ++z) {
      const bool dh = z >= kdg;
      const int group = kK * (dh ? plan.dh_subs : plan.subs);
      const int width = dh ? c : cbar, c0 = group * (dh ? z - kdg : z);
      const int spt = kcb + (dh ? 0 : kcc) + cdiv(min(group, width - c0), kK);
      spt_max = max(spt_max, spt);
      spt_sum += spt;
    }
    // One slot an SM: a second block on an SM does not shorten the steps,
    // whose products and copies the two share, and each split adds a block's
    // first copies and its share of the merge (ragged N 1000, C 512: dkv
    // 0.0848 ms over 8 splits, 0.0738 over 4; tools/flash_split.py --wide).
    plan.splits = tile_splits(blocks, ntiles, spt_max,
                              static_cast<int64_t>(rows) * batch * ntiles * spt_sum, sms,
                              min(max_splits, ntiles));
  }
  plan.a_res = !plan.dsplit && cdiv(ntiles, plan.splits) >= 2 &&
               bf16_smem(true, false, kcb, kcc) <= kPairSmem;
  return plan;
}

// Whether the card can run a cluster of `config`'s blocks, asked once a
// kernel, cluster and shared-memory size.
template <typename Kernel>
cudaError_t cluster_fits(Kernel kernel, const cudaLaunchConfig_t& config, int splits, bool* fits) {
  struct Seen {
    const void* kernel;
    int splits;
    size_t smem;
    bool fits;
  };
  static std::mutex mutex;
  static Seen seen[64];
  static int count = 0;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mutex);
  for (int i = 0; i < count; ++i) {
    if (seen[i].kernel == key && seen[i].splits == splits &&
        seen[i].smem == config.dynamicSmemBytes) {
      *fits = seen[i].fits;
      return cudaSuccess;
    }
  }
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return err;
  *fits = clusters > 0;
  if (count < 64) seen[count++] = {key, splits, config.dynamicSmemBytes, *fits};
  return cudaSuccess;
}

template <Mode M, int SUBS>
cudaError_t launch_bf16_subs(const Args<bf16>& p, int batch, bool vec, int sms,
                             cudaStream_t stream) {
  auto kernel = wide_bf16_kernel<M, SUBS>;
  // All of the SM's shared memory, so that two blocks of up to kPairSmem share it.
  static const cudaError_t attr = [&] {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kPairSmem));
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(kernel,
                                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                                   cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return attr;
  const int kcb = cdiv(p.cbar, kK), kcc = cdiv(p.c, kK), rows = cdiv(p.n, kRows);
  // A cluster the card cannot hold is planned again with half as many
  // blocks at most, down to none.
  for (int cap = kMaxSplits;; cap /= 2) {
    const Bf16Plan plan = plan_bf16<M>(batch, p.n, p.cbar, p.c, sms, cap);
    if (plan.groups > 65535 || static_cast<int64_t>(rows) * plan.splits > INT32_MAX) {
      return cudaErrorInvalidValue;
    }
    cudaLaunchAttribute cluster[1];
    const cudaLaunchConfig_t config = cluster_config(
        dim3(static_cast<unsigned>(rows * plan.splits), batch, plan.groups),
        bf16_smem(plan.a_res, plan.dsplit, kcb, kcc), plan.splits, stream, cluster);
    if (plan.splits > 1) {
      bool fits = false;
      const cudaError_t err = cluster_fits(kernel, config, plan.splits, &fits);
      if (err != cudaSuccess) return err;
      if (!fits) continue;
    }
    return cudaLaunchKernelEx(&config, kernel, p, plan.splits, plan.subs, plan.dh_subs,
                              plan.dsplit, plan.a_res, vec);
  }
}

template <Mode M>
cudaError_t launch_bf16(const Args<bf16>& p, int batch, bool vec, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // The instance by the dq or dg group's slices (dkv's dh groups take
  // kBf16Subs in every instance).
  const int inst = subs_instance(min(cdiv(p.cbar, kK), kBf16Subs));
  if (inst == 1) return launch_bf16_subs<M, 1>(p, batch, vec, sms, stream);
  if (inst == 2) return launch_bf16_subs<M, 2>(p, batch, vec, sms, stream);
  return launch_bf16_subs<M, kBf16Subs>(p, batch, vec, sms, stream);
}

// ---------------------------------------------------------------------------
// TF32 tensor-core variant (fp32): 4 warps, 16 own rows each; a group of
// output slices of TK columns; the other side's tiles split over a
// cluster. Two layouts, chosen by the launch's plan (plan_tf32):
//  - TK 32, two staging buffers, groups of up to 6 slices (192 columns):
//    105 KB of shared memory, two blocks an SM;
//  - TK 64, three staging buffers, groups of 4 slices (256 columns), for
//    dq and dkv where cbar needs more than 192 columns (dp is then
//    computed once): 225 KB, one block an SM, whose wider chunks halve the
//    steps (and their barriers) a tile.

constexpr int kTf32Threads = kMmaThreads;
constexpr int kGroupCols = 256;   // the widest group's columns
constexpr int kPairCols = 192;    // ... and that of the two-blocks-an-SM layout
constexpr int kStatWords = 2 * kRows + kMaxSplits * kRows + kRows;  // m, l; weights; 1 / l

template <int TK>
struct Tf32Layout {
  static constexpr int kTS = TK + 4;      // staged row stride (words): 32 banks for either read order
  static constexpr int kSubN8 = TK / 8;   // n8 tiles of a slice
  static constexpr int kStages = TK == 32 ? 2 : 3;  // staging buffers
  static constexpr int kStageWords = 3 * kRows * kTS;  // a buffer: A as copied, B hi, B lo
  // Dynamic shared memory of a block whose groups hold `subs` slices: the
  // staging buffers, [4 warps][subs][kSubN8 n8 tiles][32 lanes] float4
  // accumulators, the forward's row statistics.
  static size_t smem(int subs) {
    return (kStages * kStageWords +
            static_cast<size_t>(kTf32Threads / 32) * subs * kSubN8 * 32 * 4 + kStatWords) *
           sizeof(float);
  }
};

// Step j of a tile for a block whose group starts at output column c0:
// the score chunks of cbar (kcb), the dp chunks of C (kcc, with_dp), then
// the group's V slices.
template <Mode M, int kTK>
__device__ __forceinline__ Step<float> tf32_step(const Args<float>& p, int j, int kcb, int kcc,
                                                 bool with_dp, bool dh_group, int c0) {
  const float *own_s = M == kDkv ? p.g : p.f, *other_s = M == kDkv ? p.f : p.g;
  const int64_t own_s_sn = M == kDkv ? p.g_sn : p.f_sn, other_s_sn = M == kDkv ? p.f_sn : p.g_sn;
  if (j < kcb) return {own_s, own_s_sn, p.cbar, other_s, other_s_sn, p.cbar, kTK * j, false};
  j -= kcb;
  if (with_dp && j < kcc) {
    if (M == kDq) return {p.dout, p.do_sn, p.c, p.h, p.h_sn, p.c, kTK * j, false};
    return {p.h, p.h_sn, p.c, p.dout, p.do_sn, p.c, kTK * j, false};
  }
  const int v0 = c0 + kTK * (j - (with_dp ? kcc : 0));
  if (M == kFwd) return {nullptr, 0, 0, p.h, p.h_sn, p.c, v0, true};
  if (M == kDq) return {nullptr, 0, 0, p.g, p.g_sn, p.cbar, v0, true};
  if (!dh_group) return {nullptr, 0, 0, p.f, p.f_sn, p.cbar, v0, true};
  return {nullptr, 0, 0, p.dout, p.do_sn, p.c, v0, true};
}

// Rows [r0, r0 + 64), columns [c0, c0 + kTK) of a row-major fp32 [n,
// width] matrix into tile[64][kTS], zero filled past n and width: 16-byte
// cp.async copies where `vec` (width, the row stride and the matrix
// 16-byte multiples), else element by element. A thread's items are the
// ones split_chunk splits.
template <int kTK, int kTS = kTK + 4>
__device__ __forceinline__ void copy_chunk(float* tile, const float* src, int r0, int c0, int n,
                                           int width, int64_t sn, bool vec, int tid) {
  if (vec) {
    for (int i = tid; i < kRows * kTK / 4; i += kTf32Threads) {
      const int r = i / (kTK / 4), col = c0 + 4 * (i % (kTK / 4)), row = r0 + r;
      const bool in = row < n && col < width;
      flash_mma::cp_async16(tile + r * kTS + 4 * (i % (kTK / 4)),
                            in ? src + row * sn + col : src, in ? 16 : 0);
    }
    return;
  }
  for (int i = tid; i < kRows * kTK; i += kTf32Threads) {
    const int r = i / kTK, col = c0 + i % kTK, row = r0 + r;
    tile[r * kTS + i % kTK] = row < n && col < width ? src[row * sn + col] : 0.f;
  }
}

// This thread's items of a copied chunk, split: hi over the copy, lo into
// `lo` at the same place.
template <int kTK, int kTS = kTK + 4>
__device__ __forceinline__ void split_chunk(uint32_t* hi, uint32_t* lo, bool vec, int tid) {
  using namespace flash_mma;
  if (vec) {
    for (int i = tid; i < kRows * kTK / 4; i += kTf32Threads) {
      const int at = (i / (kTK / 4)) * kTS + 4 * (i % (kTK / 4));
      const float4 v = *reinterpret_cast<const float4*>(hi + at);
      const Tf32Split s0 = split_tf32(v.x), s1 = split_tf32(v.y), s2 = split_tf32(v.z),
                      s3 = split_tf32(v.w);
      *reinterpret_cast<uint4*>(hi + at) = make_uint4(s0.hi, s1.hi, s2.hi, s3.hi);
      *reinterpret_cast<uint4*>(lo + at) = make_uint4(s0.lo, s1.lo, s2.lo, s3.lo);
    }
    return;
  }
  for (int i = tid; i < kRows * kTK; i += kTf32Threads) {
    const int at = (i / kTK) * kTS + i % kTK;
    const Tf32Split s = split_tf32(__uint_as_float(hi[at]));
    hi[at] = s.hi;
    lo[at] = s.lo;
  }
}

// gridDim: x = 64-row blocks of the own side times `splits` (a cluster
// along x: blockIdx.x % splits is the rank, which takes tiles [rank ntiles
// / splits, (rank + 1) ntiles / splits)), y = batch, z = output groups of
// `subs` slices: o's of C (forward); df's of cbar (dq); dg's of cbar, then
// dh's of C (dkv).
template <Mode M, int kTK>
__global__ void __launch_bounds__(kTf32Threads, 1) wide_tf32_kernel(Args<float> p, int splits,
                                                                    int subs, bool vec) {
  using namespace flash_mma;
  using L = Tf32Layout<kTK>;
  constexpr int kTS = L::kTS, kSubN8 = L::kSubN8, kStages = L::kStages;
  constexpr int kStageWords = L::kStageWords;
  extern __shared__ __align__(16) float smem_t[];
  float* stage_buf = smem_t;  // [kStages][A, B hi, B lo][kRows][kTS]
  float4* accs = reinterpret_cast<float4*>(smem_t + kStages * kStageWords);
  float* stats = smem_t + kStages * kStageWords + (kTf32Threads / 32) * subs * kSubN8 * 32 * 4;
  float* weights = stats + 2 * kRows;                 // [splits][kRows]
  float* inv_l = weights + kMaxSplits * kRows;        // [kRows]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, grp = lane / 4, tig = lane % 4;
  const int b = blockIdx.y, z = blockIdx.z;
  const int rank = blockIdx.x % splits, r0 = (blockIdx.x / splits) * kRows;
  const int n = p.n;
  const int group = kTK * subs;  // output columns a group
  const int kcb = cdiv(p.cbar, kTK), kcc = cdiv(p.c, kTK);
  const int kdg = cdiv(p.cbar, group);  // dkv: dg's groups, then dh's
  const bool dh_group = M == kDkv && z >= kdg;
  const bool with_dp = M == kDq || (M == kDkv && !dh_group);
  const int width = M == kFwd || dh_group ? p.c : p.cbar;  // of the group's output
  const int c0 = group * (dh_group ? z - kdg : z);
  const int gw = min(group, width - c0), nsub = cdiv(gw, kTK);
  const int kprod = kcb + (with_dp ? kcc : 0);  // score and dp chunks a tile
  const int spt = kprod + nsub;
  const int ntiles = cdiv(n, kTileN);
  const int t_begin = rank * ntiles / splits, t_end = (rank + 1) * ntiles / splits;
  p.f += b * p.f_sb;
  p.g += b * p.g_sb;
  p.h += b * p.h_sb;
  if (M != kFwd) {  // the forward has no do, lse or delta
    p.dout += b * p.do_sb;
    p.lse += b * p.row_sb;
    p.delta += b * p.row_sb;
  }

  // The thread's two own rows (grp and grp + 8 of its warp's 16).
  const int lr0 = 16 * warp + grp, row0 = r0 + lr0, row1 = row0 + 8;
  float l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;  // dq: lse log2e and delta of the rows
  if (M == kDq) {
    l0 = row0 < n ? p.lse[row0] * kLog2e : 0.f;
    l1 = row1 < n ? p.lse[row1] * kLog2e : 0.f;
    d0 = row0 < n ? p.delta[row0] : 0.f;
    d1 = row1 < n ? p.delta[row1] : 0.f;
  }
  // The warp's accumulators of slice `sub`: its n8 tiles' four values a lane.
  auto acc_of = [&](int sub) { return accs + ((warp * subs + sub) * kSubN8) * 32 + lane; };
  for (int sub = 0; sub < nsub; ++sub) {
#pragma unroll
    for (int jj = 0; jj < kSubN8; ++jj) acc_of(sub)[jj * 32] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float s[8][4], dp[8][4], part[8][4];  // 16 rows x 64 tile columns (s, dp, a chunk's)
  zero(s);
  zero(dp);
  Tf32Frag pa[8];  // P or ds as the last product's A fragments, split
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, scale[2] = {1.f, 1.f};

  auto stage = [&](int gs) {
    const int t = t_begin + gs / spt;
    const Step<float> st = tf32_step<M, kTK>(p, gs % spt, kcb, kcc, with_dp, dh_group, c0);
    float* buf = stage_buf + (gs % kStages) * kStageWords;
    if (st.a) copy_chunk<kTK>(buf, st.a, r0, st.c0, n, st.a_width, st.a_sn, vec, tid);
    copy_chunk<kTK>(buf + kRows * kTS, st.b, t * kTileN, st.c0, n, st.b_width, st.b_sn, vec,
                    tid);
  };

  const int total = (t_end - t_begin) * spt;
  for (int gs = 0; gs < kStages - 1; ++gs) {  // the first steps' copies, one group each
    if (gs < total) stage(gs);
    cp_async_commit();
  }
  for (int gs = 0; gs < total; ++gs) {
    const float* at = stage_buf + (gs % kStages) * kStageWords;
    uint32_t* bh = reinterpret_cast<uint32_t*>(stage_buf + (gs % kStages) * kStageWords +
                                               kRows * kTS);
    uint32_t* bl = bh + kRows * kTS;
    cp_async_wait<kStages - 2>();   // this thread's copies of step gs have landed ...
    split_chunk<kTK>(bh, bl, vec, tid);  // ... and are split in place
    __syncthreads();  // every thread's; step gs - 1, whose buffer the next copy takes, is retired
    if (gs + kStages - 1 < total) stage(gs + kStages - 1);
    cp_async_commit();
    const int t = t_begin + gs / spt, j = gs % spt;
    if (j < kprod) {
      // A score or dp chunk: 16 rows x 64 tile columns over kTK k, into
      // fresh accumulators, then added in fp32.
      zero(part);
#pragma unroll
      for (int ks = 0; ks < kTK / 8; ++ks) {
        const float* a = at + lr0 * kTS + 8 * ks + tig;
        const Tf32Frag af = split_frag(a[0], a[8 * kTS], a[4], a[8 * kTS + 4]);
        uint32_t bhr[8][2], blr[8][2];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {  // b0: k tig, b1: k tig + 4; column grp of tile jj
          const int o = (8 * jj + grp) * kTS + 8 * ks + tig;
          bhr[jj][0] = bh[o];
          bhr[jj][1] = bh[o + 4];
          blr[jj][0] = bl[o];
          blr[jj][1] = bl[o + 4];
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) mma1688_tf32(part[jj], af.lo, bhr[jj][0], bhr[jj][1]);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) mma1688_tf32(part[jj], af.hi, blr[jj][0], blr[jj][1]);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) mma1688_tf32(part[jj], af.hi, bhr[jj][0], bhr[jj][1]);
      }
      if (j < kcb) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[jj][e] += part[jj][e];
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[jj][e] += part[jj][e];
        }
      }
      continue;
    }
    const int sub = j - kprod;
    if (sub == 0) {
      // The tile's probabilities (or ds), once, into A fragments.
      const int o0 = t * kTileN;  // the tile's first other-side row
      if (M == kFwd) {
        // Online softmax. Keys past N score -inf; the tile's first key is
        // inside N, so the new max is finite.
        float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (o0 + 8 * jj + 2 * tig + (e & 1) >= n) s[jj][e] = -INFINITY;
            mx[e / 2] = fmaxf(mx[e / 2], s[jj][e]);
          }
        }
        float msc[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          scale[r] = ex2((m_run[r] - mx[r]) * kLog2e);
          msc[r] = mx[r] * kLog2e;
          m_run[r] = mx[r];
        }
        float tsum[2] = {0.f, 0.f};
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[jj][e] = ex2(fmaf(s[jj][e], kLog2e, -msc[e / 2]));
            tsum[e / 2] += s[jj][e];
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] = fmaf(l_run[r], scale[r], tsum[r]);
      } else {
        // p = 2^(s log2e - lse log2e), 0 past N; dq's lse is its own rows',
        // dkv's the tile's (the queries, by column).
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int q = o0 + 8 * jj + 2 * tig;
          float lq[2] = {l0, l1}, dq[2] = {d0, d1};
          if (M == kDkv) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              lq[e] = q + e < n ? p.lse[q + e] * kLog2e : 0.f;
              dq[e] = q + e < n && with_dp ? p.delta[q + e] : 0.f;
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // dq: rows e / 2 of the thread; dkv: columns e & 1.
            const float l = M == kDq ? lq[e / 2] : lq[e & 1];
            const float d = M == kDq ? dq[e / 2] : dq[e & 1];
            const float pe = q + (e & 1) < n ? ex2(fmaf(s[jj][e], kLog2e, -l)) : 0.f;
            s[jj][e] = with_dp ? pe * (dp[jj][e] - d) : pe;
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) pa[kk] = split_frag(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
      zero(s);
      zero(dp);
    }
    // The slice's product of the tile into fresh accumulators: V read at
    // keys 8 kk + 2 tig and + 1 (the permuted k order of P's fragments).
    zero(part);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t bhr[kSubN8][2], blr[kSubN8][2];
#pragma unroll
      for (int jj = 0; jj < kSubN8; ++jj) {
        const int o = (8 * kk + 2 * tig) * kTS + 8 * jj + grp;
        bhr[jj][0] = bh[o];
        bhr[jj][1] = bh[o + kTS];
        blr[jj][0] = bl[o];
        blr[jj][1] = bl[o + kTS];
      }
#pragma unroll
      for (int jj = 0; jj < kSubN8; ++jj) mma1688_tf32(part[jj], pa[kk].lo, bhr[jj][0], bhr[jj][1]);
#pragma unroll
      for (int jj = 0; jj < kSubN8; ++jj) mma1688_tf32(part[jj], pa[kk].hi, blr[jj][0], blr[jj][1]);
#pragma unroll
      for (int jj = 0; jj < kSubN8; ++jj) mma1688_tf32(part[jj], pa[kk].hi, bhr[jj][0], bhr[jj][1]);
    }
    // Added to the group's accumulators in fp32 (the forward's rescaled).
    float4* acc = acc_of(sub);
#pragma unroll
    for (int jj = 0; jj < kSubN8; ++jj) {
      float4 v = acc[jj * 32];
      v.x = fmaf(v.x, scale[0], part[jj][0]);
      v.y = fmaf(v.y, scale[0], part[jj][1]);
      v.z = fmaf(v.z, scale[1], part[jj][2]);
      v.w = fmaf(v.w, scale[1], part[jj][3]);
      acc[jj * 32] = v;
    }
  }

  // Epilogue. The forward's row states (m, l summed over the row's lanes).
  if (M == kFwd) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (tig == 0) {
        stats[lr0 + 8 * r] = m_run[r];
        stats[kRows + lr0 + 8 * r] = l;
      }
    }
  }
  cluster_sync(splits);  // every block's accumulators and states are in place
  if (M == kFwd && tid < kRows) {  // each row's merge of the blocks' softmax states
    float mm = -INFINITY;
    for (int k = 0; k < splits; ++k) mm = fmaxf(mm, peer(stats, k, splits)[tid]);
    float l = 0.f;
    for (int k = 0; k < splits; ++k) {
      const float* st = peer(stats, k, splits);
      const float w = ex2((st[tid] - mm) * kLog2e);
      weights[k * kRows + tid] = w;
      l = fmaf(w, st[kRows + tid], l);
    }
    inv_l[tid] = 1.f / l;
    if (z == 0 && rank == 0 && r0 + tid < n) p.lse_out[b * p.lse_sb + r0 + tid] = mm + logf(l);
  }
  if (M == kFwd) __syncthreads();
  // The block's share of the accumulators (a float4 is one lane's n8 tile:
  // rows grp and grp + 8, columns 2 tig and + 1), summed over the cluster's
  // blocks in rank order and written once.
  float* ob = dh_group ? p.out1 + b * p.o1_sb : p.out0 + b * p.o0_sb;
  const int64_t osn = dh_group ? p.o1_sn : p.o0_sn;
  const float4* srcs[kMaxSplits];
  peer_sources(srcs, accs, splits);
  const int units = (kTf32Threads / 32) * subs * kSubN8 * 32;
  for (int u = rank * units / splits + tid; u < (rank + 1) * units / splits; u += kTf32Threads) {
    const int ln = u % 32, jj = (u / 32) % kSubN8, sub = (u / (32 * kSubN8)) % subs;
    const int w = u / (32 * kSubN8 * subs);
    const int col = kTK * sub + 8 * jj + 2 * (ln % 4), r = 16 * w + ln / 4;
    if (col >= gw) continue;
    float4 a[kMaxSplits];
    peer_units(a, srcs, u, splits);
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k) {
      if (k < splits) {
        if (M == kFwd) {
          const float w0 = weights[k * kRows + r], w1 = weights[k * kRows + r + 8];
          v[0] = fmaf(w0, a[k].x, v[0]);
          v[1] = fmaf(w0, a[k].y, v[1]);
          v[2] = fmaf(w1, a[k].z, v[2]);
          v[3] = fmaf(w1, a[k].w, v[3]);
        } else {
          v[0] += a[k].x;
          v[1] += a[k].y;
          v[2] += a[k].z;
          v[3] += a[k].w;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + r + 8 * (e / 2), c = col + (e & 1);
      if (row < n && c < gw) ob[row * osn + c0 + c] = M == kFwd ? v[e] * inv_l[r + 8 * (e / 2)] : v[e];
    }
  }
  if (splits > 1) cooperative_groups::this_cluster().sync();  // no block reads another's after
}

// The launch's plan: the chunk width, the slices of a group, the groups,
// and the split of the other side's tiles.
struct Tf32Plan {
  int tk, subs, groups, splits;
};

template <Mode M>
Tf32Plan plan_tf32(int batch, int n, int cbar, int c, int sms) {
  Tf32Plan plan;
  // 192-column groups of 32-column slices let two blocks share an SM; dq
  // and dkv take 256-column groups of 64-column slices where cbar needs
  // more, so that dp is computed once.
  const int widest = M == kFwd ? c : M == kDq ? cbar : max(cbar, c);
  plan.tk = M != kFwd && cbar > kPairCols ? 64 : 32;
  const int kTK = plan.tk;
  const int rows = cdiv(n, kRows), ntiles = cdiv(n, kTileN);
  plan.subs = min(cdiv(widest, kTK), (kTK == 64 ? kGroupCols : kPairCols) / kTK);
  // The forward recomputes only s (cbar of C's columns) a group: at a small
  // N it takes narrower groups, 4 or 2 slices, where 6 leave block slots
  // empty however its tiles are split.
  while (M == kFwd && plan.subs > 2 &&
         static_cast<int64_t>(rows) * batch * cdiv(c, kTK * plan.subs) * min(kMaxSplits, ntiles) <
             2 * static_cast<int64_t>(sms)) {
    plan.subs -= 2;
  }
  const int group = kTK * plan.subs;
  const int kdg = cdiv(cbar, group), kdh = cdiv(c, group);
  plan.groups = M == kFwd ? kdh : M == kDq ? kdg : kdg + kdh;
  // Steps a tile of each group: the longest, and the sum over the groups.
  const int kcb = cdiv(cbar, kTK), kcc = cdiv(c, kTK);
  int spt_max = 0;
  int64_t spt_sum = 0;
  for (int z = 0; z < plan.groups; ++z) {
    const bool dh = M == kFwd || (M == kDkv && z >= kdg);
    const int width = dh ? c : cbar, c0 = group * (M == kDkv && dh ? z - kdg : z);
    const int spt = kcb + (dh ? 0 : kcc) + cdiv(min(group, width - c0), kTK);
    spt_max = max(spt_max, spt);
    spt_sum += spt;
  }
  // The split of the tiles (dkv's dg groups also take dp, and their chains
  // are the longest).
  const size_t smem = kTK == 64 ? Tf32Layout<64>::smem(plan.subs) : Tf32Layout<32>::smem(plan.subs);
  const int64_t slots = static_cast<int64_t>(sms) * (smem <= kPairSmem ? 2 : 1);
  plan.splits = tile_splits(static_cast<int64_t>(rows) * batch * plan.groups, ntiles, spt_max,
                            static_cast<int64_t>(rows) * batch * ntiles * spt_sum, slots,
                            min(kMaxSplits, ntiles));
  return plan;
}

template <Mode M, int kTK>
cudaError_t launch_tf32_layout(const Args<float>& p, int batch, bool vec, const Tf32Plan& plan,
                               cudaStream_t stream) {
  using L = Tf32Layout<kTK>;
  const int rows = cdiv(p.n, kRows);
  if (plan.groups > 65535 || static_cast<int64_t>(rows) * plan.splits > INT32_MAX) {
    return cudaErrorInvalidValue;
  }
  auto kernel = wide_tf32_kernel<M, kTK>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::smem((kTK == 64 ? kGroupCols : kPairCols) / kTK)));
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute cluster[1];
  const cudaLaunchConfig_t config =
      cluster_config(dim3(static_cast<unsigned>(rows * plan.splits), batch, plan.groups),
                     L::smem(plan.subs), plan.splits, stream, cluster);
  return cudaLaunchKernelEx(&config, kernel, p, plan.splits, plan.subs, vec);
}

template <Mode M>
cudaError_t launch_tf32(const Args<float>& p, int batch, bool vec, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const Tf32Plan plan = plan_tf32<M>(batch, p.n, p.cbar, p.c, sms);
  if constexpr (M != kFwd) {  // the forward's groups are all 32-column slices
    if (plan.tk == 64) return launch_tf32_layout<M, 64>(p, batch, vec, plan, stream);
  }
  return launch_tf32_layout<M, 32>(p, batch, vec, plan, stream);
}

inline bool aligned16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

// Launch mode M on `dtype`'s variant (0 fp32: the TF32 one; 1 bf16: the
// tensor-core ones, wide_mma_kernel for the forward, wide_bf16_kernel for
// dq and dkv).
template <Mode M>
cudaError_t launch(const void* const* in, void* out0, void* out1, void* lse_out, int dtype,
                   int batch, int n, int cbar, int c, const int64_t* st, cudaStream_t stream) {
  if (dtype == 0) {
    Args<float> p = {static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
                     static_cast<const float*>(in[2]), static_cast<const float*>(in[3]),
                     static_cast<const float*>(in[4]), static_cast<const float*>(in[5]),
                     static_cast<float*>(out0), static_cast<float*>(out1),
                     static_cast<float*>(lse_out), n, cbar, c,
                     st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                     st[9], st[10], st[11], st[12], st[13]};
    // 16-byte staging copies: every input row 16-byte aligned.
    bool vec = cbar % 4 == 0 && c % 4 == 0;
    for (int i = 0; i < 4; ++i) vec = vec && (!in[i] || aligned16(in[i]));
    for (int i = 0; i < 8; ++i) vec = vec && st[i] % 4 == 0;
    const cudaError_t err = launch_tf32<M>(p, batch, vec, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  Args<bf16> p = {static_cast<const bf16*>(in[0]), static_cast<const bf16*>(in[1]),
                  static_cast<const bf16*>(in[2]), static_cast<const bf16*>(in[3]),
                  static_cast<const float*>(in[4]), static_cast<const float*>(in[5]),
                  static_cast<bf16*>(out0), static_cast<bf16*>(out1),
                  static_cast<float*>(lse_out), n, cbar, c,
                  st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                  st[9], st[10], st[11], st[12], st[13]};
  // 16-byte staging copies and paired stores: every row 16-byte aligned.
  bool vec = cbar % 8 == 0 && c % 8 == 0 && aligned16(out0) && (!out1 || aligned16(out1));
  for (int i = 0; i < 4; ++i) vec = vec && (!in[i] || aligned16(in[i]));
  const int64_t strides[8] = {st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7]};
  for (int i = 0; i < 8; ++i) vec = vec && strides[i] % 8 == 0;
  for (int i = 9; i < 13; ++i) vec = vec && st[i] % 8 == 0;
  if constexpr (M == kFwd) {
    const int z = cdiv(c, kK);  // o's slices
    if (z > 65535) return cudaErrorInvalidValue;
    const dim3 grid(cdiv(n, kRows), batch, z);
    wide_mma_kernel<kFwd><<<grid, kMmaThreads, kMmaSmem, stream>>>(p, vec);
    return cudaGetLastError();
  } else {
    const cudaError_t err = launch_bf16<M>(p, batch, vec, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
}

}  // namespace
}  // namespace flash_wide
