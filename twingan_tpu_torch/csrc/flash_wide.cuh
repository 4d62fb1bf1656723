// SAGAN flash attention at any width: the forward (B1) and the two
// backward kernels (B2 dq, B3 dkv) for cbar above 64 or, in the backward
// and the fp32 forward, C above 256, the widths past what the kernels of
// flash_attn_fwd.cu and flash_attn_bwd.cu hold in registers. Those take
// f's or g's A fragment, and dq's do or dkv's h, whole into registers, with
// their cbar- and C-wide accumulators; here every operand is cut into
// chunks of 64 columns. Included by both sources; no PyTorch headers.
//
// Same functions (see those files): with s = f g^T (no 1/sqrt(d) scale),
//   forward: o = softmax(s) h and lse = logsumexp(s), online over key tiles;
//   dq:      df = ds g;                 dkv: dg = ds^T f, dh = p^T do;
//   p = exp(s - lse), dp = do h^T, ds = p (dp - delta).
//
// Roles. A block owns 64 rows of its own side (queries for the forward
// and dq, keys for dkv), 16 a warp, and one slice of 64 output columns
// (blockIdx.z): o's columns of h; df's of cbar; dkv's z < ceil(cbar / 64)
// take dg's columns, the others dh's. It loops over tiles of 64 rows of
// the other side, and each tile is a sequence of steps of one 64-column
// chunk each:
//   - the score chunks: s += A B^T with A = the own rows of f (g for
//     dkv) and B = the tile's rows of g (f), chunk kc of cbar;
//   - dq and dkv's dg slices: the dp chunks, dp += A B^T with A = do (h)
//     and B = h (do), chunk kc of C (dkv's dh slices need no dp);
//   - the last step: V, the tile's rows of the output's operand at the
//     block's slice (h for o, g for df, f for dg, do for dh), and the
//     product out += P V with P = the probabilities (forward: the online
//     softmax's; dh), or ds (df, dg).
// Each step stages a [64, 64] chunk of A and one of B (the last step V
// alone) in shared memory, double-buffered, zero filled past N and past
// cbar and C; one barrier a step. Recomputing s (and dp) for every slice of
// the output is the price of any width: a block's registers hold one
// slice. It is also why these kernels take only what the others do not.
//
// Two variants, as in the other kernels: bf16 on the tensor cores
// (`wide_mma_kernel`, mma.sync m16n8k16, fp32 accumulators; P and ds
// rounded to bf16 only as the last product's operand) and fp32 on the CUDA
// cores (`wide_fp32_kernel`, exact fp32, a 16 x 16 thread grid each thread
// owning 4 x 4 of a 64 x 64 tile). Every output element is owned by one
// thread: no atomics, deterministic.
//
// What bounds them: the products. At (B 2, N 256, cbar 256, C 2048) dq
// recomputes s and dp for each of its 4 slices and dkv for each of its 4
// dg slices (its 32 dh slices recompute s only): 2.5 and 5.2 GFLOP against
// the 0.67 and 1.2 GFLOP the functions need. The exponentials (B N^2 a
// slice) are at most 0.2 % of a slice's products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace flash_wide {

using bf16 = __nv_bfloat16;

enum Mode { kFwd = 0, kDq = 1, kDkv = 2 };

constexpr int kRows = 64;   // own rows a block owns
constexpr int kTileN = 64;  // other-side rows a tile
constexpr int kK = 64;      // columns of a chunk and of an output slice
constexpr int kS = kK + 8;  // staged bf16 row stride: ldmatrix reads no bank twice

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

// The output slices of a mode (gridDim.z).
inline int slices(Mode mode, int cbar, int c) {
  const int kcb = (cbar + kK - 1) / kK, kcc = (c + kK - 1) / kK;
  return mode == kFwd ? kcc : mode == kDq ? kcb : kcb + kcc;
}

// What one step stages: chunk `c0` of matrix A's own rows and of matrix B's
// tile rows (a = null on the last step, where B is V).
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

// Step j of a tile for the block's slice z (see the top of the file).
template <Mode M, typename T>
__device__ __forceinline__ Step<T> step_of(const Args<T>& p, int j, int z, int kcb, int kcc,
                                           bool with_dp) {
  const T *own_s = M == kDkv ? p.g : p.f, *other_s = M == kDkv ? p.f : p.g;
  const int64_t own_s_sn = M == kDkv ? p.g_sn : p.f_sn, other_s_sn = M == kDkv ? p.f_sn : p.g_sn;
  if (j < kcb) return {own_s, own_s_sn, p.cbar, other_s, other_s_sn, p.cbar, kK * j, false};
  j -= kcb;
  if (with_dp && j < kcc) {
    if (M == kDq) return {p.dout, p.do_sn, p.c, p.h, p.h_sn, p.c, kK * j, false};
    return {p.h, p.h_sn, p.c, p.dout, p.do_sn, p.c, kK * j, false};
  }
  // The last step: V at the block's slice.
  if (M == kFwd) return {nullptr, 0, 0, p.h, p.h_sn, p.c, kK * z, true};
  if (M == kDq) return {nullptr, 0, 0, p.g, p.g_sn, p.cbar, kK * z, true};
  if (z < kcb) return {nullptr, 0, 0, p.f, p.f_sn, p.cbar, kK * z, true};
  return {nullptr, 0, 0, p.dout, p.do_sn, p.c, kK * (z - kcb), true};
}

// ---------------------------------------------------------------------------
// Tensor-core variant (bf16).

constexpr int kMmaThreads = 32 * kRows / 16;  // 4 warps, 16 own rows each
constexpr size_t kMmaSmem = 2 * 2 * kRows * kS * sizeof(bf16);  // [2 bufs][A, B][64][kS]

// Rows [r0, r0 + 64), columns [c0, c0 + 64) of a row-major [n, width] bf16
// matrix into tile[64][kS], zero filled past n and width: 16-byte cp.async
// copies where `vec` (width, c0 and the row stride multiples of 8, a
// 16-byte aligned matrix), else element by element.
__device__ __forceinline__ void stage_chunk(bf16* tile, const bf16* src, int r0, int c0, int n,
                                            int width, int64_t sn, bool vec, int tid) {
  if (!vec) {
    flash_mma::stage_tile_elements<kRows, kK, kS, kMmaThreads>(tile, src, r0, c0, n, width, sn,
                                                               tid);
    return;
  }
  for (int i = tid; i < kRows * kK / 8; i += kMmaThreads) {
    const int r = i / (kK / 8), col = c0 + 8 * (i % (kK / 8)), row = r0 + r;
    const bool in = row < n && col < width;
    flash_mma::cp_async16(tile + r * kS + 8 * (i % (kK / 8)), in ? src + row * sn + col : src,
                          in ? 16 : 0);
  }
}

// acc (16 rows x 64 columns, 8 blocks of 8) += A B^T over one 64-deep
// chunk: A the warp's 16 rows of the staged [64][kS] tile `at`, B the 64
// rows of `bt`.
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const bf16* at, const bf16* bt,
                                        int warp, int lane) {
  using namespace flash_mma;
  const int mi = lane / 8, mr = lane % 8;
#pragma unroll
  for (int ks = 0; ks < kK / 16; ++ks) {
    uint32_t a[4];  // matrices: (rows +0, k +0), (+8, +0), (+0, +8), (+8, +8)
    ldmatrix_x4(a, at + (16 * warp + 8 * (mi % 2) + mr) * kS + 16 * ks + 8 * (mi / 2));
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // matrices: (B rows +0, k +0), (+0, +8), (+8, +0), (+8, +8)
      uint32_t bf[4];
      ldmatrix_x4(bf, bt + (16 * j + 8 * (mi / 2) + mr) * kS + 16 * ks + 8 * (mi % 2));
      mma16816(acc[2 * j], a, bf[0], bf[1]);
      mma16816(acc[2 * j + 1], a, bf[2], bf[3]);
    }
  }
}

// out (16 x 64) += P V: P's accumulators (16 x 64 tile rows) rounded to bf16
// A fragments in registers, V the staged [64 tile rows][kS] tile, transposed.
__device__ __forceinline__ void mma_pv(float (&out)[8][4], const float (&p)[8][4],
                                       const bf16* vt, int lane) {
  using namespace flash_mma;
  const int mi = lane / 8, mr = lane % 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // matrices: (rows +0, cols +0), (+8, +0), (+0, +8), (+8, +8)
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, vt + (16 * kk + 8 * (mi % 2) + mr) * kS + 16 * j + 8 * (mi / 2));
      mma16816(out[2 * j], pa, bf[0], bf[1]);
      mma16816(out[2 * j + 1], pa, bf[2], bf[3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&a)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
}

template <Mode M>
__global__ void __launch_bounds__(kMmaThreads) wide_mma_kernel(Args<bf16> p, bool vec) {
  using namespace flash_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);  // [2][A, B][kRows][kS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, tig = lane % 4;
  const int b = blockIdx.y, z = blockIdx.z;
  const int r0 = blockIdx.x * kRows;  // the block's first own row
  const int n = p.n;
  const int kcb = (p.cbar + kK - 1) / kK, kcc = (p.c + kK - 1) / kK;
  const bool with_dp = M == kDq || (M == kDkv && z < kcb);
  const int spt = kcb + (with_dp ? kcc : 0) + 1;  // steps a tile
  const int ntiles = (n + kTileN - 1) / kTileN;
  p.f += b * p.f_sb;
  p.g += b * p.g_sb;
  p.h += b * p.h_sb;
  if (M != kFwd) {  // the forward has no do, lse or delta
    p.dout += b * p.do_sb;
    p.lse += b * p.row_sb;
    p.delta += b * p.row_sb;
  }

  // The thread's two own rows (grp and grp + 8 of its warp's 16).
  const int row0 = r0 + 16 * warp + lane / 4, row1 = row0 + 8;
  float l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;  // dq: lse log2e and delta of the rows
  if (M == kDq) {
    l0 = row0 < n ? p.lse[row0] * kLog2e : 0.f;
    l1 = row1 < n ? p.lse[row1] * kLog2e : 0.f;
    d0 = row0 < n ? p.delta[row0] : 0.f;
    d1 = row1 < n ? p.delta[row1] : 0.f;
  }

  float s[8][4], dp[8][4], out[8][4];
  zero(s);
  zero(dp);
  zero(out);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // the forward's softmax

  auto stage = [&](int gs) {
    const int t = gs / spt;
    const Step<bf16> st = step_of<M>(p, gs - t * spt, z, kcb, kcc, with_dp);
    bf16* buf = tiles + (gs & 1) * 2 * kRows * kS;
    if (st.a) stage_chunk(buf, st.a, r0, st.c0, n, st.a_width, st.a_sn, vec, tid);
    stage_chunk(buf + kRows * kS, st.b, t * kTileN, st.c0, n, st.b_width, st.b_sn, vec, tid);
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
    const bf16* at = tiles + (gs & 1) * 2 * kRows * kS;
    const bf16* bt = at + kRows * kS;
    if (j < kcb) {
      mma_abt(s, at, bt, warp, lane);
      continue;
    }
    if (j + 1 < spt) {
      mma_abt(dp, at, bt, warp, lane);
      continue;
    }
    // The last step of the tile: bt holds V.
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
    } else {
      // p = 2^(s log2e - lse log2e), 0 past N; dq's lse is its own rows',
      // dkv's the tile's (the queries, by column).
      const bool dg_slice = M == kDq || with_dp;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int q = o0 + 8 * jj + 2 * tig;
        float lq[2] = {l0, l1}, dq[2] = {d0, d1};
        if (M == kDkv) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            lq[e] = q + e < n ? p.lse[q + e] * kLog2e : 0.f;
            dq[e] = q + e < n && dg_slice ? p.delta[q + e] : 0.f;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // dq: rows e / 2 of the thread; dkv: columns e & 1.
          const float l = M == kDq ? lq[e / 2] : lq[e & 1];
          const float d = M == kDq ? dq[e / 2] : dq[e & 1];
          const float pe = q + (e & 1) < n ? ex2(fmaf(s[jj][e], kLog2e, -l)) : 0.f;
          s[jj][e] = dg_slice ? pe * (dp[jj][e] - d) : pe;
        }
      }
    }
    mma_pv(out, s, bt, lane);
    zero(s);
    zero(dp);
  }

  // Epilogue: the block's slice of the output, written once in bf16.
  bf16* ob = M == kDkv && z >= kcb ? p.out1 + b * p.o1_sb : p.out0 + b * p.o0_sb;
  const int64_t osn = M == kDkv && z >= kcb ? p.o1_sn : p.o0_sn;
  const int width = M == kFwd || (M == kDkv && z >= kcb) ? p.c : p.cbar;
  const int c0 = kK * (M == kDkv && z >= kcb ? z - kcb : z);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    float inv = 1.f;
    if (M == kFwd) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv = 1.f / l;
      if (z == 0 && tig == 0 && row < n) p.lse_out[b * p.lse_sb + row] = m_run[r] + logf(l);
    }
    if (row >= n) continue;
    bf16* orow = ob + row * osn;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = c0 + 8 * jj + 2 * tig;
      const float v0 = out[jj][2 * r] * inv, v1 = out[jj][2 * r + 1] * inv;
      if (vec && col < width) {  // width even: col + 1 < width, the pair 4-byte aligned
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < width) orow[col] = __float2bfloat16(v0);
        if (col + 1 < width) orow[col + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA-core variant (fp32). 256 threads, (tx, ty) = (tid % 16, tid / 16):
// the thread owns rows ty + 16 i and columns tx + 16 j (i, j < 4) of each
// 64 x 64 product, so a warp's reads of a staged row are broadcasts and
// its reads along a row fall in distinct banks (rows padded to 65).

constexpr int kF32Threads = 256;
constexpr int kF32S = kK + 1;
constexpr size_t kF32Smem = 2 * kRows * kF32S * sizeof(float);  // [A or P, B or V][64][65]
static_assert(kF32Smem <= 48 * 1024 && kMmaSmem <= 48 * 1024, "a default launch's shared memory");

// acc += A B^T over one 64-deep chunk of the staged tiles.
__device__ __forceinline__ void fma_abt(float (&acc)[4][4], const float* as, const float* bs,
                                        int tx, int ty) {
#pragma unroll 8
  for (int k = 0; k < kK; ++k) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = as[(ty + 16 * i) * kF32S + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = bs[(tx + 16 * j) * kF32S + k];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
  }
}

template <Mode M>
__global__ void __launch_bounds__(kF32Threads) wide_fp32_kernel(Args<float> p) {
  extern __shared__ float smem_f[];
  float* as = smem_f;               // A's chunk, then P or ds on the last step
  float* bs = smem_f + kRows * kF32S;  // B's chunk, then V
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y, z = blockIdx.z;
  const int r0 = blockIdx.x * kRows;
  const int n = p.n;
  const int kcb = (p.cbar + kK - 1) / kK, kcc = (p.c + kK - 1) / kK;
  const bool with_dp = M == kDq || (M == kDkv && z < kcb);
  const int spt = kcb + (with_dp ? kcc : 0) + 1;
  const int ntiles = (n + kTileN - 1) / kTileN;
  p.f += b * p.f_sb;
  p.g += b * p.g_sb;
  p.h += b * p.h_sb;
  if (M != kFwd) {  // the forward has no do, lse or delta
    p.dout += b * p.do_sb;
    p.lse += b * p.row_sb;
    p.delta += b * p.row_sb;
  }
  float lr[4] = {0.f, 0.f, 0.f, 0.f}, dr[4] = {0.f, 0.f, 0.f, 0.f};  // dq: own rows' lse, delta
  if (M == kDq) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty + 16 * i;
      lr[i] = row < n ? p.lse[row] : 0.f;
      dr[i] = row < n ? p.delta[row] : 0.f;
    }
  }
  float s[4][4] = {}, dp[4][4] = {}, out[4][4] = {};
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m_run[i] = -INFINITY, l_run[i] = 0.f;

  auto load = [&](float* dst, const float* src, int rr, int c0, int width, int64_t sn) {
    for (int i = tid; i < kRows * kK; i += kF32Threads) {
      const int r = i / kK, col = c0 + i % kK, row = rr + r;
      dst[r * kF32S + i % kK] = row < n && col < width ? src[row * sn + col] : 0.f;
    }
  };

  for (int t = 0; t < ntiles; ++t) {
    const int o0 = t * kTileN;
    for (int j = 0; j < spt; ++j) {
      const Step<float> st = step_of<M>(p, j, z, kcb, kcc, with_dp);
      __syncthreads();  // every thread is done with the previous step's tiles
      if (st.a) load(as, st.a, r0, st.c0, st.a_width, st.a_sn);
      load(bs, st.b, o0, st.c0, st.b_width, st.b_sn);
      __syncthreads();
      if (!st.last) {
        if (j < kcb) {
          fma_abt(s, as, bs, tx, ty);
        } else {
          fma_abt(dp, as, bs, tx, ty);
        }
        continue;
      }
      // The last step: P (or ds) into `as`, then out += P V.
      if (M == kFwd) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float mx = m_run[i];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            if (o0 + tx + 16 * jj >= n) s[i][jj] = -INFINITY;
            mx = fmaxf(mx, s[i][jj]);
          }
#pragma unroll
          for (int off = 1; off < 16; off *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float scale = __expf(m_run[i] - mx);
          float tsum = 0.f;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            s[i][jj] = __expf(s[i][jj] - mx);
            tsum += s[i][jj];
            out[i][jj] *= scale;
          }
          l_run[i] = fmaf(l_run[i], scale, tsum);
          m_run[i] = mx;
        }
      } else {
        const bool dg_slice = M == kDq || with_dp;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int q = o0 + tx + 16 * jj;
          const float lq = M == kDkv && q < n ? p.lse[q] : 0.f;
          const float dq = M == kDkv && q < n && dg_slice ? p.delta[q] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pe = q < n ? __expf(s[i][jj] - (M == kDq ? lr[i] : lq)) : 0.f;
            s[i][jj] = dg_slice ? pe * (dp[i][jj] - (M == kDq ? dr[i] : dq)) : pe;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) as[(ty + 16 * i) * kF32S + tx + 16 * jj] = s[i][jj];
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kTileN; ++k) {
        float a[4], v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[(ty + 16 * i) * kF32S + k];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) v[jj] = bs[k * kF32S + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) out[i][jj] = fmaf(a[i], v[jj], out[i][jj]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
      }
    }
  }

  float* ob = M == kDkv && z >= kcb ? p.out1 + b * p.o1_sb : p.out0 + b * p.o0_sb;
  const int64_t osn = M == kDkv && z >= kcb ? p.o1_sn : p.o0_sn;
  const int width = M == kFwd || (M == kDkv && z >= kcb) ? p.c : p.cbar;
  const int c0 = kK * (M == kDkv && z >= kcb ? z - kcb : z);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    float inv = 1.f;
    if (M == kFwd) {
      float l = l_run[i];
#pragma unroll
      for (int off = 1; off < 16; off *= 2) l += __shfl_xor_sync(0xffffffffu, l, off);
      inv = 1.f / l;
      if (z == 0 && tx == 0 && row < n) p.lse_out[b * p.lse_sb + row] = m_run[i] + logf(l);
    }
    if (row >= n) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = c0 + tx + 16 * jj;
      if (col < width) ob[row * osn + col] = out[i][jj] * inv;
    }
  }
}

inline bool aligned16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

// Launch mode M on `dtype`'s variant (0 fp32, 1 bf16); the grid's z is the
// output slices.
template <Mode M>
cudaError_t launch(const void* const* in, void* out0, void* out1, void* lse_out, int dtype,
                   int batch, int n, int cbar, int c, const int64_t* st, cudaStream_t stream) {
  const int z = slices(M, cbar, c);
  if (z > 65535) return cudaErrorInvalidValue;
  const dim3 grid((n + kRows - 1) / kRows, batch, z);
  if (dtype == 0) {
    Args<float> p = {static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
                     static_cast<const float*>(in[2]), static_cast<const float*>(in[3]),
                     static_cast<const float*>(in[4]), static_cast<const float*>(in[5]),
                     static_cast<float*>(out0), static_cast<float*>(out1),
                     static_cast<float*>(lse_out), n, cbar, c,
                     st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                     st[9], st[10], st[11], st[12], st[13]};
    wide_fp32_kernel<M><<<grid, kF32Threads, kF32Smem, stream>>>(p);
    return cudaGetLastError();
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
  wide_mma_kernel<M><<<grid, kMmaThreads, kMmaSmem, stream>>>(p, vec);
  return cudaGetLastError();
}

}  // namespace flash_wide
