// Tensor-core building blocks shared by the flash-attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu), the fused conv (fused_conv.cu)
// and the int8 conv (conv_i8.cu): 16- and 4-byte cp.async staging with
// zero fill, ldmatrix (plain and transposed) from shared memory, the
// warp-level bf16 products mma.sync m16n8k16 and m16n8k8 with fp32
// accumulators, the tf32 product m16n8k8 with the hi/lo split of the
// fp32 variants (3xTF32), and the int8 product m16n8k32 with int32
// accumulators. Plain device functions over PTX; no PyTorch headers.
//
// Fragment layout of mma.sync.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), lane = 4 * grp + tig:
//   A (16 x 16, row-major), 4 regs of 2 bf16: a0 (row grp, cols 2 tig + {0,1}),
//     a1 (row grp + 8, same cols), a2 (row grp, cols 8 + 2 tig + {0,1}),
//     a3 (row grp + 8, cols 8 + 2 tig + {0,1});
//   B (16 x 8, k-major "col"), 2 regs: b0 (k 2 tig + {0,1}, n grp),
//     b1 (k 8 + 2 tig + {0,1}, n grp);
//   C/D (16 x 8, fp32), 4 floats: c0, c1 (row grp, cols 2 tig + {0,1}),
//     c2, c3 (row grp + 8, same cols).
// m16n8k8 takes a0, a1 and b0 alone. The int8 m16n8k32 has the same
// layout by bytes: each register holds 4 int8 values where the bf16 one
// holds 2 (A: a0 row grp, k 4 tig + {0..3}; a1 row grp + 8; a2, a3 the same
// at k 16 + 4 tig; B: b0 k 4 tig + {0..3}, n grp; b1 k 16 + 4 tig), so
// ldmatrix loads its fragments from rows of 32 int8 codes; C/D as above,
// in int32. Two C fragments side by side (16 x 16)
// are, rounded to bf16 in pairs, the A fragment of the next product: the
// probabilities never leave registers.
//
// Fragment layout of mma.sync.m16n8k8 with tf32 operands (PTX ISA,
// "Matrix fragments for mma.m16n8k8", .tf32), one 32-bit element a
// register, which differs from bf16's pairs:
//   A (16 x 8, row-major), 4 regs: a0 (row grp, k tig), a1 (row grp + 8,
//     k tig), a2 (row grp, k tig + 4), a3 (row grp + 8, k tig + 4);
//   B (8 x 8, k-major "col"), 2 regs: b0 (k tig, n grp), b1 (k tig + 4,
//     n grp);
//   C/D as above (c0, c1: row grp, cols 2 tig + {0,1}; c2, c3: row grp + 8).
// So one C fragment (16 x 8) is an A fragment whose k order is permuted:
// a0 = c0, a1 = c2 (k tig <- column 2 tig), a2 = c1, a3 = c3 (k tig + 4 <-
// column 2 tig + 1). The B operand of that product is read in the same
// permuted order: b0 from row 2 tig of the k dimension, b1 from row
// 2 tig + 1. ldmatrix moves 16-bit elements, and its .trans form cannot
// transpose 32-bit ones, so the tf32 kernels read their B operands with
// plain 32-bit shared loads: a tile row stride of (width + 4) words puts
// the 32 lanes' reads of either order (rows grp, k tig and tig + 4; or rows
// 2 tig and 2 tig + 1, column grp) in 32 distinct banks.
//
// 3xTF32: an fp32 x is split into hi = tf32(x) (round to nearest, ties
// away, cvt.rna) and lo = x - hi (exact in fp32, at most 2^-11 |x|) cut to
// tf32 toward zero (its low 13 bits cleared: one integer operation where a
// second cvt.rna took 11 % of the kernels' time, tools/flash_split.py), and
// a product a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi on the
// tensor cores, with fp32 accumulators; the dropped a_lo b_lo and the cut
// of lo leave about 2^-21 of |a b|, against 2^-11 for one TF32 product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_mma {

constexpr float kLog2e = 1.4426950408889634f;

// The variant a flash-attention entry point launched, which it writes to
// its `variant` argument (ops/attention.py's VARIANT_IDS, in this order).
// No kernel runs on the CUDA cores any more; kCudaCore keeps its id so
// that the others keep theirs. kTensorCoreCluster: the bf16 dq and dkv
// past the register-held widths (flash_wide.cuh's wide_bf16_kernel, groups
// of output slices over a thread-block cluster).
enum Variant : int { kCudaCore = 0, kTensorCore = 1, kTf32x3 = 2, kTensorCoreCluster = 3 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; the bytes past `src_bytes`
// (all 16 when it is 0) are written as zeros. Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, asynchronously (through L1); zeros where
// `src_bytes` is 0. Both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `N` of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8 i .. 8 i + 7 give the row addresses of
// matrix i, and each lane receives (row lane / 4, cols 2 (lane % 4) + {0,1})
// of every matrix (with .trans: (rows 2 (lane % 4) + {0,1}, col lane / 4)).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Two matrices: lanes 0-15 give the addresses (the others' are ignored).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a b, 16 x 8 x 16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, 16 x 8 x 8 (a0, a1 of the layout above; one B register).
__device__ __forceinline__ void mma1688(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// d += a b, 16 x 8 x 32, int8 operands, int32 accumulators: exact (no
// saturation; the sums of the int8 convs stay far below 2^31).
__device__ __forceinline__ void mma16832_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, 16 x 8 x 8, tf32 operands (fp32 bit patterns with the low 13
// mantissa bits zero), fp32 accumulators.
__device__ __forceinline__ void mma1688_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 mantissa bits; to nearest, ties away from zero).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 2^-21 of |x|: the high and low tf32 halves.
struct Tf32Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Tf32Split split_tf32(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u};
}

// A fragments (hi and lo) of a tf32 product: a[0..3] as laid out above.
struct Tf32Frag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ Tf32Frag split_frag(float a0, float a1, float a2, float a3) {
  const Tf32Split s0 = split_tf32(a0), s1 = split_tf32(a1), s2 = split_tf32(a2),
                  s3 = split_tf32(a3);
  return {{s0.hi, s1.hi, s2.hi, s3.hi}, {s0.lo, s1.lo, s2.lo, s3.lo}};
}

// d += a b to fp32 accuracy (3xTF32): the two small products first, then
// the large one; b0 and b1 are fp32 values, split here.
__device__ __forceinline__ void mma1688_tf32x3(float (&d)[4], const Tf32Frag& a, float b0,
                                               float b1) {
  const Tf32Split s0 = split_tf32(b0), s1 = split_tf32(b1);
  mma1688_tf32(d, a.lo, s0.hi, s1.hi);
  mma1688_tf32(d, a.hi, s0.lo, s1.lo);
  mma1688_tf32(d, a.hi, s0.hi, s1.hi);
}

// The A fragment of rows [r0, r0 + 16) and k columns [k0, k0 + 8) of a
// row-major fp32 matrix, zero padded, split (loaded once per warp).
__device__ __forceinline__ Tf32Frag load_a_frag_tf32(const float* src, int r0, int k0, int n,
                                                     int width, int64_t sn, int lane) {
  const int row = r0 + lane / 4, k = k0 + lane % 4;
  auto at = [&](int r, int col) { return (r < n && col < width) ? src[r * sn + col] : 0.f; };
  return split_frag(at(row, k), at(row + 8, k), at(row, k + 4), at(row + 8, k + 4));
}

// 2^x on the special-function unit (MUFU.EX2; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 (round to nearest even), `lo` in the low half:
// the element with the lower column index of an mma fragment register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Elements (row, k) and (row, k + 1) of a row-major bf16 matrix as one
// fragment register, zero outside rows [0, n) and columns [0, width).
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* src, int row, int k, int n,
                                              int width, int64_t sn) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  __nv_bfloat162 v;
  v.x = (row < n && k < width) ? src[row * sn + k] : zero;
  v.y = (row < n && k + 1 < width) ? src[row * sn + k + 1] : zero;
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of rows [r0, r0 + 16) and columns [k0, k0 + 16) of a
// row-major bf16 matrix, zero padded (loaded once per warp, from global).
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const __nv_bfloat16* src, int r0,
                                            int k0, int n, int width, int64_t sn, int lane) {
  const int row = r0 + lane / 4, k = k0 + 2 * (lane % 4);
  a[0] = load_pair(src, row, k, n, width, sn);
  a[1] = load_pair(src, row + 8, k, n, width, sn);
  a[2] = load_pair(src, row, k + 8, n, width, sn);
  a[3] = load_pair(src, row + 8, k + 8, n, width, sn);
}

// 16-byte cp.async copies of [ROWS, COLS] tiles of a row-major matrix of
// T (bf16 by default, or fp32) [n, width] (row stride `sn`) into shared
// memory rows of STRIDE elements, zero filled past n and width. A thread
// copies the same column chunk of rows row, row + kRowStep, ...; its
// addresses are set up once, so a tile costs it one 64-bit multiply-add
// and then an add and a copy a chunk, and rows are tested against n only
// in a tile that crosses it. Needs width, sn and c0 multiples of a chunk
// (8 bf16 or 4 fp32 elements) and a 16-byte aligned source.
template <int ROWS, int COLS, int STRIDE, int NTHREADS, typename T = __nv_bfloat16>
struct TileCopier {
  static constexpr int kPerChunk = 16 / sizeof(T);
  static constexpr int kChunks = COLS / kPerChunk;
  static_assert(NTHREADS % kChunks == 0, "a thread keeps one column chunk");
  static constexpr int kRowStep = NTHREADS / kChunks;
  static constexpr int kPerThread = (ROWS + kRowStep - 1) / kRowStep;

  const T* base;  // the matrix: a valid address for zero fills
  const T* src;   // this thread's chunk in row `row` of tile 0
  int64_t step;   // kRowStep rows of the source
  int dst;        // its chunk's offset in a staged tile
  int row;        // its first row of a tile
  int bytes;      // 16, or 0 for a chunk past width

  __device__ __forceinline__ TileCopier(const T* matrix, int c0, int width, int64_t sn,
                                        int tid) {
    const int chunk = tid % kChunks, col = c0 + kPerChunk * chunk;
    row = tid / kChunks;
    bytes = col < width ? 16 : 0;
    base = matrix;
    src = matrix + row * sn + (bytes ? col : 0);
    step = kRowStep * sn;
    dst = row * STRIDE + kPerChunk * chunk;
  }

  // Rows [r0, r0 + ROWS) into tile[ROWS][STRIDE], in the current group.
  __device__ __forceinline__ void copy(T* tile, int r0, int n, int64_t sn) const {
    const T* s = src + r0 * sn;
    const bool whole = r0 + ROWS <= n;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int r = row + k * kRowStep;
      if (ROWS % kRowStep != 0 && r >= ROWS) break;
      const bool in = whole || r0 + r < n;
      cp_async16(tile + dst + k * kRowStep * STRIDE, in ? s + k * step : base, in ? bytes : 0);
    }
  }
};

__device__ __forceinline__ __nv_bfloat16 zero_of(const __nv_bfloat16*) {
  return __float2bfloat16(0.f);
}
__device__ __forceinline__ float zero_of(const float*) { return 0.f; }

// The same tile by element loads and stores, for any width, stride and
// alignment (the slow path of layouts TileCopier does not take).
template <int ROWS, int COLS, int STRIDE, int NTHREADS, typename T>
__device__ __forceinline__ void stage_tile_elements(T* dst, const T* src, int r0, int c0, int n,
                                                    int width, int64_t sn, int tid) {
  for (int i = tid; i < ROWS * COLS; i += NTHREADS) {
    const int r = i / COLS, col = c0 + i % COLS, row = r0 + r;
    dst[r * STRIDE + i % COLS] = (row < n && col < width) ? src[row * sn + col] : zero_of(src);
  }
}

// Stage `ROWS` floats from src[r0 ..] into dst, zero past n (same `vec`
// rule: r0 a multiple of 4 and a 16-byte aligned source).
template <int ROWS, int NTHREADS>
__device__ __forceinline__ void stage_row(float* dst, const float* src, int r0, int n, bool vec,
                                          int tid) {
  if (vec) {
    for (int i = tid; i < ROWS / 4; i += NTHREADS) {
      const int row = r0 + 4 * i;
      const int bytes = row + 4 <= n ? 16 : (row < n ? 4 * (n - row) : 0);
      cp_async16(dst + 4 * i, bytes > 0 ? src + row : src, bytes);
    }
  } else {
    for (int i = tid; i < ROWS; i += NTHREADS) dst[i] = r0 + i < n ? src[r0 + i] : 0.f;
  }
}

}  // namespace flash_mma
