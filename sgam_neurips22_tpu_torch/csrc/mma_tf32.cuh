// Building blocks of the tensor-core kernels, the attention forward
// (flash_attention_fwd.cu) and backward (flash_attention_dq.cu,
// flash_attention_dkv.cu) and the codeword search (nearest_codeword.cu):
// cp.async copies into shared memory, ldmatrix fragment loads, and
// mma.sync.aligned.m16n8k8 in TF32 with f32 accumulation, split three ways
// to keep f32 accuracy.
//
// The split: x = big + small with big = x rounded to TF32 (to nearest, ties
// away, as cvt.rna.tf32.f32 rounds) and small = x - big, and a*b =
// small(a) big(b) + big(a) small(b) + big(a) big(b); the small*small term
// (2^-22 relative) is dropped. small goes to the tensor core as it is,
// which reads its top 19 bits (a truncation to TF32). The split is ALU work
// in every warp that loads an operand, so it is kept cheap: big is rounded
// with an integer add and mask (cvt.rna gives the same bits, but dQ and
// dK/dV took about 12% longer with it), and small is not rounded again (a
// second rounding was slower and no more accurate). An operand that many
// warps read may be split once and stored as its two halves
// (load_a_presplit).
// tests/test_torch_port_flash_dkv_split.py and test_torch_port_vq_split.py
// emulate this arithmetic on the CPU.
//
// Fragment layouts of m16n8k8 (lane = 4 g + t): A (16 x 8, row-major) lane
// holds [g][t], [g+8][t], [g][t+4], [g+8][t+4]; B (8 x 8) lane holds [t][g],
// [t+4][g]; the accumulator (16 x 8) lane holds rows g, g + 8 and columns
// 2t, 2t + 1. The accumulator layout is not the A layout, so a product that
// feeds the next product as its A operand goes through shared memory.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace mma_tf32 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two 8 x 4-float matrices (the row addresses of lanes 0-15), as ldsm_x4
__device__ __forceinline__ void ldsm_x2(const float* p, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// four 8 x 4-float matrices, one row address a lane (lanes 8m..8m+7: rows 0-7
// of matrix m): lane l gets word l % 4 of row l / 4 of each, in r[m]
__device__ __forceinline__ void ldsm_x4(const float* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !in
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// ROWS x COLS floats of a row-major [S, C] matrix from row r0, column c0,
// into shared memory with row stride LD, by all THREADS threads; rows past
// S are zero-filled
template <int ROWS, int COLS, int C, int LD, int THREADS>
__device__ __forceinline__ void cp_async_rows(float* dst, const float* src, int r0, int c0, int S) {
  for (int x = threadIdx.x; x < ROWS * COLS / 4; x += THREADS) {
    const int r = x / (COLS / 4), c = x % (COLS / 4) * 4;
    const bool in = r0 + r < S;
    cp_async16(dst + r * LD + c, src + (in ? (long long)(r0 + r) * C + c0 + c : 0), in);
  }
}

// the same block of two matrices at once (K and V, Q and dO), sharing the
// offsets: both kernels ran faster with it than with two cp_async_rows
template <int ROWS, int COLS, int C, int LD, int THREADS>
__device__ __forceinline__ void cp_async_rows2(float* dst0, const float* src0, float* dst1, const float* src1,
                                               int r0, int c0, int S) {
  for (int x = threadIdx.x; x < ROWS * COLS / 4; x += THREADS) {
    const int r = x / (COLS / 4), c = x % (COLS / 4) * 4;
    const bool in = r0 + r < S;
    const long long off = in ? (long long)(r0 + r) * C + c0 + c : 0;
    cp_async16(dst0 + r * LD + c, src0 + off, in);
    cp_async16(dst1 + r * LD + c, src1 + off, in);
  }
}

// x rounded to TF32, to nearest with ties away from zero: add half an ulp
// of the 10-bit mantissa to the bits and clear the 13 bits below it
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, the correction terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_big)[4], const uint32_t (&a_small)[4],
                                     const uint32_t (&b_big)[2], const uint32_t (&b_small)[2]) {
  mma(d, a_small, b_big[0], b_big[1]);
  mma(d, a_big, b_small[0], b_small[1]);
  mma(d, a_big, b_big[0], b_big[1]);
}

// A fragment (16 x 8, row-major) of rows r0.., columns c0.. of a row-major
// shared array
template <int LD>
__device__ __forceinline__ void load_a(const float* s, int r0, int c0, int lane, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  uint32_t x[4];
  ldsm_x4(s + (r0 + lane % 8 + lane / 8 % 2 * 8) * LD + c0 + lane / 16 * 4, x);
#pragma unroll
  for (int e = 0; e < 4; ++e) split(__uint_as_float(x[e]), big[e], small[e]);
}

// the same A fragment from two arrays that hold the operand's TF32 big and
// small halves already
template <int LD>
__device__ __forceinline__ void load_a_presplit(const float* big_s, const float* small_s, int r0, int c0, int lane,
                                                uint32_t (&big)[4], uint32_t (&small)[4]) {
  const int off = (r0 + lane % 8 + lane / 8 % 2 * 8) * LD + c0 + lane / 16 * 4;
  ldsm_x4(big_s + off, big);
  ldsm_x4(small_s + off, small);
}

// B fragment (8 x 8) of one n8 tile with B[k][n] = s[n0 + n][k0 + k]
template <int LD>
__device__ __forceinline__ void load_b_nk(const float* s, int n0, int k0, int lane, uint32_t (&big)[2],
                                          uint32_t (&small)[2]) {
  uint32_t x[2];
  ldsm_x2(s + (n0 + lane % 8) * LD + k0 + lane / 8 % 2 * 4, x);
#pragma unroll
  for (int e = 0; e < 2; ++e) split(__uint_as_float(x[e]), big[e], small[e]);
}

// B fragments (8 x 8) of two n8 tiles with B[k][n] = s[n0 + n][k0 + k]:
// tile 0 in [0][0..1], tile 1 in [1][0..1]
template <int LD>
__device__ __forceinline__ void load_b2_nk(const float* s, int n0, int k0, int lane, uint32_t (&big)[2][2],
                                           uint32_t (&small)[2][2]) {
  uint32_t x[4];
  ldsm_x4(s + (n0 + lane % 8 + lane / 16 * 8) * LD + k0 + lane / 8 % 2 * 4, x);
#pragma unroll
  for (int e = 0; e < 4; ++e) split(__uint_as_float(x[e]), big[e / 2][e % 2], small[e / 2][e % 2]);
}

// B fragment (8 x 8) with B[k][n] = s[k][n0 + n]; lane (g, t) reads row t,
// column g: with LD = C + 8 a warp's loads hit 32 banks (8t + g)
template <int LD>
__device__ __forceinline__ void load_b_kn(const float* s, int n0, int g, int t, uint32_t (&big)[2],
                                          uint32_t (&small)[2]) {
  const float* p = s + t * LD + n0 + g;
  split(p[0], big[0], small[0]);
  split(p[4 * LD], big[1], small[1]);
}

// f32(1/sqrt(C)), as JAX rounds its Python-float scale
inline float scale_of(int C) { return (float)(1.0 / std::sqrt((double)C)); }

}  // namespace mma_tf32
