// Single-head flash-attention backward, dq, for [B, S, C] f32 q, k, v and
// the upstream gradient dO, on Hopper's tensor cores with a 3xTF32 split:
//
//   flash_dq_kernel  replaces sgam_neurips22_tpu/ops/attention_pallas.py::_dq_kernel
//
// (dk and dv: flash_attention_dkv.cu, whose design this mirrors with the
// roles of queries and keys swapped.) With logits = scale * (Q K^T) (the
// scale applied after the dot, as the TPU kernel does), P = exp(logits -
// lse) (0 on keys past S), dP = dO V^T, D = rowsum(dO * O) (given,
// computed by the caller) and dS = P * (dP - D):
//   dq = scale * dS K.
// The TPU kernel carried the [rows, C] accumulator in VMEM across its
// sequential key axis. Here a block owns BQ query rows (64 at C <= 256, 32
// at C = 512; Q and dO stay in shared memory, lse and D of its rows in
// registers) and loops over 64-key tiles itself, in two phases a tile:
//   1. logits and dP of the block's rows against the tile, over 64-wide
//      depth slices of K and V: warp w owns 16 query rows and 64 / WPR keys
//      (WPR = warps a 16-row group: 2, or 4 at C = 512). Then dS goes to
//      shared memory ([BQ][64 + 4]): the accumulator layout of mma is not
//      its A-operand layout. P itself is not needed.
//   2. dq += dS K over 32-key row slices of K (16 at C = 512; 8 keys an mma
//      k-step): warp w owns 32 query rows and C / WPC channels (WPC = warps
//      a 32-row group: 4, or 8 at C = 512), so the accumulator is 32 x 64
//      at C = 256 and 512, 64 registers a thread.
// Every product is mma.sync m16n8k8 in 3xTF32 (mma_tf32.cuh). The tensor
// core's f32 accumulation adds an error that grows with the length of the
// sum (the S keys). So the sum has two levels: each key tile's products
// accumulate from zero in a second 64-register fragment, which one f32 add
// a tile folds into dq (the accumulation over S is then S / 64 rounded
// adds, not 3 S / 8 tensor-core accumulations; on an H100 at [16, 4096,
// 256] that cut the error from 37% of the backward gate to 11%, for 2% of
// the time).
// Operands come from shared memory by ldmatrix (the A fragments of Q, dO
// and dS; the B fragments of the K and V depth slices, read as [key][depth])
// or, for the [key][channel] B operand of phase 2, by 32-bit loads, and are
// split in registers. Row strides keep a warp's loads on 32 banks: C + 4
// for Q and dO, 68 for the depth slices and dS (ldmatrix: 8 rows of 16
// bytes each), C + 8 for the row slices.
// The K / V slices stream through a two-stage ring filled by cp.async: slice
// i + 1 loads while slice i is used, and one __syncthreads a slice both
// publishes a slice and frees the other. A phase-1 slice takes half a stage
// each for K and V, a phase-2 slice a whole stage. The slices are as large
// as shared memory allows (6 __syncthreads a 64-key tile at C = 256): the
// kernel ran faster with them than with 32-wide depth slices and 16-key
// row slices (12 a tile), and, unlike dK/dV, it has the registers for them.
// Ragged S: rows past S load as zero (cp.async zero-fill) and are not
// stored; keys past S get P = 0, and query rows past S have dO = 0 and D = 0.
// The scale multiplies the f32 dot with __fmul_rn, so that the compiler
// does not fuse it with the lse subtraction into one FMA.
//
// Bound on the H100 at the training step's shape [16, 4096, 256]: 3
// products of 2*B*S^2*C, 412 GFLOP, which take 6.15 ms as f32 on the CUDA
// cores (67 TFLOP/s) and 2.50 ms as 3xTF32 on the tensor cores (3 x 412
// GFLOP at 495 TFLOP/s dense); the inputs and output move 268 MB, 0.08 ms
// at 3.35 TB/s. So it is compute-bound. As in dK/dV, the work around the
// products (every operand loaded from shared memory and split in each warp
// that uses it) holds it above the tensor-core bound.
// Resources: one 256-thread block an SM (__launch_bounds__(256, 1), up to
// 255 registers a thread); shared memory 215 KiB at C = 256, 205.5 KiB at
// C = 512, above the 48 KB static limit, so every launch raises the
// dynamic limit on the current device. Grid at [16, 4096, 256]: 64 x 16 =
// 1024 blocks; at [16, 256, 512]: 8 x 16 = 128.
#include <cstdint>
#include <cuda_runtime.h>

#include "mma_tf32.cuh"

namespace {

using namespace mma_tf32;

constexpr int THREADS = 256;  // 8 warps
constexpr int BK = 64;        // keys a tile
constexpr int DC = 64;        // depth slice of phase 1
constexpr int LDK1 = DC + 4;  // row stride of a depth slice
constexpr int LDS = BK + 4;   // dS row stride

template <int C>
struct DqTile {
  static constexpr int BQ = C >= 512 ? 32 : 64;  // query rows a block
  static constexpr int DR = C >= 512 ? 16 : 32;  // key rows of a phase-2 slice
  static constexpr int WPR = 8 / (BQ / 16);      // phase 1: warps a 16-row group
  static constexpr int NT1 = BK / 8 / WPR;       // phase-1 n8 tiles a warp
  static constexpr int WPC = 8 / (BQ / 32);      // phase 2: warps a 32-row group
  static constexpr int NT2 = C / 8 / WPC;        // phase-2 n8 tiles a warp
  static constexpr int LDQ = C + 4;              // Q, dO row stride
  static constexpr int LDR = C + 8;              // row-slice stride
  static constexpr int NS1 = C / DC;             // depth slices a tile
  static constexpr int NS = NS1 + BK / DR;       // slices a tile, both phases
  // floats of a ring stage: K and V depth slices, or one K row slice
  static constexpr int STAGE = 2 * BK * LDK1 > DR * LDR ? 2 * BK * LDK1 : DR * LDR;
  static constexpr int SMEM_BYTES = (2 * BQ * LDQ + BQ * LDS + 2 * STAGE) * (int)sizeof(float);
};

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dd,
                float* __restrict__ dq, int S, float scale) {
  using T = DqTile<C>;
  constexpr int BQ = T::BQ, DR = T::DR, WPR = T::WPR, NT1 = T::NT1, WPC = T::WPC, NT2 = T::NT2;
  constexpr int LDQ = T::LDQ, LDR = T::LDR, NS1 = T::NS1, NS = T::NS, STAGE = T::STAGE;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][LDQ]
  float* Os = Qs + BQ * LDQ;                    // dO [BQ][LDQ]
  float* Ss = Os + BQ * LDQ;                    // dS [BQ][LDS]
  float* Ring = Ss + BQ * LDS;                  // [2 stages][STAGE]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r1 = (warp / WPR) * 16;          // phase 1: the warp's 16 query rows
  const int n1 = (warp % WPR) * (BK / WPR);  // and its keys
  const int r2 = (warp / WPC) * 32;          // phase 2: its 32 query rows
  const int c2 = (warp % WPC) * (C / WPC);   // and its channels
  const int q0 = blockIdx.x * BQ;
  const long long base = (long long)blockIdx.y * S * C;
  const float* kb = k + base;
  const float* vb = v + base;
  const int slices = (S + BK - 1) / BK * NS;

  // slice i of the stream: key tile i / NS; in it, j = i % NS < NS1 is
  // depth slice j of the tile's 64 K and V rows, else row slice j - NS1 of K
  auto fetch = [&](int i) {
    const int k0 = i / NS * BK, j = i % NS;
    float* st = Ring + (i & 1) * STAGE;
    if (j < NS1) {
      cp_async_rows2<BK, DC, C, LDK1, THREADS>(st, kb, st + BK * LDK1, vb, k0, j * DC, S);
    } else {
      cp_async_rows<DR, C, C, LDR, THREADS>(st, kb, k0 + (j - NS1) * DR, 0, S);
    }
    cp_async_commit();
  };

  cp_async_rows2<BQ, C, C, LDQ, THREADS>(Qs, q + base, Os, dout + base, q0, 0, S);
  fetch(0);  // one group with Q and dO

  // wait for slice i, publish it, free the other stage and start slice i + 1 there
  auto next = [&](int i) -> const float* {
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < slices) fetch(i + 1);
    return Ring + (i & 1) * STAGE;
  };

  // lse and D of the thread's two phase-1 rows r1 + g and r1 + g + 8
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r1 + g + 8 * h;
    const bool in = row < S;
    lr[h] = in ? lse[(long long)blockIdx.y * S + row] : 0.f;
    dr[h] = in ? dd[(long long)blockIdx.y * S + row] : 0.f;
  }

  float acc[2][NT2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int k0 = 0, i = 0; k0 < S; k0 += BK) {
    // 1. logits and dP of rows r1.. against keys n1.., over depth slices
    float s[NT1][4], dp[NT1][4];
#pragma unroll
    for (int n = 0; n < NT1; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    for (int j = 0; j < NS1; ++j, ++i) {
      const float* ks = next(i);
      const float* vs = ks + BK * LDK1;
#pragma unroll
      for (int kk = 0; kk < DC; kk += 8) {
        uint32_t qbig[4], qsmall[4], obig[4], osmall[4];
        load_a<LDQ>(Qs, r1, j * DC + kk, lane, qbig, qsmall);
        load_a<LDQ>(Os, r1, j * DC + kk, lane, obig, osmall);
#pragma unroll
        for (int n = 0; n < NT1; n += 2) {
          uint32_t kbig[2][2], ksmall[2][2], vbig[2][2], vsmall[2][2];
          load_b2_nk<LDK1>(ks, n1 + 8 * n, kk, lane, kbig, ksmall);
          load_b2_nk<LDK1>(vs, n1 + 8 * n, kk, lane, vbig, vsmall);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mma3(s[n + h], qbig, qsmall, kbig[h], ksmall[h]);
            mma3(dp[n + h], obig, osmall, vbig[h], vsmall[h]);
          }
        }
      }
    }
    // dS = P * (dP - D), P = exp(scale * qk - lse), 0 on keys past S;
    // accumulator lane (g, t) holds rows g, g + 8 and columns 2t, 2t + 1
#pragma unroll
    for (int n = 0; n < NT1; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, col = n1 + 8 * n + 2 * t + e % 2;
        const float p = k0 + col < S ? expf(__fmul_rn(scale, s[n][e]) - lr[h]) : 0.f;
        Ss[(r1 + g + 8 * h) * LDS + col] = p * (dp[n][e] - dr[h]);
      }

    // 2. dq += dS K, DR / 8 k-steps of 8 keys a slice
    float part[2][NT2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[m][n][e] = 0.f;
    for (int j = 0; j < BK / DR; ++j, ++i) {
      const float* rs = next(i);
#pragma unroll
      for (int kk = 0; kk < DR; kk += 8) {
        uint32_t sbig[2][4], ssmall[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) load_a<LDS>(Ss, r2 + 16 * m, j * DR + kk, lane, sbig[m], ssmall[m]);
#pragma unroll
        for (int n = 0; n < NT2; ++n) {
          uint32_t kbig[2], ksmall[2];
          load_b_kn<LDR>(rs + kk * LDR, c2 + 8 * n, g, t, kbig, ksmall);
#pragma unroll
          for (int m = 0; m < 2; ++m) mma3(part[m][n], sbig[m], ssmall[m], kbig, ksmall);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] += part[m][n][e];
  }

#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + r2 + 16 * m + g + 8 * h;
      if (row >= S) continue;
      float* out = dq + base + (long long)row * C + c2 + 2 * t;
#pragma unroll
      for (int n = 0; n < NT2; ++n)
        *reinterpret_cast<float2*>(out + 8 * n) = make_float2(scale * acc[m][n][2 * h], scale * acc[m][n][2 * h + 1]);
    }
}

template <int C>
int launch_dq(const float* q, const float* k, const float* v, const float* dout, const float* lse,
              const float* dd, float* dq, int B, int S, cudaStream_t stream) {
  using T = DqTile<C>;
  // the dynamic shared-memory limit is a property of the function on the
  // current device: set it on every launch, so each device gets it
  cudaError_t rc = cudaFuncSetAttribute(
      flash_dq_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  dim3 grid((S + T::BQ - 1) / T::BQ, B);
  flash_dq_kernel<C><<<grid, THREADS, T::SMEM_BYTES, stream>>>(q, k, v, dout, lse, dd, dq, S, scale_of(C));
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq [B, S, C] f32 row-major, 16-byte aligned; lse and
// dd = rowsum(dout * out) [B, S] f32. C is one of 64, 128, 256, 512
// (cudaErrorInvalidValue otherwise). Everything on `stream`.
extern "C" int flash_attention_dq_launch(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* dd,
                                         void* dq, int B, int S, int C, void* stream) {
  if (B == 0 || S == 0) return 0;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  const float *of = (const float*)dout, *lf = (const float*)lse, *df = (const float*)dd;
  float* gq = (float*)dq;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 64: return launch_dq<64>(qf, kf, vf, of, lf, df, gq, B, S, s);
    case 128: return launch_dq<128>(qf, kf, vf, of, lf, df, gq, B, S, s);
    case 256: return launch_dq<256>(qf, kf, vf, of, lf, df, gq, B, S, s);
    case 512: return launch_dq<512>(qf, kf, vf, of, lf, df, gq, B, S, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
