// Single-head flash-attention backward, dk and dv, for [B, S, C] f32 q, k, v
// and the upstream gradient dO, on Hopper's tensor cores with a 3xTF32 split:
//
//   flash_dkv_kernel  replaces sgam_neurips22_tpu/ops/attention_pallas.py::_dkv_kernel
//
// With logits^T = scale * (K Q^T) (the scale applied after the dot, as the
// TPU kernel does), P^T = exp(logits^T - lse[q]) (0 on queries past S),
// dP^T = V dO^T, D = rowsum(dO * O) (given, computed by the caller) and
// dS^T = P^T * (dP^T - D[q]):
//   dv = P^T dO,   dk = scale * dS^T Q.
// The TPU kernel carried the two [rows, C] accumulators in VMEM across its
// sequential query axis. Here a block owns BKV key rows (64 at C <= 256,
// 32 at C = 512; K and V stay in shared memory) and loops over 64-query
// tiles itself, in two phases a tile:
//   1. logits^T and dP^T of the block's rows against the tile, over 32-wide
//      depth slices of Q and dO: warp w owns 16 key rows and 64 / WPR
//      queries (WPR = warps a 16-row group: 2, or 4 at C = 512). Then P^T
//      and dS^T go to shared memory ([BKV][64 + 4] each): the accumulator
//      layout of mma is not its A-operand layout, so the FA2 register reuse
//      does not apply.
//   2. dv += P^T dO and dk += dS^T Q over 8-row slices of Q and dO (one
//      mma k-step): warp w owns 32 key rows and C / WPC channels (WPC =
//      warps a 32-row group: 4, or 8 at C = 512), so each accumulator is
//      32 x 64 at C = 256 and 512, 64 registers a thread. With 32 rows a
//      warp each Q / dO fragment it loads and splits serves twice the
//      products it would with 16 rows x 128 channels.
// Every product is mma.sync.aligned.m16n8k8 in TF32 with f32 accumulation,
// split three ways to keep f32 accuracy (3xTF32, mma_tf32.cuh: a*b =
// small(a) big(b) + big(a) small(b) + big(a) big(b) with big = x rounded
// to TF32 and small = x - big). The port runs in f32 parity mode (no TF32 in
// cuBLAS or cuDNN), and the split's error stays at the f32 level:
// tests/test_torch_port_flash_dkv_split.py emulates it on the CPU, and
// chip_smoke.py holds the kernel to the plain f32 version on the card. The
// tensor core's f32 accumulation adds an error that grows with the length
// of the sum (the S queries), which that emulation does not model.
// Operands come from shared memory by ldmatrix (a 16 x 8 A fragment, or the
// 8 x 8 B fragments of two n8 tiles, in one instruction) or, for the
// [query][channel] B operand of phase 2, by 32-bit loads, and are split in
// registers. Row strides follow the fragment layouts so that a warp's
// loads hit 32 banks: C + 4 for K and V, 36 for the depth slices and 68
// for P^T and dS^T (ldmatrix: 8 rows of 16 bytes each), C + 8 for the row
// slices (lane (g, t) reads row t, column g: bank 8t + g).
// The Q / dO slices stream through a two-stage ring filled by cp.async,
// with lse and D of the tile: slice i + 1 loads while slice i is used, and
// one __syncthreads a slice both publishes a slice and frees the other.
// Ragged S: rows past S load as zero (cp.async zero-fill) and are not
// stored; queries past S get P = 0 (a padded query's lse means nothing).
// The scale multiplies the f32 dot with __fmul_rn, so that the compiler
// does not fuse it with the lse subtraction into one FMA.
//
// Bound on the H100 at the training step's shape [16, 4096, 256]: 4
// products of 2*B*S^2*C, 550 GFLOP, which take 8.21 ms as f32 on the CUDA
// cores (67 TFLOP/s) and 3.33 ms as 3xTF32 on the tensor cores (3 x 550
// GFLOP at 495 TFLOP/s dense); the inputs and outputs move 335 MB, 0.1 ms
// at 3.35 TB/s. So it is compute-bound, and the tensor cores, even at
// three products per f32 product, are the way under the CUDA-core bound.
// What holds it above 3.33 ms is the work around the products: every
// operand element is loaded from shared memory and split in each warp that
// uses it, with 8 warps an SM to hide the latencies.
// Resources: one 256-thread block an SM (__launch_bounds__(256, 1), so
// ptxas may use up to 255 registers a thread; the two accumulators take
// 128); shared memory 200.5 KiB at C = 256, 211.5 KiB at C = 512, above
// the 48 KB static limit, so every launch raises the dynamic limit on the
// current device. Grid at [16, 4096, 256]: 64 x 16 = 1024 blocks, 7.8
// waves over 132 SMs. Later work: wgmma, which reads both operands from
// shared memory (no per-warp loads), with Q and dO split once when staged;
// TMA; larger slices (fewer __syncthreads a tile), which need shared
// memory that padding spends and registers the C = 256 instance lacks.
#include <cstdint>
#include <cuda_runtime.h>

#include "mma_tf32.cuh"

namespace {

using namespace mma_tf32;

constexpr int THREADS = 256;  // 8 warps
constexpr int BQ = 64;        // queries a tile
constexpr int DC = 32;        // depth slice of phase 1
constexpr int DQ = 8;         // query rows of a phase-2 slice: one mma k-step
constexpr int LDQ1 = DC + 4;  // row stride of a depth slice

template <int C>
struct DkvTile {
  static constexpr int BKV = C >= 512 ? 32 : 64;  // key rows a block
  static constexpr int WPR = 8 / (BKV / 16);      // phase 1: warps a 16-row group
  static constexpr int NT1 = BQ / 8 / WPR;        // phase-1 n8 tiles a warp
  static constexpr int WPC = 8 / (BKV / 32);      // phase 2: warps a 32-row group
  static constexpr int NT2 = C / 8 / WPC;         // phase-2 n8 tiles a warp
  static constexpr int LDK = C + 4;               // K, V row stride
  static constexpr int LDP = BQ + 4;              // P^T, dS^T row stride
  static constexpr int LDR = C + 8;               // row-slice stride
  static constexpr int NS1 = C / DC;              // depth slices a tile
  static constexpr int NS = NS1 + BQ / DQ;        // slices a tile, both phases
  static constexpr int SLICE = BQ * LDQ1 > DQ * LDR ? BQ * LDQ1 : DQ * LDR;  // floats: Q or dO
  static constexpr int SMEM_BYTES =
      (2 * BKV * LDK + 2 * BKV * LDP + 4 * SLICE + 2 * BQ) * (int)sizeof(float);
};

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dd,
                 float* __restrict__ dk, float* __restrict__ dv, int S, float scale) {
  using T = DkvTile<C>;
  constexpr int BKV = T::BKV, WPR = T::WPR, NT1 = T::NT1, WPC = T::WPC, NT2 = T::NT2;
  constexpr int LDK = T::LDK, LDP = T::LDP, LDR = T::LDR, NS1 = T::NS1, NS = T::NS, SLICE = T::SLICE;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BKV][LDK]
  float* Vs = Ks + BKV * LDK;                   // [BKV][LDK]
  float* Pt = Vs + BKV * LDK;                   // P^T [BKV][LDP]
  float* St = Pt + BKV * LDP;                   // dS^T [BKV][LDP]
  float* Ring = St + BKV * LDP;                 // [2 stages][Q, dO][SLICE]
  float* Ls = Ring + 4 * SLICE;                 // lse of the query tile [BQ]
  float* Ds = Ls + BQ;                          // D of the query tile [BQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r1 = (warp / WPR) * 16;          // phase 1: the warp's 16 key rows
  const int n1 = (warp % WPR) * (BQ / WPR);  // and its queries
  const int r2 = (warp / WPC) * 32;          // phase 2: its 32 key rows
  const int c2 = (warp % WPC) * (C / WPC);   // and its channels
  const int k0 = blockIdx.x * BKV;
  const long long base = (long long)blockIdx.y * S * C;
  const long long rbase = (long long)blockIdx.y * S;
  const float* qb = q + base;
  const float* ob = dout + base;
  const int slices = (S + BQ - 1) / BQ * NS;

  // slice i of the stream: query tile i / NS; in it, j = i % NS < NS1 is
  // depth slice j of the tile's 64 rows (with lse and D at j = 0), else
  // row slice j - NS1 of all C channels
  auto fetch = [&](int i) {
    const int q0 = i / NS * BQ, j = i % NS;
    float* qs = Ring + (i & 1) * 2 * SLICE;
    float* os = qs + SLICE;
    if (j < NS1) {
      cp_async_rows2<BQ, DC, C, LDQ1, THREADS>(qs, qb, os, ob, q0, j * DC, S);
      if (j == 0 && tid < BQ) {
        const bool in = q0 + tid < S;
        const long long off = rbase + (in ? q0 + tid : 0);
        cp_async4(Ls + tid, lse + off, in);
        cp_async4(Ds + tid, dd + off, in);
      }
    } else {
      cp_async_rows2<DQ, C, C, LDR, THREADS>(qs, qb, os, ob, q0 + (j - NS1) * DQ, 0, S);
    }
    cp_async_commit();
  };

  cp_async_rows2<BKV, C, C, LDK, THREADS>(Ks, k + base, Vs, v + base, k0, 0, S);
  fetch(0);  // one group with K and V

  // wait for slice i, publish it, free the other stage and start slice i + 1 there
  auto next = [&](int i) -> const float* {
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < slices) fetch(i + 1);
    return Ring + (i & 1) * 2 * SLICE;
  };

  float gk[2][NT2][4], gv[2][NT2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) gk[m][n][e] = gv[m][n][e] = 0.f;

  for (int q0 = 0, i = 0; q0 < S; q0 += BQ) {
    // 1. logits^T and dP^T of rows r1.. against queries n1.., over depth slices
    float s[NT1][4], dp[NT1][4];
#pragma unroll
    for (int n = 0; n < NT1; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    for (int j = 0; j < NS1; ++j, ++i) {
      const float* qs = next(i);
      const float* os = qs + SLICE;
#pragma unroll
      for (int kk = 0; kk < DC; kk += 8) {
        uint32_t kbig[4], ksmall[4], vbig[4], vsmall[4];
        load_a<LDK>(Ks, r1, j * DC + kk, lane, kbig, ksmall);
        load_a<LDK>(Vs, r1, j * DC + kk, lane, vbig, vsmall);
#pragma unroll
        for (int n = 0; n < NT1; n += 2) {
          uint32_t qbig[2][2], qsmall[2][2], obig[2][2], osmall[2][2];
          load_b2_nk<LDQ1>(qs, n1 + 8 * n, kk, lane, qbig, qsmall);
          load_b2_nk<LDQ1>(os, n1 + 8 * n, kk, lane, obig, osmall);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mma3(s[n + h], kbig, ksmall, qbig[h], qsmall[h]);
            mma3(dp[n + h], vbig, vsmall, obig[h], osmall[h]);
          }
        }
      }
    }
    // P^T = exp(scale * kq - lse[q]), 0 on queries past S; dS^T = P^T * (dP^T - D[q]);
    // accumulator lane (g, t) holds rows g, g + 8 and columns 2t, 2t + 1 of each m16n8 tile
#pragma unroll
    for (int n = 0; n < NT1; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r1 + g + e / 2 * 8, col = n1 + 8 * n + 2 * t + e % 2;
        const float p = q0 + col < S ? expf(__fmul_rn(scale, s[n][e]) - Ls[col]) : 0.f;
        Pt[row * LDP + col] = p;
        St[row * LDP + col] = p * (dp[n][e] - Ds[col]);
      }

    // 2. dv += P^T dO and dk += dS^T Q, one k-step of DQ query rows a slice
    for (int j = 0; j < BQ / DQ; ++j, ++i) {
      const float* qs = next(i);
      const float* os = qs + SLICE;
      uint32_t pbig[2][4], psmall[2][4], sbig[2][4], ssmall[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        load_a<LDP>(Pt, r2 + 16 * m, j * DQ, lane, pbig[m], psmall[m]);
        load_a<LDP>(St, r2 + 16 * m, j * DQ, lane, sbig[m], ssmall[m]);
      }
#pragma unroll
      for (int n = 0; n < NT2; ++n) {
        uint32_t obig[2], osmall[2], qbig[2], qsmall[2];
        load_b_kn<LDR>(os, c2 + 8 * n, g, t, obig, osmall);
        load_b_kn<LDR>(qs, c2 + 8 * n, g, t, qbig, qsmall);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma3(gv[m][n], pbig[m], psmall[m], obig, osmall);
          mma3(gk[m][n], sbig[m], ssmall[m], qbig, qsmall);
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = k0 + r2 + 16 * m + g + 8 * h;
      if (row >= S) continue;
      float* dkr = dk + base + (long long)row * C + c2 + 2 * t;
      float* dvr = dv + base + (long long)row * C + c2 + 2 * t;
#pragma unroll
      for (int n = 0; n < NT2; ++n) {
        *reinterpret_cast<float2*>(dkr + 8 * n) =
            make_float2(scale * gk[m][n][2 * h], scale * gk[m][n][2 * h + 1]);
        *reinterpret_cast<float2*>(dvr + 8 * n) = make_float2(gv[m][n][2 * h], gv[m][n][2 * h + 1]);
      }
    }
}

template <int C>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout, const float* lse,
               const float* dd, float* dk, float* dv, int B, int S, cudaStream_t stream) {
  using T = DkvTile<C>;
  // the dynamic shared-memory limit is a property of the function on the
  // current device: set it on every launch, so each device gets it
  cudaError_t rc = cudaFuncSetAttribute(
      flash_dkv_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  dim3 grid((S + T::BKV - 1) / T::BKV, B);
  flash_dkv_kernel<C><<<grid, THREADS, T::SMEM_BYTES, stream>>>(q, k, v, dout, lse, dd, dk, dv, S,
                                                                 scale_of(C));
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dk, dv [B, S, C] f32 row-major, 16-byte aligned; lse and
// dd = rowsum(dout * out) [B, S] f32. C is one of 64, 128, 256, 512
// (cudaErrorInvalidValue otherwise). Everything on `stream`.
extern "C" int flash_attention_dkv_launch(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* dd,
                                          void* dk, void* dv, int B, int S, int C, void* stream) {
  if (B == 0 || S == 0) return 0;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  const float *of = (const float*)dout, *lf = (const float*)lse, *df = (const float*)dd;
  float *gk = (float*)dk, *gv = (float*)dv;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 64: return launch_dkv<64>(qf, kf, vf, of, lf, df, gk, gv, B, S, s);
    case 128: return launch_dkv<128>(qf, kf, vf, of, lf, df, gk, gv, B, S, s);
    case 256: return launch_dkv<256>(qf, kf, vf, of, lf, df, gk, gv, B, S, s);
    case 512: return launch_dkv<512>(qf, kf, vf, of, lf, df, gk, gv, B, S, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
