// Single-head flash-attention forward: out = softmax(q k^T / sqrt(C)) v and
// the per-row logsumexp, for [B, S, C] f32 q, k, v, on Hopper's tensor
// cores with a 3xTF32 split:
//
//   flash_fwd_kernel  replaces sgam_neurips22_tpu/ops/attention_pallas.py::_flash_fwd_impl
//                     (kernel body _flash_kernel)
//
// No [S, S] tensor reaches device memory. The TPU kernel ran a (batch, q
// tile, k tile) grid whose k axis runs in order on one core, carrying the
// online-softmax state (acc, m, l) in VMEM from one k step to the next.
// Blocks on Hopper run in parallel and in no order, so here a block owns BQ
// query rows and loops over 64-key tiles itself. The block's rows of q,
// scaled by 1/sqrt(C) before the dot as the TPU kernel scales them, stay in
// shared memory for the block's life, split once into their TF32 big and
// small halves. A tile has two phases, as the dQ kernel
// (flash_attention_dq.cu), whose loop this mirrors with one product fewer:
//   1. logits = Q K^T of the block's rows against the tile, over depth
//      slices of K (128 wide, 64 at C = 64): warp w owns 16 query rows and
//      64 / WPR keys (WPR = warps a 16-row group: 2 at BQ = 64, 4 at 32, 8
//      at 16). Then the online softmax: keys past S get -inf; the row max
//      and row sum are reduced over the 4 lanes of a quad with shuffles and
//      over the WPR warps of a row group through a small shared array; m_new
//      = max(m, tile max), alpha = exp(m - m_new), l = l alpha + sum P and
//      P = exp(logits - m_new) go to shared memory ([BQ][64 + 4]): the
//      accumulator layout of mma is not its A-operand layout, and (m, l,
//      alpha) of a row live in shared memory because phase 2 maps rows to
//      warps differently. Every tile holds a key below S, so m_new is finite
//      and the first tile's alpha is exp(-inf) = 0, never a NaN.
//   2. part = P V over row slices of V (64 keys at C <= 128, 32 at C = 256,
//      16 at C = 512; 8 keys an mma k-step): warp w owns 16 MT query rows
//      (MT = 2 m16 tiles, 1 at BQ = 16) and C / WPC channels. part starts
//      from zero each tile, and acc = acc alpha + part: the rescale that the
//      online softmax needs anyway makes the sum two-level, so the sum over
//      S is S / 64 rounded f32 adds, not 3 S / 8 tensor-core accumulations
//      (the dQ kernel's finding: 37% -> 11% of its gate at S = 4096).
// Every product is mma.sync m16n8k8 in 3xTF32 (mma_tf32.cuh): the port runs
// in f32 parity mode, so there is no 1xTF32 shortcut. Operands come from
// shared memory by ldmatrix (the A fragments of Q and P, the B fragments of
// the K depth slices read as [key][depth]) or, for the [key][channel] B
// operand V, by 32-bit loads, and are split in registers (Q was split when
// staged). Row strides keep a warp's loads on 32 banks: C + 4 for Q, DC + 4
// for the depth slices, 68 for P, C + 8 for the V row slices. The K and V
// slices stream through dQ's two-stage ring filled by cp.async (slice i + 1
// loads while slice i is used; one __syncthreads a slice publishes a slice
// and frees the other), which zero-fills rows past S; rows of q past S
// stage as zero and are not stored. The end divides by max(l, 1e-30) and
// writes lse = m + log(max(l, 1e-30)), as the TPU kernel does.
//
// Tile rule (one design, one rule): a block owns BQ = 64 query rows at
// C <= 256 and 32 at C = 512 (registers: the accumulator and its per-tile
// part are 2 x 64 a thread at C = 256 and 512), but BQ = 16, one m16 row
// group (8 warps x 8 keys in phase 1, 8 warps x C / 8 channels in phase
// 2), when that grid, B ceil(S / 16) blocks, fits on the card's SMs at
// once. A 16-row block does a quarter or half of the larger block's rows in
// about 0.8 of its time, so it gains only where its whole grid runs in one
// wave. On an H100 (132 SMs) the unroll's [8, 256, 512] runs 128 blocks of
// 16 rows, faster than 64 blocks of 32; the training step's [16, 256, 512]
// keeps 128 blocks of 32, because 256 blocks of 16 (148 registers and 136
// KiB of shared memory leave one block an SM) run in two waves and were
// slower (PERF.md). flash_attention_fwd_block_rows reports the rule's
// choice.
//
// Bound on the H100 at the batched unroll's shapes (B = 8 scenes): 2
// products of 2 B S^2 C. [8, 4096, 256]: 137.4 GFLOP, 2.05 ms as f32 on
// the CUDA cores (67 TFLOP/s), 0.83 ms as 3xTF32 on the tensor cores (3 x
// 137.4 GFLOP at 495 TFLOP/s dense); q, k, v and out move 134 MB, 0.04 ms
// at 3.35 TB/s. [8, 256, 512]: 1.07 GFLOP, 16.0 us f32 and 6.5 us 3xTF32.
// Both are compute-bound. Measured (chip_smoke.py, device time, NVIDIA
// H100 80GB HBM3, 700.00 W): 2.507 ms at [8, 4096, 256] (the f32 FMA
// kernel it replaces took 4.81; the plain version 4.408, SDPA 4.108), 33%
// of the 3xTF32 bound's rate; 0.0434 ms at [8, 256, 512] (plain 0.0584,
// SDPA 0.0528). As in dQ, the work around the products (operands loaded
// from shared memory and split in each warp that uses them) holds it above
// the tensor-core bound.
// Resources: __launch_bounds__(256, 1), up to 255 registers a thread;
// ptxas (sm_90a): 225 registers at C = 256 / BQ = 64, 224 at 512 / 32, 148
// at 512 / 16, 140 at 128 / 64, 118 at 64 / 64, 111 at 256 / 16, 79 at
// 128 / 16, 72 at 64 / 16, no spills. Shared memory 214.75 KiB at C = 256
// / BQ = 64 and 204.9 KiB at 512 / 32 (one block an SM), 135.9 KiB at 512 /
// 16; above the 48 KB static limit, so every launch raises the dynamic
// limit of the instantiation it launches on the current device.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "mma_tf32.cuh"

namespace {

using namespace mma_tf32;

constexpr int THREADS = 256;  // 8 warps
constexpr int BK = 64;        // keys a tile
constexpr int LDS = BK + 4;   // P row stride

template <int C, int BQ>
struct FwdTile {
  static constexpr int DC = C < 128 ? C : 128;           // depth slice of phase 1
  static constexpr int DR = C <= 128 ? 64 : 8192 / C;    // V rows of a phase-2 slice
  static constexpr int LDK = DC + 4;                     // depth-slice row stride
  static constexpr int LDQ = C + 4;                      // Q row stride
  static constexpr int LDV = C + 8;                      // V row-slice stride
  static constexpr int WPR = 8 / (BQ / 16);              // phase 1: warps a 16-row group
  static constexpr int NT1 = BK / 8 / WPR;               // phase-1 n8 tiles a warp
  static constexpr int MT = BQ >= 32 ? 2 : 1;            // phase 2: m16 tiles a warp
  static constexpr int WPC = 8 / (BQ / (16 * MT));       // phase 2: warps a row group
  static constexpr int NT2 = C / 8 / WPC;                // phase-2 n8 tiles a warp
  static constexpr int NS1 = C / DC;                     // depth slices a tile
  static constexpr int NS = NS1 + BK / DR;               // slices a tile, both phases
  static constexpr int STAGE = BK * LDK > DR * LDV ? BK * LDK : DR * LDV;  // floats of a ring stage
  static constexpr int SMEM_BYTES =
      (2 * BQ * LDQ + BQ * LDS + 2 * STAGE + 3 * BQ + 2 * BQ * WPR) * (int)sizeof(float);
};

template <int C, int BQ>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int S, float scale) {
  using T = FwdTile<C, BQ>;
  constexpr int DC = T::DC, DR = T::DR, LDK = T::LDK, LDQ = T::LDQ, LDV = T::LDV, WPR = T::WPR;
  constexpr int NT1 = T::NT1, MT = T::MT, WPC = T::WPC, NT2 = T::NT2, NS1 = T::NS1, NS = T::NS;
  constexpr int STAGE = T::STAGE;
  extern __shared__ float4 smem4[];
  float* Qb = reinterpret_cast<float*>(smem4);  // scale * q [BQ][LDQ]: TF32 big halves
  float* Qs = Qb + BQ * LDQ;                    // and small halves
  float* Ps = Qs + BQ * LDQ;                    // P [BQ][LDS]
  float* Ring = Ps + BQ * LDS;                  // [2 stages][STAGE]
  float* Ms = Ring + 2 * STAGE;                 // [BQ] running row max
  float* Ls = Ms + BQ;                          // [BQ] running row sum
  float* As = Ls + BQ;                          // [BQ] alpha of the current tile
  float* Rm = As + BQ;                          // [BQ][WPR] the warps' tile maxima
  float* Rl = Rm + BQ * WPR;                    // [BQ][WPR] and sums

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r1 = (warp / WPR) * 16;          // phase 1: the warp's 16 query rows
  const int wr = warp % WPR;                 // its place in the row group
  const int n1 = wr * (BK / WPR);            // and its keys
  const int r2 = (warp / WPC) * 16 * MT;     // phase 2: its 16 MT query rows
  const int c2 = (warp % WPC) * (C / WPC);   // and its channels
  const int q0 = blockIdx.x * BQ;
  const long long base = (long long)blockIdx.y * S * C;
  const float* kb = k + base;
  const float* vb = v + base;
  const int slices = (S + BK - 1) / BK * NS;

  // slice i of the stream: key tile i / NS; in it, j = i % NS < NS1 is
  // depth slice j of the tile's 64 K rows, else row slice j - NS1 of V
  auto fetch = [&](int i) {
    const int k0 = i / NS * BK, j = i % NS;
    float* st = Ring + (i & 1) * STAGE;
    if (j < NS1) {
      cp_async_rows<BK, DC, C, LDK, THREADS>(st, kb, k0, j * DC, S);
    } else {
      cp_async_rows<DR, C, C, LDV, THREADS>(st, vb, k0 + (j - NS1) * DR, 0, S);
    }
    cp_async_commit();
  };
  fetch(0);

  // stage scale * q (rows past S zero) while the first slice loads
  for (int x = tid; x < BQ * C / 4; x += THREADS) {
    const int r = x / (C / 4), c = x % (C / 4) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) a = *reinterpret_cast<const float4*>(q + base + (long long)(q0 + r) * C + c);
    const float e[4] = {a.x * scale, a.y * scale, a.z * scale, a.w * scale};
    uint32_t big[4], small[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) split(e[u], big[u], small[u]);
    *reinterpret_cast<uint4*>(Qb + r * LDQ + c) = make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(Qs + r * LDQ + c) = make_uint4(small[0], small[1], small[2], small[3]);
  }
  if (tid < BQ) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
  }

  // wait for slice i, publish it, free the other stage and start slice i + 1 there
  auto next = [&](int i) -> const float* {
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < slices) fetch(i + 1);
    return Ring + (i & 1) * STAGE;
  };

  float acc[MT][NT2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int k0 = 0, i = 0; k0 < S; k0 += BK) {
    // 1. logits of rows r1.. against keys n1.., over depth slices
    float s[NT1][4];
#pragma unroll
    for (int n = 0; n < NT1; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int j = 0; j < NS1; ++j, ++i) {
      const float* ks = next(i);
#pragma unroll
      for (int kk = 0; kk < DC; kk += 8) {
        uint32_t qbig[4], qsmall[4];
        load_a_presplit<LDQ>(Qb, Qs, r1, j * DC + kk, lane, qbig, qsmall);
        if constexpr (NT1 == 1) {
          uint32_t kbig[2], ksmall[2];
          load_b_nk<LDK>(ks, n1, kk, lane, kbig, ksmall);
          mma3(s[0], qbig, qsmall, kbig, ksmall);
        } else {
#pragma unroll
          for (int n = 0; n < NT1; n += 2) {
            uint32_t kbig[2][2], ksmall[2][2];
            load_b2_nk<LDK>(ks, n1 + 8 * n, kk, lane, kbig, ksmall);
#pragma unroll
            for (int h = 0; h < 2; ++h) mma3(s[n + h], qbig, qsmall, kbig[h], ksmall[h]);
          }
        }
      }
    }

    // online softmax; accumulator lane (g, t) holds rows g, g + 8 (h = 0, 1)
    // and columns 2t, 2t + 1 of each n8 tile
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT1; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + n1 + 8 * n + 2 * t + e % 2 >= S) s[n][e] = -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (t == 0) Rm[(r1 + g + 8 * h) * WPR + wr] = mx[h];
    }
    __syncthreads();  // every warp's tile maxima
    float mn[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r1 + g + 8 * h;
      mn[h] = Ms[row];
#pragma unroll
      for (int w = 0; w < WPR; ++w) mn[h] = fmaxf(mn[h], Rm[row * WPR + w]);
    }
#pragma unroll
    for (int n = 0; n < NT1; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = expf(s[n][2 * h] - mn[h]), p1 = expf(s[n][2 * h + 1] - mn[h]);
        ps[h] += p0 + p1;
        *reinterpret_cast<float2*>(Ps + (r1 + g + 8 * h) * LDS + n1 + 8 * n + 2 * t) = make_float2(p0, p1);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
      if (t == 0) Rl[(r1 + g + 8 * h) * WPR + wr] = ps[h];
    }
    __syncthreads();  // every warp's sums, and every read of Ms
    if (tid < BQ) {
      const float m_old = Ms[tid];
      float m_new = m_old, l = 0.f;
#pragma unroll
      for (int w = 0; w < WPR; ++w) {
        m_new = fmaxf(m_new, Rm[tid * WPR + w]);
        l += Rl[tid * WPR + w];
      }
      const float alpha = expf(m_old - m_new);
      Ms[tid] = m_new;
      Ls[tid] = Ls[tid] * alpha + l;
      As[tid] = alpha;
    }

    // 2. part = P V, DR / 8 k-steps of 8 keys a slice; the first slice's
    // __syncthreads publishes P and the row statistics
    float part[MT][NT2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[m][n][e] = 0.f;
    for (int j = 0; j < BK / DR; ++j, ++i) {
      const float* rs = next(i);
#pragma unroll
      for (int kk = 0; kk < DR; kk += 8) {
        uint32_t pbig[MT][4], psmall[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) load_a<LDS>(Ps, r2 + 16 * m, j * DR + kk, lane, pbig[m], psmall[m]);
#pragma unroll
        for (int n = 0; n < NT2; ++n) {
          uint32_t vbig[2], vsmall[2];
          load_b_kn<LDV>(rs + kk * LDV, c2 + 8 * n, g, t, vbig, vsmall);
#pragma unroll
          for (int m = 0; m < MT; ++m) mma3(part[m][n], pbig[m], psmall[m], vbig, vsmall);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float alpha = As[r2 + 16 * m + g + 8 * h];
#pragma unroll
        for (int n = 0; n < NT2; ++n)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) acc[m][n][e] = acc[m][n][e] * alpha + part[m][n][e];
      }
  }

  // the last tile's phase 2 synchronised after (m, l) were written
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r2 + 16 * m + g + 8 * h;
      if (q0 + row >= S) continue;
      const float l = fmaxf(Ls[row], 1e-30f);
      float* o = out + base + (long long)(q0 + row) * C + c2 + 2 * t;
#pragma unroll
      for (int n = 0; n < NT2; ++n)
        *reinterpret_cast<float2*>(o + 8 * n) = make_float2(acc[m][n][2 * h] / l, acc[m][n][2 * h + 1] / l);
    }
  if (tid < BQ && q0 + tid < S)
    lse[(long long)blockIdx.y * S + q0 + tid] = Ms[tid] + logf(fmaxf(Ls[tid], 1e-30f));
}

template <int C, int BQ>
int launch(const float* q, const float* k, const float* v, float* out, float* lse, int B, int S,
           cudaStream_t stream) {
  using T = FwdTile<C, BQ>;
  // the dynamic shared-memory limit is a property of the function on the
  // current device: set it on every launch, so each device gets it
  cudaError_t rc = cudaFuncSetAttribute(
      flash_fwd_kernel<C, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  dim3 grid((S + BQ - 1) / BQ, B);
  flash_fwd_kernel<C, BQ><<<grid, THREADS, T::SMEM_BYTES, stream>>>(q, k, v, out, lse, S, scale_of(C));
  return (int)cudaGetLastError();
}

// the tile rule on the current device: BQ = 16 when its whole grid fits
// on the device's SMs at once, else the larger tile
int block_rows(int B, int S, int C, int* bq) {
  static int sms[64];  // SM count of each device, read once
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    rc = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int big = C >= 512 ? 32 : 64;
  *bq = (long long)B * ((S + 15) / 16) <= sms[dev] ? 16 : big;
  return 0;
}

template <int C>
int launch_c(const float* q, const float* k, const float* v, float* out, float* lse, int B, int S,
             cudaStream_t stream) {
  constexpr int BIG = C >= 512 ? 32 : 64;
  int bq = 0;
  const int rc = block_rows(B, S, C, &bq);
  if (rc != 0) return rc;
  return bq == BIG ? launch<C, BIG>(q, k, v, out, lse, B, S, stream)
                   : launch<C, 16>(q, k, v, out, lse, B, S, stream);
}

}  // namespace

// q, k, v, out [B, S, C] f32 row-major, 16-byte aligned; lse [B, S] f32.
// C is one of 64, 128, 256, 512 (cudaErrorInvalidValue otherwise).
// Everything on `stream`, on the current device.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* out, void* lse,
                                          int B, int S, int C, void* stream) {
  if (B == 0 || S == 0) return 0;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  float *of = (float*)out, *lf = (float*)lse;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 64: return launch_c<64>(qf, kf, vf, of, lf, B, S, s);
    case 128: return launch_c<128>(qf, kf, vf, of, lf, B, S, s);
    case 256: return launch_c<256>(qf, kf, vf, of, lf, B, S, s);
    case 512: return launch_c<512>(qf, kf, vf, of, lf, B, S, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The query rows a block that flash_attention_fwd_launch takes for
// [B, S, C] on the current device, in *bq (the tile rule above).
extern "C" int flash_attention_fwd_block_rows(int B, int S, int C, int* bq) {
  if (C != 64 && C != 128 && C != 256 && C != 512) return (int)cudaErrorInvalidValue;
  return block_rows(B, S, C, bq);
}
