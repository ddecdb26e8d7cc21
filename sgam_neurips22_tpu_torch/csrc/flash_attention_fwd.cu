// Single-head flash-attention forward: out = softmax(q k^T / sqrt(C)) v and
// the per-row logsumexp, for [B, S, C] f32 q, k, v. No [S, S] tensor
// reaches device memory.
//
// Replaces the TPU kernel
// sgam_neurips22_tpu/ops/attention_pallas.py::_flash_fwd_impl (_flash_kernel).
// That kernel ran a (batch, q tile, k tile) grid whose k axis runs in order
// on one core, carrying the online-softmax state (acc, m, l) in VMEM scratch
// from one k step to the next. Blocks on Hopper run in parallel and in no
// order, so here one block owns a tile of query rows and loops over the K/V
// tiles itself, with acc in registers and (m, l) in shared memory.
//
// Bound on the H100 at the batched unroll's shapes (B=8 scenes), f32 on the
// CUDA cores (no TF32: the port runs in f32 parity mode):
//   S=4096, C=256: 4*B*S^2*C = 137.4 GFLOP, 2.05 ms at 67 TFLOP/s; its
//                  134 MB of q, k, v and out take 40 us at 3.35 TB/s.
//   S=256,  C=512: 1.07 GFLOP, 16 us.
// Both are compute-bound, so the design is a register-tiled f32 FMA loop.
//
// Design. 256 threads, a 16 x 16 arrangement (ty, tx). A block holds BQ
// query rows (64, or 32 at C=512 so that the accumulator stays at 64
// registers a thread), pre-scaled by 1/sqrt(C) as the TPU kernel does, in
// shared memory for its whole life. For each 64-key tile:
//   1. logits [BQ, 64]: K is streamed through shared memory in 32-wide
//      slices of C; thread (ty, tx) owns rows ty*RT + i and key columns
//      tx + 16*j and reads float4s of Q and K (rows padded by 4 floats, so
//      the 16 key rows a half-warp reads fall on distinct banks).
//   2. online softmax: key columns past S are -inf; the row max and the row
//      sum are reduced over the 16 threads of a row with shuffles, (acc, l)
//      are rescaled by exp(m_old - m_new), and the probabilities go to
//      shared memory. (m, l) live in shared memory, not in 2*RT registers
//      a thread: that keeps the C=256 kernel at 128 registers without
//      spills, which lets two blocks share an SM.
//   3. acc [BQ, C] += P V: V rows are streamed in slices of 16 KB; thread
//      (ty, tx) owns rows ty*RT + i and float4 columns tx*4 + 64*j.
// Rows of q past S load as zero and are not stored; rows of k and v past S
// load as zero (so 0-probability keys never meet garbage). The end divides
// by max(l, 1e-30) and writes lse = m + log(l), as the TPU kernel does.
//
// Resources (nvcc -Xptxas -v, sm_90a): 128 registers at C=256 and C=128,
// 136 at C=512, 112 at C=64, no spills. Shared memory 107.5 KiB a block at
// C=256 (two blocks an SM) and 98.25 KiB at C=512 (one block: registers),
// above the 48 KB static limit, so every launch raises its dynamic limit
// on the current device. Capping registers at 128 for two blocks at C=512 spills.
// Not filling the card at S=256: B=8 gives 64 blocks for 132 SMs.
// Later work: wgmma with a 3xTF32 split, TMA, double-buffered K/V tiles.
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 64;  // keys per tile
constexpr int DC = 32;  // depth slice of the q.k product
constexpr int PAD = 4;  // floats of row padding: keeps float4 alignment

template <int C>
struct Tile {
  static constexpr int BQ = C >= 512 ? 32 : 64;  // query rows per block
  static constexpr int RT = BQ / 16;             // rows per thread
  static constexpr int CG = C / 64;              // float4 output groups per thread
  static constexpr int DK = 4096 / C;            // V rows per 16 KB slice
  static constexpr int QS = BQ * (C + PAD);      // shared floats of each buffer
  static constexpr int KS = BK * (DC + PAD);
  static constexpr int PS = BQ * (BK + PAD);
  static constexpr int VS = DK * C;
  static constexpr int SMEM_BYTES = (QS + KS + PS + VS + 2 * BQ) * (int)sizeof(float);
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int C>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int S, float scale) {
  using T = Tile<C>;
  constexpr int BQ = T::BQ, RT = T::RT, CG = T::CG, DK = T::DK;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][C + PAD], scaled
  float* Ks = Qs + T::QS;                       // [BK][DC + PAD]
  float* Ps = Ks + T::KS;                       // [BQ][BK + PAD]
  float* Vs = Ps + T::PS;                       // [DK][C]
  float* Ms = Vs + T::VS;                       // [BQ] running row max
  float* Ls = Ms + BQ;                          // [BQ] running row sum

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const long long base = (long long)blockIdx.y * S * C;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = tid; i < BQ * C / 4; i += THREADS) {
    int r = i / (C / 4), c4 = i % (C / 4);
    float4 x = zero;
    if (q0 + r < S) {
      x = ld4(qb + (long long)(q0 + r) * C + c4 * 4);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    st4(Qs + r * (C + PAD) + c4 * 4, x);
  }

  if (tid < BQ) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
  }
  float acc[RT][CG][4];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int j = 0; j < CG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    // 1. logits of rows ty*RT + i against keys k0 + tx + 16*j
    float s[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < C; d0 += DC) {
      __syncthreads();  // Q stored / last slice and last P.V reads done
      for (int i = tid; i < BK * DC / 4; i += THREADS) {
        int r = i / (DC / 4), c4 = i % (DC / 4);
        float4 x = zero;
        if (k0 + r < S) x = ld4(kb + (long long)(k0 + r) * C + d0 + c4 * 4);
        st4(Ks + r * (DC + PAD) + c4 * 4, x);
      }
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < DC; dd += 4) {
        float4 a[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) a[i] = ld4(Qs + (ty * RT + i) * (C + PAD) + d0 + dd);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float4 b = ld4(Ks + (tx + 16 * j) * (DC + PAD) + dd);
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            s[i][j] = fmaf(a[i].x, b.x, s[i][j]);
            s[i][j] = fmaf(a[i].y, b.y, s[i][j]);
            s[i][j] = fmaf(a[i].z, b.z, s[i][j]);
            s[i][j] = fmaf(a[i].w, b.w, s[i][j]);
          }
        }
      }
    }

    // 2. online softmax over this tile; the 16 threads of a row read its
    // (m, l) from shared memory and its tx == 0 thread writes them back
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int row = ty * RT + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx + 16 * j >= S) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // every tile holds a key < S, so m_new is finite and alpha is 0 on the first tile
      const float m_old = Ms[row];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = expf(s[i][j] - m_new);
        psum += p;
        Ps[row * (BK + PAD) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      __syncwarp();  // every lane has read Ms[row] before it changes
      if (tx == 0) {
        Ms[row] = m_new;
        Ls[row] = Ls[row] * alpha + psum;
      }
#pragma unroll
      for (int j = 0; j < CG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= alpha;
    }

    // 3. acc += P V, V streamed in DK-row slices
    for (int kk0 = 0; kk0 < BK; kk0 += DK) {
      __syncthreads();  // P stored / last V slice read
      for (int i = tid; i < DK * C / 4; i += THREADS) {
        int r = i / (C / 4), c4 = i % (C / 4);
        float4 x = zero;
        if (k0 + kk0 + r < S) x = ld4(vb + (long long)(k0 + kk0 + r) * C + c4 * 4);
        st4(Vs + r * C + c4 * 4, x);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < DK; kk += 4) {
        float4 p4[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) p4[i] = ld4(Ps + (ty * RT + i) * (BK + PAD) + kk0 + kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int j = 0; j < CG; ++j) {
            float4 w = ld4(Vs + (kk + e) * C + tx * 4 + 64 * j);
#pragma unroll
            for (int i = 0; i < RT; ++i) {
              float p = comp(p4[i], e);
              acc[i][j][0] = fmaf(p, w.x, acc[i][j][0]);
              acc[i][j][1] = fmaf(p, w.y, acc[i][j][1]);
              acc[i][j][2] = fmaf(p, w.z, acc[i][j][2]);
              acc[i][j][3] = fmaf(p, w.w, acc[i][j][3]);
            }
          }
        }
      }
    }
  }

  // the last tile's P.V loop synchronised after (m, l) were written
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float lt = fmaxf(Ls[ty * RT + i], 1e-30f);
    const float mt = Ms[ty * RT + i];
    const int row = q0 + ty * RT + i;
    if (row >= S) continue;
    float* orow = out + base + (long long)row * C;
#pragma unroll
    for (int j = 0; j < CG; ++j)
      st4(orow + tx * 4 + 64 * j,
          make_float4(acc[i][j][0] / lt, acc[i][j][1] / lt, acc[i][j][2] / lt, acc[i][j][3] / lt));
    if (tx == 0) lse[(long long)blockIdx.y * S + row] = mt + logf(lt);
  }
}

template <int C>
int launch(const float* q, const float* k, const float* v, float* out,
           float* lse, int B, int S, cudaStream_t stream) {
  using T = Tile<C>;
  // the dynamic shared-memory limit is a property of the function on the
  // current device: set it on every launch, so each device gets it
  cudaError_t rc = cudaFuncSetAttribute(
      flash_fwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  dim3 grid((S + T::BQ - 1) / T::BQ, B);
  flash_fwd_kernel<C><<<grid, THREADS, T::SMEM_BYTES, stream>>>(
      q, k, v, out, lse, S, (float)(1.0 / sqrt((double)C)));  // f32(1/sqrt(C)), as JAX rounds it
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out [B, S, C] f32 row-major, 16-byte aligned; lse [B, S] f32.
// C is one of 64, 128, 256, 512 (cudaErrorInvalidValue otherwise).
// Everything on `stream`.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* out, void* lse,
                                          int B, int S, int C, void* stream) {
  if (B == 0 || S == 0) return 0;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  float *of = (float*)out, *lf = (float*)lse;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 64: return launch<64>(qf, kf, vf, of, lf, B, S, s);
    case 128: return launch<128>(qf, kf, vf, of, lf, B, S, s);
    case 256: return launch<256>(qf, kf, vf, of, lf, B, S, s);
    case 512: return launch<512>(qf, kf, vf, of, lf, B, S, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
