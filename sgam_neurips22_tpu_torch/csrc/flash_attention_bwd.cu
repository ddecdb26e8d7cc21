// Single-head flash-attention backward, dq, for [B, S, C] f32 q, k, v and the
// upstream gradient dO: recomputed from the forward's per-row logsumexp,
// with no [S, S] tensor in device memory.
//
//   flash_dq_kernel  replaces sgam_neurips22_tpu/ops/attention_pallas.py::_dq_kernel
//
// (dk and dv: flash_attention_dkv.cu.) With logits = scale * (q k^T) (the
// scale applied after the dot, as the TPU kernel does), P = exp(logits -
// lse), dP = dO V^T, D = rowsum(dO * O) (given, computed by the caller) and
// dS = P * (dP - D):
//   dq = scale * dS K.
// The TPU kernel ran a grid whose innermost axis runs in order on one core
// and carried the accumulator in VMEM scratch across it. Blocks on Hopper
// run in parallel and in no order, so a block owns BQ query rows (64, 32 at
// C=512; Q, dO, lse and D stay in shared memory) and loops over 64-key
// tiles itself: logits and dP over 32-wide depth slices of K and V, then dS
// to shared memory, then acc [BQ, C] += dS K with K streamed in 16 KB row
// slices.
// Thread layout as in flash_attention_fwd.cu: 256 threads as 16 x 16
// (ty, tx); thread (ty, tx) owns tile rows ty*RT + i, logit columns
// tx + 16*j and float4 accumulator columns tx*4 + 64*j.
// Ragged S: rows past S load as zero and are not stored; the key columns
// past S get P = 0.
// The scale multiplies the f32 dot with __fmul_rn, so that the compiler does
// not fuse it with the lse subtraction into one FMA: the logits round as the
// TPU kernel's `scale * dot` does.
//
// Bound on the H100 at the training step's shapes (B=16), f32 on the CUDA
// cores (no TF32: the port runs in f32 parity mode), 67 TFLOP/s: 3 products
// of 2*B*S^2*C, 412 GFLOP, 6.15 ms at S=4096, C=256; 48 us at S=256, C=512.
// Its inputs (q, k, v, dO, lse, D) and output move 268 MB at S=4096, 0.1 ms
// at 3.35 TB/s: compute-bound, so the design is a register-tiled f32 FMA
// loop, like the forward.
// Resources: see the ptxas line that chip_smoke.py prints (one block an SM
// is declared, so ptxas may use up to 255 registers a thread; without it
// the C=64 instance was held to 128 and spilled). Shared memory is above
// the 48 KB static limit (181.5 KiB at C=256), so every launch raises the
// dynamic limit on the current device; one block an SM. Later work: the
// mma.sync 3xTF32 design of flash_attention_dkv.cu, then wgmma and TMA.
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BC = 64;  // keys per tile
constexpr int DC = 32;  // depth slice of the logit products
constexpr int PAD = 4;  // floats of row padding: keeps float4 alignment

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float* y) {
  y[0] = fmaf(a, x.x, y[0]);
  y[1] = fmaf(a, x.y, y[1]);
  y[2] = fmaf(a, x.z, y[2]);
  y[3] = fmaf(a, x.w, y[3]);
}

// rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of a [S, C] matrix into
// shared memory with row stride LD; rows past S are zero
template <int ROWS, int COLS, int C, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int c0, int S) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < ROWS * COLS / 4; i += THREADS) {
    int r = i / (COLS / 4), c4 = i % (COLS / 4);
    float4 x = zero;
    if (r0 + r < S) x = ld4(src + (long long)(r0 + r) * C + c0 + c4 * 4);
    st4(dst + r * LD + c4 * 4, x);
  }
}

// ---------------------------------------------------------------- dQ
template <int C>
struct DqTile {
  static constexpr int BQ = C >= 512 ? 32 : 64;  // query rows per block
  static constexpr int RT = BQ / 16;             // rows per thread
  static constexpr int CG = C / 64;              // float4 accumulator groups per thread
  static constexpr int DK = 4096 / C;            // K rows per 16 KB slice
  static constexpr int QS = BQ * (C + PAD);      // Q and dO, each
  static constexpr int KS = BC * (DC + PAD);     // K and V depth slices, each
  static constexpr int SS = BQ * (BC + PAD);     // dS
  static constexpr int RS = DK * C;              // K row slice
  static constexpr int SMEM_BYTES = (2 * QS + 2 * KS + SS + RS + 2 * BQ) * (int)sizeof(float);
};

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dd,
                float* __restrict__ dq, int S, float scale) {
  using T = DqTile<C>;
  constexpr int BQ = T::BQ, RT = T::RT, CG = T::CG, DK = T::DK;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][C + PAD]
  float* Os = Qs + T::QS;                       // dO [BQ][C + PAD]
  float* Ks = Os + T::QS;                       // [BC][DC + PAD]
  float* Vs = Ks + T::KS;                       // [BC][DC + PAD]
  float* Ss = Vs + T::KS;                       // dS [BQ][BC + PAD]
  float* Rs = Ss + T::SS;                       // K rows [DK][C]
  float* Ls = Rs + T::RS;                       // lse [BQ]
  float* Ds = Ls + BQ;                          // D [BQ]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const long long base = (long long)blockIdx.y * S * C;
  const float* kb = k + base;
  const float* vb = v + base;

  load_tile<BQ, C, C, C + PAD>(Qs, q + base, q0, 0, S);
  load_tile<BQ, C, C, C + PAD>(Os, dout + base, q0, 0, S);
  if (tid < BQ) {
    const bool in = q0 + tid < S;
    Ls[tid] = in ? lse[(long long)blockIdx.y * S + q0 + tid] : 0.f;
    Ds[tid] = in ? dd[(long long)blockIdx.y * S + q0 + tid] : 0.f;
  }
  float acc[RT][CG][4];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BC) {
    // 1. q.k and dO.v of rows ty*RT + i against keys k0 + tx + 16*j
    float s[RT][4], dp[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d0 = 0; d0 < C; d0 += DC) {
      __syncthreads();  // Q, dO, lse, D stored / last slice and last dS.K reads done
      load_tile<BC, DC, C, DC + PAD>(Ks, kb, k0, d0, S);
      load_tile<BC, DC, C, DC + PAD>(Vs, vb, k0, d0, S);
      __syncthreads();
#pragma unroll
      for (int d = 0; d < DC; d += 4) {
        float4 a[RT], o[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          a[i] = ld4(Qs + (ty * RT + i) * (C + PAD) + d0 + d);
          o[i] = ld4(Os + (ty * RT + i) * (C + PAD) + d0 + d);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 kv = ld4(Ks + (tx + 16 * j) * (DC + PAD) + d);
          const float4 vv = ld4(Vs + (tx + 16 * j) * (DC + PAD) + d);
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            s[i][j] = dot4(a[i], kv, s[i][j]);
            dp[i][j] = dot4(o[i], vv, dp[i][j]);
          }
        }
      }
    }

    // 2. dS = P * (dP - D), P = exp(scale * qk - lse), 0 on keys past S
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int row = ty * RT + i;
      const float l = Ls[row], dr = Ds[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = k0 + tx + 16 * j < S ? expf(__fmul_rn(scale, s[i][j]) - l) : 0.f;
        Ss[row * (BC + PAD) + tx + 16 * j] = p * (dp[i][j] - dr);
      }
    }

    // 3. acc += dS K, K streamed in DK-row slices
    for (int kk0 = 0; kk0 < BC; kk0 += DK) {
      __syncthreads();  // dS stored / last K row slice read
      load_tile<DK, C, C, C>(Rs, kb, k0 + kk0, 0, S);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < DK; kk += 4) {
        float4 s4[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) s4[i] = ld4(Ss + (ty * RT + i) * (BC + PAD) + kk0 + kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int j = 0; j < CG; ++j) {
            const float4 w = ld4(Rs + (kk + e) * C + tx * 4 + 64 * j);
#pragma unroll
            for (int i = 0; i < RT; ++i) axpy4(comp(s4[i], e), w, acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + ty * RT + i;
    if (row >= S) continue;
    float* out = dq + base + (long long)row * C;
#pragma unroll
    for (int j = 0; j < CG; ++j)
      st4(out + tx * 4 + 64 * j, make_float4(scale * acc[i][j][0], scale * acc[i][j][1],
                                             scale * acc[i][j][2], scale * acc[i][j][3]));
  }
}

// f32(1/sqrt(C)), as JAX rounds its Python-float scale
float scale_of(int C) { return (float)(1.0 / sqrt((double)C)); }

template <int C>
int launch_dq(const float* q, const float* k, const float* v, const float* dout,
              const float* lse, const float* dd, float* dq, int B, int S, cudaStream_t stream) {
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
