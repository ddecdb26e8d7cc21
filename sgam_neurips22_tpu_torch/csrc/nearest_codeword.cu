// Nearest-codeword search: argmin_k ||z_p - e_k||^2 for each latent z_p,
// with first-occurrence ties, plus the true squared distance.
//
// Replaces the TPU kernel sgam_neurips22_tpu/ops/vq_pallas.py::nearest_codeword.
// That kernel ran the grid's K axis in order on one core, carrying a running
// (min, argmin) in scratch; here blocks run in parallel on 132 SMs.
//
// Bound on the H100 at the flagship shape (P=256 latents, K=16384 codewords,
// D=256): 2*P*K*D = 2.1 GFLOP of f32 FMA, about 32 us at the 67 TFLOP/s
// f32 rate of the CUDA cores, against 16 MB of codebook read, about 5 us at
// 3.35 TB/s. So it is compute-bound. f32 precision is required (single-pass
// bf16 flipped ~0.4% of indices on the TPU), so the products are f32 FMA on
// the CUDA cores: no TF32, no bf16. A bf16x3 / TF32x3 tensor-core split is
// later work.
//
// Design. P alone is too small to fill the card, so the grid splits K as
// well as P. Each 256-thread block owns 64 latents x a range of codewords;
// it streams 64-codeword tiles of the codebook and 64-latent tiles of z
// through shared memory in 16-wide slices of D, each thread accumulating a
// 4x4 register tile of z.e. Per latent the block keeps a running packed
// (ordered distance << 32 | index) minimum, reduces it across the 16 threads
// that share the latent with warp shuffles, and merges it into the global
// result with one 64-bit atomicMin. The float-to-uint32 map preserves
// order (negative distances included), so the 64-bit minimum picks the
// smallest distance and, on equal distances, the smallest index: the
// first occurrence, in every merge. ||e||^2 comes from a pre-pass, and
// ||z||^2 is added in the final unpack, as in the TPU kernel.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TP = 64;   // latents per block
constexpr int TK = 64;   // codewords per tile
constexpr int TD = 16;   // depth slice
constexpr int THREADS = 256;

__device__ __forceinline__ unsigned int ordered_bits(float f) {
  unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(unsigned int u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// ||e_k||^2, one warp per codeword.
__global__ void sqnorm_kernel(const float* __restrict__ x, float* __restrict__ out,
                              int rows, int d) {
  int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  int lane = threadIdx.x % 32;
  if (warp >= rows) return;
  const float* row = x + (long long)warp * d;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s = fmaf(row[i], row[i], s);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[warp] = s;
}

__global__ void __launch_bounds__(THREADS)
search_kernel(const float* __restrict__ z, const float* __restrict__ e,
              const float* __restrict__ e2, unsigned long long* __restrict__ best,
              int P, int K, int D, int k_per_block) {
  // +1 column of padding keeps the transposing stores off one bank
  __shared__ float zs[TD][TP + 1];
  __shared__ float es[TD][TK + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // codeword lane: columns tx + 16*j
  const int ty = tid / 16;  // latent lane: rows ty + 16*i
  const int p0 = blockIdx.x * TP;
  const int k_begin = blockIdx.y * k_per_block;
  const int k_end = min(K, k_begin + k_per_block);

  unsigned long long run[4] = {ULLONG_MAX, ULLONG_MAX, ULLONG_MAX, ULLONG_MAX};
  for (int k0 = k_begin; k0 < k_end; k0 += TK) {
    float acc[4][4] = {};
    for (int d0 = 0; d0 < D; d0 += TD) {
#pragma unroll
      for (int r = 0; r < TP * TD / THREADS; ++r) {
        int idx = tid + THREADS * r;
        int row = idx / TD, col = idx % TD;
        int p = p0 + row, k = k0 + row, d = d0 + col;
        zs[col][row] = (p < P && d < D) ? z[(long long)p * D + d] : 0.f;
        es[col][row] = (k < k_end && d < D) ? e[(long long)k * D + d] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < TD; ++dd) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = zs[dd][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = es[dd][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int k = k0 + tx + 16 * j;
      if (k >= k_end) continue;
      float ek = e2[k];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float dist = (ek - 2.f * acc[i][j]) + 0.f;  // + 0 folds -0 into +0
        unsigned long long packed =
            ((unsigned long long)ordered_bits(dist) << 32) | (unsigned int)k;
        run[i] = min(run[i], packed);
      }
    }
  }
  // the 16 threads sharing a latent are one half of a warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    unsigned long long v = run[i];
    for (int off = 8; off > 0; off >>= 1)
      v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
    int p = p0 + ty + 16 * i;
    if (tx == 0 && p < P && v != ULLONG_MAX) atomicMin(best + p, v);
  }
}

// Unpack (index, distance) and add ||z_p||^2; one warp per latent.
__global__ void finalize_kernel(const float* __restrict__ z,
                                const unsigned long long* __restrict__ best,
                                int* __restrict__ idx, float* __restrict__ dist,
                                int P, int D) {
  int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  int lane = threadIdx.x % 32;
  if (warp >= P) return;
  const float* row = z + (long long)warp * D;
  float s = 0.f;
  for (int i = lane; i < D; i += 32) s = fmaf(row[i], row[i], s);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    unsigned long long v = best[warp];
    idx[warp] = (int)(unsigned int)(v & 0xffffffffu);
    dist[warp] = from_ordered_bits((unsigned int)(v >> 32)) + s;
  }
}

}  // namespace

// z [P, D] and codebook [K, D] f32 row-major; e2 [K] f32 and best [P] u64
// scratch; idx [P] int32 and dist [P] f32 out. Everything on `stream`.
extern "C" int nearest_codeword_launch(const void* z, const void* codebook,
                                       void* e2, void* best, void* idx,
                                       void* dist, int P, int K, int D,
                                       void* stream) {
  if (P == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);

  cudaMemsetAsync(best, 0xff, sizeof(unsigned long long) * (size_t)P, s);
  sqnorm_kernel<<<(K * 32 + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      (const float*)codebook, (float*)e2, K, D);

  // about four blocks per SM: split K so that row blocks x K splits fills it
  int row_blocks = (P + TP - 1) / TP;
  int k_tiles = (K + TK - 1) / TK;
  int splits = max(1, min(k_tiles, (4 * sms) / row_blocks));
  int tiles_per_block = (k_tiles + splits - 1) / splits;
  int k_per_block = tiles_per_block * TK;
  dim3 grid(row_blocks, (k_tiles + tiles_per_block - 1) / tiles_per_block);
  search_kernel<<<grid, THREADS, 0, s>>>(
      (const float*)z, (const float*)codebook, (const float*)e2,
      (unsigned long long*)best, P, K, D, k_per_block);

  finalize_kernel<<<(P * 32 + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      (const float*)z, (const unsigned long long*)best, (int*)idx,
      (float*)dist, P, D);
  return (int)cudaGetLastError();
}
