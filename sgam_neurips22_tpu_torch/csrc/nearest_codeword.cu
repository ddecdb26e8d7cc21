// Nearest-codeword search: argmin_k ||z_p - e_k||^2 for each latent z_p,
// with first-occurrence ties, plus the true squared distance, on Hopper's
// tensor cores with a 3xTF32 split.
//
// Replaces the TPU kernel sgam_neurips22_tpu/ops/vq_pallas.py::nearest_codeword
// (kernel body _vq_kernel). That kernel ran the grid's K axis in order on
// one core, carrying a running (min, argmin) in scratch, and multiplied in a
// 6-pass bf16x3 split on the MXU because 1-pass bf16 flipped ~0.4% of the
// indices. Here blocks run in parallel, and the products are mma.sync
// m16n8k8 TF32 with f32 accumulation in the 3xTF32 split of mma_tf32.cuh.
//
// Ranking: codewords are ranked by s = ||e||^2 - 2 z.e, as the TPU kernel
// ranks them, and ||z||^2 is added to the winner only. The [P, K] score
// matrix is never written.
//
// Design. A 256-thread block owns BP = 64 latents and a range of the
// codebook, which it streams in tiles of BN = 256 codewords. The block's
// latents are the A operand: staged once, split into their TF32 big and
// small halves, and kept whole-depth in shared memory (2 x 64 x (D + 4)
// floats). The codewords are the B operand, B[k][n] = e[n0 + n][k0 + k]:
// each tile streams through a two-stage cp.async ring in depth slices of DC
// = 32 (slice i + 1 loads while slice i is used; one __syncthreads a slice
// publishes one stage and frees the other), and each warp splits its B
// fragments in registers. Warp w owns all 64 latents and 32 codewords of
// each tile (32 w ..): 4 m16 x 4 n8 accumulator tiles, so a k-step loads 8
// A fragments (presplit) and 4 B fragments, splits 8 values and runs 48
// mma. (Warps of 32 latents x 64 codewords load 4 A and 8 B fragments and
// split 16 values; they were 7% slower with the epilogue below, PERF.md.)
// Each depth slice is summed from zero (12 tensor-core accumulations) and
// added to the tile's accumulator in f32: a two-level sum, as in the dQ
// kernel. The epilogue runs on the accumulator fragment (lane g, t holds
// rows g, g + 8 and columns 2t, 2t + 1 of each tile): s = e2[k] - 2 acc,
// kept as a running (best score, codeword) a row with a strict < over
// columns that come in increasing order, which keeps the first occurrence.
// At the end each is packed as (ordered bits of s + 0.f) << 32 | k (+ 0
// folds -0 into +0), reduced over the quad with shuffles, over the eight
// warps that share a row by a shared-memory atomicMin, and merged into the
// global result with one 64-bit atomicMin a row. The float-to-uint32 map
// preserves order (negative scores included), so every merge picks the
// smallest score and, on equal scores, the smallest index: the first
// occurrence. A NaN score never wins, and a row whose scores are all +inf
// or NaN gets codeword 0. ||e||^2 is summed from the staged slices as they
// pass (thread tid: codeword tid of the tile; each slice from zero in depth
// order, the slices added in order, two-level as the products), so every
// block that ranks a codeword sums its norm in one fixed order, and
// identical codewords get identical norms and scores and tie exactly; no
// pre-pass reads the codebook once more. ||z||^2 is added in the final
// unpack.
//
// Grid: P / 64 row blocks is too few to fill the card at P = 256 (4
// blocks), so the codebook is split across blocks too, into as many ranges
// (whole tiles each) as keep the grid within one block an SM (the shared
// memory allows one). On an H100 (132 SMs, K = 16384 = 64 tiles): P = 256
// runs 4 x 32 blocks of 2 tiles, P = 2048 32 x 4 of 16 tiles, P = 4096 64 x
// 2 of 32 tiles, and the codebook phase's P = 2048, K = 2048 32 x 4 of 2
// tiles: 128 blocks, one wave, at each.
//
// Bound on the H100 (K = 16384, D = 256; 2 P K D FLOPs; the codebook's 16
// MB read once is 5 us at 3.35 TB/s): P = 256, 2.15 GFLOP, 32.05 us as f32
// on the CUDA cores (67 TFLOP/s) and 13.0 us as 3xTF32 on the tensor cores
// (3 TF32 products per f32 product at 495 TFLOP/s dense); P = 2048, 256.4
// and 104.1 us; P = 4096, 512.8 and 208.2 us; the codebook phase (P = 2048,
// K = 2048), 32.05 and 13.0 us. Compute-bound at every shape. Measured
// (chip_smoke.py, device time of the whole call, NVIDIA H100 80GB HBM3,
// 700.00 W): 45.2 us at P = 256, 297.3 us at 2048, 588.4 us at 4096 and
// 44.6 us in the codebook phase, 29-35% of the 3xTF32 bound's rate and
// 2.4-2.5x faster than the plain version (z @ e.T, argmin) and torch.cdist
// + argmin; the f32 FMA kernel it replaces took 105.9, 780.3, 1552.6 and
// 104.2 us (PERF.md).
//
// Error of the split: x = big + small with big = x rounded to TF32 and the
// tensor core reading small truncated to TF32, so each product z e carries
// a relative error of about 2^-21 (the dropped small x small term and the
// truncated small halves), far below f32's rounding of the 256-term sum.
// What the split cannot fix is the tensor core's own f32 accumulation,
// whose error grows with the magnitude of the running sum: on a trained
// codebook the score is a small difference of large terms (z.e ~ ||e||^2),
// so the sum is kept two-level (above). chip_smoke.py holds the winning
// distance to 1e-6 x (||z||^2 + ||e||^2 + 2 sum |z e|) of the float64 one
// on a clustered codebook (e ~ N(0, 1), z = e_j + 0.05 N(0, 1)), which a
// 1xTF32 product misses (by 35x in tests/test_torch_port_vq_split.py, which
// emulates the arithmetic on the CPU). On the card this kernel reads 0.24 of
// that gate, plain f32 0.37 and the FMA kernel 0.38; with a one-level sum
// it read 1.71 (PERF.md).
//
// Resources: __launch_bounds__(256, 1); ptxas (sm_90a): 215 registers, no
// spills. Shared memory 203.5 KiB (z halves 130 KiB, ring 72 KiB, norms and
// row minima 1.5 KiB), above the 48 KB static limit, so every launch raises
// the kernel's dynamic limit on the current device.
#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "mma_tf32.cuh"

namespace {

using namespace mma_tf32;

constexpr int THREADS = 256;   // 8 warps
constexpr int BP = 64;         // latents a block
constexpr int BN = 256;        // codewords a tile
constexpr int WM = 4;          // m16 tiles (16 latents each) a warp
constexpr int WN = 4;          // n8 tiles (8 codewords each) a warp
constexpr int ROW_WARPS = BP / (16 * WM);               // 1 warp down the latents
constexpr int COL_WARPS = THREADS / 32 / ROW_WARPS;     // 8 across the codewords
static_assert(COL_WARPS * 8 * WN == BN, "the warps cover the tile");
constexpr int DC = 32;         // depth slice
constexpr int LDE = DC + 4;    // slice row stride
constexpr int STAGE = BN * LDE;
static_assert(THREADS == BN, "thread tid sums ||e||^2 of codeword tid of a tile");

constexpr int D = 256;         // depth: the embed_dim of every configuration
constexpr int LDZ = D + 4;     // z row stride
constexpr int NS = D / DC;     // slices a tile
constexpr int SMEM_BYTES = (2 * BP * LDZ + 2 * STAGE + BN) * (int)sizeof(float) + BP * (int)sizeof(unsigned long long);

__device__ __forceinline__ unsigned int ordered_bits(float f) {
  unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(unsigned int u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__global__ void __launch_bounds__(THREADS, 1)
search_kernel(const float* __restrict__ z, const float* __restrict__ e, unsigned long long* __restrict__ best,
              int P, int k_per_block, int K) {
  extern __shared__ float4 smem4[];
  float* Zb = reinterpret_cast<float*>(smem4);  // z [BP][LDZ]: TF32 big halves
  float* Zs = Zb + BP * LDZ;                    // and small halves
  float* Ring = Zs + BP * LDZ;                  // [2 stages][BN][LDE]
  float* E2 = Ring + 2 * STAGE;                 // [BN] ||e||^2 of the tile's codewords
  unsigned long long* Rb = reinterpret_cast<unsigned long long*>(E2 + BN);  // [BP] row minima

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r0 = warp / COL_WARPS * 16 * WM;  // the warp's latents
  const int n0 = warp % COL_WARPS * 8 * WN;   // and codewords of each tile
  const int p0 = blockIdx.x * BP;
  const int k_begin = blockIdx.y * k_per_block;
  const int k_end = min(K, k_begin + k_per_block);
  const int slices = (k_end - k_begin + BN - 1) / BN * NS;

  // slice i of the stream: depth slice i % NS of tile i / NS; codewords
  // past the block's range are zero-filled (and never ranked)
  auto fetch = [&](int i) {
    cp_async_rows<BN, DC, D, LDE, THREADS>(Ring + (i & 1) * STAGE, e, k_begin + i / NS * BN, i % NS * DC, k_end);
    cp_async_commit();
  };
  fetch(0);

  // stage z (rows past P zero) while the first slice loads
  for (int x = tid; x < BP * D / 4; x += THREADS) {
    const int r = x / (D / 4), c = x % (D / 4) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p0 + r < P) a = *reinterpret_cast<const float4*>(z + (long long)(p0 + r) * D + c);
    const float v[4] = {a.x, a.y, a.z, a.w};
    uint32_t big[4], small[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) split(v[u], big[u], small[u]);
    *reinterpret_cast<uint4*>(Zb + r * LDZ + c) = make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(Zs + r * LDZ + c) = make_uint4(small[0], small[1], small[2], small[3]);
  }
  if (tid < BP) Rb[tid] = ULLONG_MAX;

  // wait for slice i, publish it, free the other stage and start slice i + 1 there
  auto next = [&](int i) -> const float* {
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < slices) fetch(i + 1);
    return Ring + (i & 1) * STAGE;
  };

  // the best score and its codeword so far of rows r0 + 16 m + g + 8 h:
  // columns come in increasing order, so a strict < keeps the first
  // occurrence; the first column stands in until a finite score beats +inf
  float best_s[WM][2];
  int best_k[WM][2];
#pragma unroll
  for (int m = 0; m < WM; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best_s[m][h] = INFINITY;
      best_k[m][h] = k_begin + n0 + 2 * t;
    }

  for (int k0 = k_begin, i = 0; k0 < k_end; k0 += BN) {
    float acc[WM][WN][4];
#pragma unroll
    for (int m = 0; m < WM; ++m)
#pragma unroll
      for (int n = 0; n < WN; ++n)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[m][n][v] = 0.f;
    float e2 = 0.f;  // ||e||^2 of codeword tid of the tile: each slice in depth order, then the slices in order
    for (int j = 0; j < NS; ++j, ++i) {
      const float* es = next(i);
      float e2j = 0.f;
#pragma unroll
      for (int c = 0; c < DC; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(es + tid * LDE + c);
        e2j = fmaf(x.x, x.x, e2j);
        e2j = fmaf(x.y, x.y, e2j);
        e2j = fmaf(x.z, x.z, e2j);
        e2j = fmaf(x.w, x.w, e2j);
      }
      e2 += e2j;
      float part[WM][WN][4];
#pragma unroll
      for (int m = 0; m < WM; ++m)
#pragma unroll
        for (int n = 0; n < WN; ++n)
#pragma unroll
          for (int v = 0; v < 4; ++v) part[m][n][v] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DC; kk += 8) {
        uint32_t zbig[WM][4], zsmall[WM][4];
#pragma unroll
        for (int m = 0; m < WM; ++m) load_a_presplit<LDZ>(Zb, Zs, r0 + 16 * m, j * DC + kk, lane, zbig[m], zsmall[m]);
#pragma unroll
        for (int n = 0; n < WN; n += 2) {
          uint32_t ebig[2][2], esmall[2][2];
          load_b2_nk<LDE>(es, n0 + 8 * n, kk, lane, ebig, esmall);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int m = 0; m < WM; ++m) mma3(part[m][n + h], zbig[m], zsmall[m], ebig[h], esmall[h]);
        }
      }
#pragma unroll
      for (int m = 0; m < WM; ++m)
#pragma unroll
        for (int n = 0; n < WN; ++n)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[m][n][v] += part[m][n][v];
    }
    E2[tid] = e2;
    __syncthreads();  // the tile's norms; the next tile writes them after its first slice's __syncthreads

    // scores of the tile, straight from the accumulator fragment
#pragma unroll
    for (int n = 0; n < WN; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k = k0 + n0 + 8 * n + 2 * t + c;
        if (k >= k_end) continue;
        const float ek = E2[k - k0];
#pragma unroll
        for (int m = 0; m < WM; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float s = ek - 2.f * acc[m][n][2 * h + c];
            if (s < best_s[m][h]) {
              best_s[m][h] = s;
              best_k[m][h] = k;
            }
          }
      }
  }

  // packed, then reduced over the quad, over the warps that share a row,
  // and into the global result; + 0 folds -0 into +0
#pragma unroll
  for (int m = 0; m < WM; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned long long v = ((unsigned long long)ordered_bits(best_s[m][h] + 0.f) << 32) | (unsigned int)best_k[m][h];
      v = min(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = min(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (t == 0) atomicMin(Rb + r0 + 16 * m + g + 8 * h, v);
    }
  __syncthreads();
  if (tid < BP && p0 + tid < P) atomicMin(best + p0 + tid, Rb[tid]);
}

// Unpack (index, distance) and add ||z_p||^2; one warp per latent.
__global__ void finalize_kernel(const float* __restrict__ z,
                                const unsigned long long* __restrict__ best,
                                int* __restrict__ idx, float* __restrict__ dist, int P) {
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

// z [P, 256] and codebook [K, 256] f32 row-major, 16-byte aligned (D other
// than 256: cudaErrorInvalidValue); best [P] u64 scratch; idx [P] int32 and
// dist [P] f32 out. Everything on `stream`, on the current device.
extern "C" int nearest_codeword_launch(const void* z, const void* codebook, void* best, void* idx,
                                       void* dist, int P, int K, int depth, void* stream) {
  if (depth != D) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* zf = (const float*)z;
  unsigned long long* b = (unsigned long long*)best;
  int dev = 0, sms = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the dynamic shared-memory limit is a property of the function on the
  // current device: set it on every launch, so each device gets it
  if (rc == 0) rc = (int)cudaFuncSetAttribute(search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (rc == 0) rc = (int)cudaMemsetAsync(best, 0xff, sizeof(unsigned long long) * (size_t)P, s);
  if (rc != 0) return rc;

  // the codebook split across blocks in whole tiles, as many ranges as keep
  // row blocks x ranges within one block an SM
  const int row_blocks = (P + BP - 1) / BP;
  const int k_tiles = (K + BN - 1) / BN;
  const int ranges = max(1, min(k_tiles, sms / row_blocks));
  const int tiles_per_block = (k_tiles + ranges - 1) / ranges;
  const dim3 grid(row_blocks, (k_tiles + tiles_per_block - 1) / tiles_per_block);
  search_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(zf, (const float*)codebook, b, P, tiles_per_block * BN, K);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  finalize_kernel<<<(P * 32 + THREADS - 1) / THREADS, THREADS, 0, s>>>(zf, b, (int*)idx, (float*)dist, P);
  return (int)cudaGetLastError();
}
