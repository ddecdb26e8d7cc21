// Designs of the z-buffer merge that were measured against the shipped one
// (csrc/zbuffer_min.cu) and rejected, kept to reproduce PERF.md's numbers:
// studies/zbuffer_designs.py builds this file and times each design at
// chip_smoke.py's z-buffer cases. Nothing in the port calls it. Every
// design takes pix, key [batch, points] and writes the [batch, n_pix]
// winners, bit-identical to the plain version.
//
// - pr1: the first port's kernel, one thread a point, an L2 atomicMin after
//   a read of the winner, on an output filled with INT32_MAX;
// - readonly: a 16-byte read of pix and key and nothing else, the floor of
//   a launch that reads the points;
// - cluster: thread-block clusters of C blocks, the image split into C
//   bands held in the blocks' shared memory, each point an atomicMin on
//   its band's owner over distributed shared memory (rank r taking the
//   r-th C-th of each source's points, so that a coherent splat's points
//   land mostly in the own band), K clusters an image merged by L2
//   atomics into a filled output;
// - bin: the same clusters, each round's points sorted by owner in shared
//   memory (a counting sort) and the runs pulled by their owners over
//   distributed shared memory;
// - tile: the shipped tile route with its fill folded in behind a grid
//   barrier (a cooperative launch);
// - l2v: L2 atomics with 16-byte loads, a contiguous part of the points a
//   block, with pr1's read of the winner (skip) or without, or with the
//   fill folded in behind a grid barrier.
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int IMAX = INT_MAX;

template <int THREADS, int UNROLL, class F>
__device__ __forceinline__ void for_each_point(const int* p0, const int* k0, int n, const F& put) {
  const int tid = threadIdx.x;
  int head = n;
  if ((((uintptr_t)p0 ^ (uintptr_t)k0) & 15) == 0) {
    head = (int)(((16 - ((uintptr_t)p0 & 15)) & 15) >> 2);
    head = head < n ? head : n;
  }
  for (int i = tid; i < head; i += THREADS) put(p0[i], k0[i]);
  const int nv = (n - head) >> 2;
  const int4* pv = reinterpret_cast<const int4*>(p0 + head);
  const int4* kv = reinterpret_cast<const int4*>(k0 + head);
  for (int v0 = 0; v0 < nv; v0 += THREADS * UNROLL) {
    int4 P[UNROLL], K[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * THREADS + tid;
      if (v < nv) { P[u] = __ldcs(pv + v); K[u] = __ldcs(kv + v); }
      else { P[u] = make_int4(0, 0, 0, 0); K[u] = make_int4(IMAX, IMAX, IMAX, IMAX); }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      put(P[u].x, K[u].x); put(P[u].y, K[u].y); put(P[u].z, K[u].z); put(P[u].w, K[u].w);
    }
  }
  for (int i = head + nv * 4 + tid; i < n; i += THREADS) put(p0[i], k0[i]);
}

// the whole grid fills out (gridDim.y images) with INT32_MAX, then waits at
// a grid barrier
__device__ __forceinline__ void grid_fill(int* out, long long n) {
  const long long blk = blockIdx.y * (long long)gridDim.x + blockIdx.x;
  const long long stride = (long long)gridDim.x * gridDim.y * blockDim.x;
  if ((n & 3) == 0) {
    int4* o4 = reinterpret_cast<int4*>(out);
    for (long long i = blk * blockDim.x + threadIdx.x; i < n / 4; i += stride) o4[i] = make_int4(IMAX, IMAX, IMAX, IMAX);
  } else {
    for (long long i = blk * blockDim.x + threadIdx.x; i < n; i += stride) out[i] = IMAX;
  }
  cg::this_grid().sync();
}

__global__ void pr1_kernel(const int* __restrict__ pix, const int* __restrict__ key, int* __restrict__ out,
                           long long total, int points, int n_pix) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int k = key[i];
    if (k == IMAX) continue;
    const int p = pix[i];
    if (p < 0 || p >= n_pix) continue;
    int* dst = out + (i / points) * (long long)n_pix + p;
    if (k < __ldcg(dst)) atomicMin(dst, k);
  }
}

__global__ void readonly_kernel(const int4* __restrict__ pix, const int4* __restrict__ key, long long n4, int* out) {
  int acc = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4; i += (long long)gridDim.x * blockDim.x) {
    const int4 p = __ldcs(pix + i), k = __ldcs(key + i);
    acc ^= p.x ^ p.y ^ p.z ^ p.w ^ k.x ^ k.y ^ k.z ^ k.w;
  }
  if (acc == 0x12345678) out[blockIdx.x] = acc;  // keeps the loads
}

struct ClusterArgs {
  const int* pix;
  const int* key;
  int* out;
  int points, n_pix, band, splits, segments;
  float inv_band;
};

// p's owning rank and offset in its band (p < 2^24: exact in float, one
// correction step)
__device__ __forceinline__ int owner(int p, int band, float inv_band, int& off) {
  int o = __float2int_rz(__int2float_rn(p) * inv_band);
  off = p - o * band;
  if (off < 0) { --o; off += band; } else if (off >= band) { ++o; off -= band; }
  return o;
}

// the band of this block into out: stored where one cluster owns the image
// (no fill needed), else its entries with L2 atomics (K clusters an image)
__device__ __forceinline__ void band_out(const int* band_smem, const ClusterArgs& a, unsigned rank, int b,
                                         int threads) {
  const int start = rank * a.band, len = min(a.band, a.n_pix - start);
  int* dst = a.out + (long long)b * a.n_pix + start;
  for (int i = threadIdx.x; i < len; i += threads) {
    const int v = band_smem[i];
    if (a.splits == 1) dst[i] = v;
    else if (v != IMAX) atomicMin(dst + i, v);
  }
}

__global__ void __launch_bounds__(512) cluster_kernel(ClusterArgs a) {
  extern __shared__ int4 smem4[];
  int* band_smem = reinterpret_cast<int*>(smem4);
  cg::cluster_group cl = cg::this_cluster();
  const unsigned C = cl.num_blocks(), rank = cl.block_rank();
  const int split = blockIdx.x / C, b = blockIdx.y;
  for (int i = threadIdx.x; i < a.band / 4; i += 512) smem4[i] = make_int4(IMAX, IMAX, IMAX, IMAX);
  cl.sync();
  const int seg_len = a.points / a.segments;
  const long long parts = (long long)C * a.splits, part = (long long)rank * a.splits + split;
  auto put = [&](int p, int k) {
    if (k == IMAX || (unsigned)p >= (unsigned)a.n_pix) return;
    int off;
    const int o = owner(p, a.band, a.inv_band, off);
    if ((unsigned)o == rank) atomicMin(band_smem + off, k);
    else atomicMin(cl.map_shared_rank(band_smem, o) + off, k);
  };
  for (int s = 0; s < a.segments; ++s) {
    const long long lo = (long long)b * a.points + (long long)s * seg_len + seg_len * part / parts;
    const long long hi = (long long)b * a.points + (long long)s * seg_len + seg_len * (part + 1) / parts;
    for_each_point<512, 2>(a.pix + lo, a.key + lo, (int)(hi - lo), put);
  }
  cl.sync();
  band_out(band_smem, a, rank, b, 512);
}

template <int PT>
__global__ void __launch_bounds__(512) bin_kernel(ClusterArgs a) {
  constexpr int THREADS = 512, R = THREADS * PT;
  extern __shared__ int4 smem4[];
  int* band_smem = reinterpret_cast<int*>(smem4);
  int2* queue = reinterpret_cast<int2*>(band_smem + a.band);
  __shared__ int cnt[16], start[17], cursor[16];
  cg::cluster_group cl = cg::this_cluster();
  const unsigned C = cl.num_blocks(), rank = cl.block_rank();
  const int split = blockIdx.x / C, b = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < a.band / 4; i += THREADS) smem4[i] = make_int4(IMAX, IMAX, IMAX, IMAX);
  const long long parts = (long long)C * a.splits, part = (long long)rank * a.splits + split;
  const long long base = (long long)b * a.points;
  const int lo = (int)(a.points * part / parts), hi = (int)(a.points * (part + 1) / parts);
  const int rounds = (int)(((a.points + parts - 1) / parts + R - 1) / R);  // alike in every block
  for (int r = 0; r < rounds; ++r) {
    int d[PT], off[PT], kk[PT];
    unsigned m[PT];
#pragma unroll
    for (int u = 0; u < PT; ++u) {
      const int i = lo + r * R + u * THREADS + tid;
      int p = 0, k = IMAX;
      if (i < hi) { p = __ldcs(a.pix + base + i); k = __ldcs(a.key + base + i); }
      d[u] = k != IMAX && (unsigned)p < (unsigned)a.n_pix ? owner(p, a.band, a.inv_band, off[u]) : -1;
      kk[u] = k;
    }
    if (tid < 16) cnt[tid] = 0;
    __syncthreads();
#pragma unroll
    for (int u = 0; u < PT; ++u) {  // count a rank's points, one shared atomic a warp and rank
      m[u] = __match_any_sync(0xffffffffu, d[u]);
      if (d[u] >= 0 && lane == __ffs(m[u]) - 1) atomicAdd(&cnt[d[u]], __popc(m[u]));
    }
    __syncthreads();
    if (tid == 0) {
      int acc = 0;
      for (int q = 0; q < (int)C; ++q) { start[q] = cursor[q] = acc; acc += cnt[q]; }
      start[C] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < PT; ++u) {
      const int leader = __ffs(m[u]) - 1;
      int pos = 0;
      if (d[u] >= 0 && lane == leader) pos = atomicAdd(&cursor[d[u]], __popc(m[u]));
      pos = __shfl_sync(0xffffffffu, pos, leader);
      if (d[u] >= 0) queue[pos + __popc(m[u] & ((1u << lane) - 1))] = make_int2(off[u], kk[u]);
    }
    cl.sync();
    for (unsigned j = 0; j < C; ++j) {  // pull this rank's run from every queue
      const unsigned q = (rank + j) % C;
      const int2* qq = cl.map_shared_rank(queue, q);
      const int* qs = cl.map_shared_rank(start, q);
      const int s1 = qs[rank + 1];
      for (int i = qs[rank] + tid; i < s1; i += THREADS) {
        const int2 e = qq[i];
        atomicMin(band_smem + e.x, e.y);
      }
    }
    cl.sync();
  }
  __syncthreads();
  band_out(band_smem, a, rank, b, THREADS);
}

// the shipped tile route with the fill folded in (see csrc/zbuffer_min.cu)
__global__ void __launch_bounds__(1024) tile_fold_kernel(const int* pix, const int* key, int* out, int points, int h,
                                                         int w, int segments, int tile_rows) {
  grid_fill(out, (long long)gridDim.y * h * w);
  extern __shared__ int4 smem4[];
  int* tile = reinterpret_cast<int*>(smem4);
  const int parts = gridDim.x, part = blockIdx.x, b = blockIdx.y, n_pix = h * w;
  const int seg_len = points / segments;
  const long long lo = (long long)seg_len * part / parts, hi = (long long)seg_len * (part + 1) / parts;
  const int center = (int)((lo + hi) / 2 * h / seg_len);
  const int row0 = max(0, min(center - tile_rows / 2, h - tile_rows));
  const int t0 = row0 * w, tn = tile_rows * w;
  for (int i = threadIdx.x; i < (tn + 3) / 4; i += 1024) smem4[i] = make_int4(IMAX, IMAX, IMAX, IMAX);
  __syncthreads();
  int* img = out + (long long)b * n_pix;
  auto put = [&](int p, int k) {
    if (k == IMAX || (unsigned)p >= (unsigned)n_pix) return;
    const unsigned o = (unsigned)(p - t0);
    if (o < (unsigned)tn) atomicMin(tile + o, k);
    else atomicMin(img + p, k);
  };
  for (int s = 0; s < segments; ++s) {
    const long long s0 = (long long)b * points + (long long)s * seg_len;
    for_each_point<1024, 2>(pix + s0 + lo, key + s0 + lo, (int)(hi - lo), put);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tn; i += 1024) {
    const int v = tile[i];
    if (v != IMAX) atomicMin(img + t0 + i, v);
  }
}

template <bool SKIP, bool FOLD>
__global__ void __launch_bounds__(256) l2v_kernel(const int* pix, const int* key, int* out, int points, int n_pix) {
  if (FOLD) grid_fill(out, (long long)gridDim.y * n_pix);
  const int parts = gridDim.x, part = blockIdx.x, b = blockIdx.y;
  const long long lo = (long long)points * part / parts, hi = (long long)points * (part + 1) / parts;
  int* img = out + (long long)b * n_pix;
  auto put = [&](int p, int k) {
    if (k == IMAX || (unsigned)p >= (unsigned)n_pix) return;
    if (!SKIP || k < __ldcg(img + p)) atomicMin(img + p, k);
  };
  const long long base = (long long)b * points;
  for_each_point<256, 4>(pix + base + lo, key + base + lo, (int)(hi - lo), put);
}

template <class K>
int launch_cluster(K kern, int smem, ClusterArgs a, int batch, int cluster, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * a.splits, batch, 1);
  cfg.blockDim = dim3(512, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

ClusterArgs cluster_args(const void* pix, const void* key, void* out, int points, int n_pix, int cluster, int splits,
                         int segments) {
  const int band = ((n_pix + cluster - 1) / cluster + 3) & ~3;
  return ClusterArgs{(const int*)pix, (const int*)key, (int*)out, points, n_pix, band, splits, segments, 1.0f / band};
}

}  // namespace

// Each entry point returns a cudaError_t; `out` must hold INT32_MAX for
// pr1, l2v (fold = 0), and cluster and bin with splits > 1.
extern "C" int zs_pr1(const void* pix, const void* key, void* out, int batch, int points, int n_pix, void* stream) {
  const long long total = (long long)batch * points;
  const long long blocks = std::min((total + 255) / 256, 1LL << 20);
  pr1_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>((const int*)pix, (const int*)key, (int*)out, total,
                                                                 points, n_pix);
  return (int)cudaGetLastError();
}

extern "C" int zs_readonly(const void* pix, const void* key, long long n, void* scratch, int blocks, void* stream) {
  readonly_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((const int4*)pix, (const int4*)key, n / 4, (int*)scratch);
  return (int)cudaGetLastError();
}

extern "C" int zs_cluster(const void* pix, const void* key, void* out, int batch, int points, int n_pix, int cluster,
                          int splits, int segments, void* stream) {
  const ClusterArgs a = cluster_args(pix, key, out, points, n_pix, cluster, splits, segments);
  return launch_cluster(cluster_kernel, a.band * 4, a, batch, cluster, (cudaStream_t)stream);
}

extern "C" int zs_bin(const void* pix, const void* key, void* out, int batch, int points, int n_pix, int cluster,
                      int splits, int pt, void* stream) {
  const ClusterArgs a = cluster_args(pix, key, out, points, n_pix, cluster, splits, 1);
  if (pt == 16) return launch_cluster(bin_kernel<16>, a.band * 4 + 512 * 16 * 8, a, batch, cluster, (cudaStream_t)stream);
  return launch_cluster(bin_kernel<8>, a.band * 4 + 512 * 8 * 8, a, batch, cluster, (cudaStream_t)stream);
}

extern "C" int zs_tile_fold(const void* pix, const void* key, void* out, int batch, int points, int h, int w,
                            int parts, int segments, int tile_rows, void* stream) {
  const int smem = (tile_rows * w + 3) / 4 * 16;
  cudaError_t e = cudaFuncSetAttribute(tile_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&pix, (void*)&key, (void*)&out, (void*)&points, (void*)&h, (void*)&w, (void*)&segments,
                  (void*)&tile_rows};
  e = cudaLaunchCooperativeKernel((const void*)tile_fold_kernel, dim3(parts, batch), dim3(1024), args, smem,
                                  (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" int zs_l2v(const void* pix, const void* key, void* out, int batch, int points, int n_pix, int parts, int skip,
                      int fold, void* stream) {
  const dim3 grid(parts, batch);
  cudaStream_t st = (cudaStream_t)stream;
  if (fold) {
    void* args[] = {(void*)&pix, (void*)&key, (void*)&out, (void*)&points, (void*)&n_pix};
    const cudaError_t e = cudaLaunchCooperativeKernel((const void*)l2v_kernel<false, true>, grid, dim3(256), args, 0, st);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  }
  if (skip) l2v_kernel<true, false><<<grid, 256, 0, st>>>((const int*)pix, (const int*)key, (int*)out, points, n_pix);
  else l2v_kernel<false, false><<<grid, 256, 0, st>>>((const int*)pix, (const int*)key, (int*)out, points, n_pix);
  return (int)cudaGetLastError();
}
