// Per-image scatter-min of packed int32 keys over linear pixel ids: the
// z-buffer merge of the forward splat (geometry/splat.py), and of the JAX
// package's map-requery pool splat (mapping/tsdf.py), whose uint32 keys come
// sign-flipped into int32.
//
// Replaces the TPU kernel sgam_neurips22_tpu/ops/splat_pallas.py::zbuffer_min.
// That kernel kept the whole 256 KB winner image in VMEM and folded the
// target-row span of each scanline chunk with column-match matrices. On
// Hopper the image is larger than a block's 227 KB of shared memory, and
// what bounds the merge is the L2's atomic rate: one thread per point with
// an L2 atomicMin (the first version of this file) took 2-8x the time of
// a read of its points, on NVIDIA H100 80GB HBM3, 700.00 W (PERF.md).
// The bound is the points' bytes: 8 B P + 4 B h w at 3.35 TB/s, 6.89 us
// at [8, 327680] -> 256^2.
//
// Two routes, chosen by shape in ops/zbuffer.py; both take an output that
// the caller filled with INT32_MAX:
//
// - tile (zbuffer_tile_kernel): a block takes one part of every source's
//   points (the point range is `segments` sources of h*w points each) and
//   keeps a window of `tile_rows` target rows in shared memory, centred on
//   the rows of its part. Points in the window take a shared atomicMin, so
//   the N-way collisions of N sources meet there; points outside it go to
//   L2 with a red.min; then every window entry that a point reached goes to
//   L2 once. Collisions cost L2 one atomic per (block, pixel), not per
//   point. It pays where a block has points enough to amortise filling and
//   scanning its window: the 8-scene unroll, the training step, the pool
//   splat.
// - l2 (zbuffer_l2_kernel): the first version's kernel with 16-byte loads,
//   the blocks of an image striding over its points, and a red.min without
//   its read of the winner: for a batch of one, and wherever a block's
//   points are too few to pay for a window.
//
// Thread-block clusters with the image split into bands across their
// distributed shared memory were measured and lost (PERF.md;
// studies/zbuffer_designs.cu holds them): remote shared atomics, or a
// counting sort with the runs pulled over distributed shared memory, took
// 1.6-4.0x the time of L2 atomics at every shape but the training step's.
//
// Min is commutative, so the result is deterministic and bit-identical to
// full(INT32_MAX).at[pix].min(key, mode="drop") whatever the order: invalid
// points carry key INT32_MAX and are skipped; a pixel id outside [0, h*w)
// is dropped. pix and key may sit at any 4-byte alignment: 16-byte loads
// run where the two share their offset from 16-byte alignment, one int at a
// time for the head and tail of each range and wherever they do not.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int IMAX = INT_MAX;
constexpr int TILE_THREADS = 1024, TILE_UNROLL = 2;
constexpr int L2_THREADS = 256, L2_UNROLL = 1;
constexpr int SMEM_MAX = 232448;  // a block's shared memory on sm_90

// put(p, k) for each of the n points at p0 / k0, thread t of T threads
// taking every T-th int (head, tail) or int4 (the rest).
template <int UNROLL, class Put>
__device__ __forceinline__ void for_each_point(const int* p0, const int* k0, int n, int t, int T, const Put& put) {
  int head = n;
  if (((reinterpret_cast<uintptr_t>(p0) ^ reinterpret_cast<uintptr_t>(k0)) & 15) == 0) {
    head = (int)(((16 - (reinterpret_cast<uintptr_t>(p0) & 15)) & 15) >> 2);
    head = head < n ? head : n;
  }
  for (int i = t; i < head; i += T) put(p0[i], k0[i]);
  const int nv = (n - head) >> 2;
  const int4* pv = reinterpret_cast<const int4*>(p0 + head);
  const int4* kv = reinterpret_cast<const int4*>(k0 + head);
  for (int v0 = 0; v0 < nv; v0 += T * UNROLL) {
    int4 pp[UNROLL], kk[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * T + t;
      if (v < nv) {
        pp[u] = __ldcs(pv + v);
        kk[u] = __ldcs(kv + v);
      } else {
        pp[u] = make_int4(0, 0, 0, 0);
        kk[u] = make_int4(IMAX, IMAX, IMAX, IMAX);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      put(pp[u].x, kk[u].x);
      put(pp[u].y, kk[u].y);
      put(pp[u].z, kk[u].z);
      put(pp[u].w, kk[u].w);
    }
  }
  for (int i = head + nv * 4 + t; i < n; i += T) put(p0[i], k0[i]);
}

// grid (parts, B): block (j, b) takes part j of each of the `segments`
// equal point ranges of image b.
__global__ void __launch_bounds__(TILE_THREADS)
    zbuffer_tile_kernel(const int* __restrict__ pix, const int* __restrict__ key, int* __restrict__ out, int points,
                        int h, int w, int segments, int tile_rows) {
  extern __shared__ int4 smem4[];
  int* tile = reinterpret_cast<int*>(smem4);
  const int parts = gridDim.x, part = blockIdx.x, b = blockIdx.y, n_pix = h * w;
  const int seg_len = points / segments;
  const long long lo = (long long)seg_len * part / parts, hi = (long long)seg_len * (part + 1) / parts;
  // the window: tile_rows rows centred on the part's place in its source
  const int center = (int)((lo + hi) / 2 * h / seg_len);
  const int row0 = max(0, min(center - tile_rows / 2, h - tile_rows));
  const int t0 = row0 * w, tn = tile_rows * w;
  for (int i = threadIdx.x; i < (tn + 3) / 4; i += TILE_THREADS) smem4[i] = make_int4(IMAX, IMAX, IMAX, IMAX);
  __syncthreads();
  int* img = out + (long long)b * n_pix;
  auto put = [&](int p, int k) {
    if (k == IMAX || (unsigned)p >= (unsigned)n_pix) return;
    const unsigned o = (unsigned)(p - t0);
    if (o < (unsigned)tn) atomicMin(tile + o, k);
    else atomicMin(img + p, k);
  };
  const long long base = (long long)b * points;
  for (int s = 0; s < segments; ++s) {
    const long long s0 = base + (long long)s * seg_len;
    for_each_point<TILE_UNROLL>(pix + s0 + lo, key + s0 + lo, (int)(hi - lo), threadIdx.x, TILE_THREADS, put);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tn; i += TILE_THREADS) {
    const int v = tile[i];
    if (v != IMAX) atomicMin(img + t0 + i, v);
  }
}

// grid (parts, B): the parts blocks of image b stride over its points
// together, so that a run of invalid points (a masked source) costs every
// block alike.
__global__ void __launch_bounds__(L2_THREADS)
    zbuffer_l2_kernel(const int* __restrict__ pix, const int* __restrict__ key, int* __restrict__ out, int points,
                      int n_pix) {
  const int b = blockIdx.y;
  int* img = out + (long long)b * n_pix;
  auto put = [&](int p, int k) {
    if (k != IMAX && (unsigned)p < (unsigned)n_pix) atomicMin(img + p, k);
  };
  const long long s0 = (long long)b * points;
  for_each_point<L2_UNROLL>(pix + s0, key + s0, points, blockIdx.x * L2_THREADS + threadIdx.x,
                            gridDim.x * L2_THREADS, put);
}

}  // namespace

// route 1: tile, with `parts` blocks an image, `segments` sources and a
// window of `tile_rows` rows; route 0: l2, with `parts` blocks an image
// (`segments` and `tile_rows` unused).
// `out` [batch, h*w] must hold INT32_MAX. Returns a cudaError_t.
extern "C" int zbuffer_min_launch(const void* pix, const void* key, void* out, int batch, int points, int h, int w,
                                  int route, int parts, int segments, int tile_rows, void* stream) {
  if (batch <= 0 || points <= 0) return 0;
  if (parts <= 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(parts, batch);
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 1) {
    const long long smem = ((long long)tile_rows * w + 3) / 4 * 16;
    if (segments <= 0 || points % segments || tile_rows <= 0 || tile_rows > h || smem > SMEM_MAX)
      return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(zbuffer_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    zbuffer_tile_kernel<<<grid, TILE_THREADS, (size_t)smem, st>>>((const int*)pix, (const int*)key, (int*)out, points,
                                                                  h, w, segments, tile_rows);
  } else if (route == 0) {
    zbuffer_l2_kernel<<<grid, L2_THREADS, 0, st>>>((const int*)pix, (const int*)key, (int*)out, points, h * w);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
