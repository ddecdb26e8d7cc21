// Deterministic scatter-add of f32 samples into the TSDF grid: for each key,
// grid[key] = ((grid[key] + v_0) + v_1) + ... over its samples in the order
// they came, which is the sum the CPU's sequential index_add_ forms and the
// JAX package's scatter-add (`grid.at[lin].add(vals)` in
// sgam_neurips22_tpu/mapping/tsdf.py::integrate) forms on the CPU. It
// replaces that XLA scatter; the JAX package has no Pallas kernel here.
//
// No float atomics: two integrations of the same frames give the same grid
// (index_add_'s float atomics add in the order the threads arrive, which
// moved the grid by an ULP between runs and the frames after it with it),
// and the grid is bit-exact with the CPU's. The bound is the bytes: a
// sample's 4 B key and 4 B value read once, each touched voxel's f32 read
// and written once (in practice a 32-byte sector each way: the walk below
// runs at that rate).
//
// The first version sorted the keys with torch.sort (32 bits, an int64
// index as payload), gathered the values and walked each key's run with one
// thread: 118.6 us at the CLEVR map's 1,048,576 samples on NVIDIA H100 80GB
// HBM3, 700.00 W (the sort's 12 device operations 89.8, the gather 10.8,
// the walk 18.0, most of it one thread walking voxel 0's run of 176 masked
// zeros; PERF.md). This version is hand kernels only, launched from one C
// entry point, every size kept on the device (nothing is read back, so
// integrate does not wait for the card):
//
// - ga_zero clears the histograms and the kept count.
// - ga_prep drops the zero addends and the keys outside [0, V). A zero
//   addend changes no sum's bits but one: x + (-0.0) == x for every x, and
//   x + (+0.0) == x unless x is -0.0, which it turns into +0.0. An
//   accumulator of finite values is -0.0 only while it holds the grid's
//   -0.0 and no nonzero addend has come (a sum of nonzero values that
//   cancels is +0.0 under round-to-nearest), and +0.0 + v == -0.0 + v for
//   every nonzero v. So a +0.0 addend at a key whose grid value is -0.0 sets
//   that value to +0.0 here (every such writer writes the same word), and
//   the kept-only sums are then the full sequential sums' bits. That
//   empties voxel 0's run of integrate's masked samples before anything is
//   sorted.
// - A stable LSD radix sort of the kept samples over the bits that V - 1
//   needs (25 for CLEVR: digits of 9, 8, 8 bits; 28 for google_earth and the
//   8-scene map: 4 of 7), the f32 value carried beside its key as one 8-byte
//   pair: no index, no gather. Each pass is reduce-then-scan over chunks of
//   CHUNK samples, one block a chunk in every kernel: ga_count counts each
//   chunk's digits into cnt[digit][chunk] and the pass's histogram (ga_prep
//   does it for the first pass), ga_spine turns the counts into each
//   chunk's first output position per digit (the digit's base from the
//   histogram, plus the counts of the chunks before it), and ga_scatter
//   ranks its chunk stably by digit, tile by tile (warp by warp, the lanes
//   that share a digit found by one ballot per digit bit, then across the
//   block's warps), into a copy of the chunk in shared memory ordered by
//   digit, whose runs it writes with consecutive threads on consecutive
//   pairs. The first pass reads the raw samples and compacts them as it
//   sorts.
// - ga_walk: a lane that heads a key's run adds the run onto grid[key] in
//   order (its warp's part by shuffles) and writes the key once.
//
// The integer atomics only count; no order depends on which thread comes
// first. What the card showed on the way (PERF.md): one kernel a
// pass with a decoupled look-back between tiles was no faster than the
// first version (each tile's prefix waited on a chain through the tiles
// before it at one wave of tiles); chunks of all the samples a resident
// block could take at once made too few blocks; separate key and value
// arrays, or chunks written tile by tile, wrote runs of one or two samples
// (at the 8-scene map's 8.4 M samples, which leave the L2, a pass took
// 2-5x the time). grid_accumulate_sorted_launch is the first version's
// walk over keys that the caller sorted; chip_smoke.py times that route
// beside this one.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_BITS = 10, MAX_BINS = 1 << MAX_BITS, MAX_PASSES = 4;
constexpr int COUNTERS = 8;        // [0]: the kept count
constexpr int THREADS = 256;       // ga_spine, ga_walk
constexpr int SCATTER_THREADS = 512, WARPS = SCATTER_THREADS / 32;
constexpr int ITEMS = 4, TILE = SCATTER_THREADS * ITEMS;  // a thread's samples in a ranked tile
constexpr int CHUNK = 2 * TILE;    // the most samples of a chunk: one block's in every kernel
constexpr int COUNT_THREADS = 1024, COUNT_ITEMS = CHUNK / COUNT_THREADS;  // ga_prep, ga_count
constexpr int ROWS = MAX_BINS + 1;  // the digits and the dropped samples
constexpr int SCATTER_SMEM = CHUNK * 8 + 4 * MAX_BINS * 4 + ROWS * WARPS * 2;

struct Plan {
  int passes;
  int shift[MAX_PASSES], bits[MAX_PASSES];
};

// The digits of a key below `voxels`: ceil(key_bits / max_bits) passes, the
// first key_bits % passes of them one bit wider (ops/grid_accumulate.py's
// digit_plan is the same).
Plan digit_plan(long long voxels, int max_bits) {
  int key_bits = 1;
  while (key_bits < 31 && (1LL << key_bits) < voxels) ++key_bits;
  Plan p{};
  p.passes = (key_bits + max_bits - 1) / max_bits;
  const int base = key_bits / p.passes, extra = key_bits % p.passes;
  for (int i = 0, s = 0; i < p.passes; ++i) {
    p.bits[i] = base + (i < extra);
    p.shift[i] = s;
    s += p.bits[i];
  }
  return p;
}

__device__ __forceinline__ bool is_zero(float v) { return (__float_as_uint(v) & 0x7fffffffu) == 0; }

// [lo, hi) of chunk `b` of n samples in G chunks.
__device__ __forceinline__ void chunk_of(long long n, int G, int b, long long& lo, long long& hi) {
  const long long c = (n + G - 1) / G;
  lo = min((long long)b * c, n);
  hi = min(lo + c, n);
}

// In-place exclusive scan of a[0, n) (n <= MAX_BINS) by a block of NT
// threads; returns the total. `warp_sums` holds NT / 32 ints.
template <int NT>
__device__ int block_exclusive_scan(int* a, int n, int* warp_sums) {
  __syncthreads();  // a's entries come from other threads
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int per = (n + NT - 1) / NT, lo = min(tid * per, n), hi = min(lo + per, n);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int x = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) {
    const int v = warp_sums[i];
    before += i < w ? v : 0;
    total += v;
  }
  int run = before + x - s;
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

__global__ void ga_zero(unsigned* words, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) words[i] = 0;
}

// One block a chunk of the raw samples: it drops the zero addends and the
// keys outside [0, V) (the -0.0 rule above), and counts the kept samples and
// their first digits: cnt[d][b], and the histogram of the pass.
__global__ void __launch_bounds__(COUNT_THREADS) ga_prep(const int* __restrict__ keys,
                                                         const float* __restrict__ vals, float* __restrict__ grid,
                                                         long long n, unsigned voxels, int G, int bits,
                                                         unsigned* __restrict__ hist, unsigned* __restrict__ kept,
                                                         unsigned* __restrict__ cnt) {
  __shared__ unsigned sh[MAX_BINS];
  __shared__ unsigned s_kept;
  const int nb = 1 << bits;
  for (int d = threadIdx.x; d < nb; d += COUNT_THREADS) sh[d] = 0;
  if (threadIdx.x == 0) s_kept = 0;
  long long lo, hi;
  chunk_of(n, G, blockIdx.x, lo, hi);
  unsigned k[COUNT_ITEMS];
  float v[COUNT_ITEMS];
#pragma unroll
  for (int u = 0; u < COUNT_ITEMS; ++u) {
    const long long i = lo + u * COUNT_THREADS + threadIdx.x;
    k[u] = i < hi ? (unsigned)keys[i] : voxels;
    v[u] = i < hi ? vals[i] : 0.0f;
  }
  __syncthreads();
  unsigned mine = 0;
#pragma unroll
  for (int u = 0; u < COUNT_ITEMS; ++u) {
    if (k[u] >= voxels) continue;
    if (!is_zero(v[u])) {
      ++mine;
      atomicAdd(&sh[k[u] & (unsigned)(nb - 1)], 1u);
    } else if (__float_as_uint(v[u]) == 0u && __float_as_uint(grid[k[u]]) == 0x80000000u) {
      grid[k[u]] = 0.0f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mine += __shfl_down_sync(0xffffffffu, mine, o);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(&s_kept, mine);
  __syncthreads();
  for (int d = threadIdx.x; d < nb; d += COUNT_THREADS) {
    cnt[(size_t)d * G + blockIdx.x] = sh[d];
    if (sh[d]) atomicAdd(&hist[d], sh[d]);
  }
  if (threadIdx.x == 0 && s_kept) atomicAdd(kept, s_kept);
}

// The same for a later pass over the kept samples in the last pass's order.
__global__ void __launch_bounds__(COUNT_THREADS) ga_count(const uint2* __restrict__ pairs,
                                                          const unsigned* __restrict__ kept,
                                                          unsigned* __restrict__ hist, unsigned* __restrict__ cnt,
                                                          int G, int shift, int bits) {
  __shared__ unsigned s[MAX_BINS];
  const int nb = 1 << bits;
  for (int d = threadIdx.x; d < nb; d += COUNT_THREADS) s[d] = 0;
  long long lo, hi;
  chunk_of(*kept, G, blockIdx.x, lo, hi);
  unsigned k[COUNT_ITEMS];
#pragma unroll
  for (int u = 0; u < COUNT_ITEMS; ++u) {
    const long long i = lo + u * COUNT_THREADS + threadIdx.x;
    k[u] = i < hi ? pairs[i].x : ~0u;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < COUNT_ITEMS; ++u)
    if (k[u] != ~0u) atomicAdd(&s[(k[u] >> shift) & (unsigned)(nb - 1)], 1u);
  __syncthreads();
  for (int d = threadIdx.x; d < nb; d += COUNT_THREADS) {
    cnt[(size_t)d * G + blockIdx.x] = s[d];
    if (s[d]) atomicAdd(&hist[d], s[d]);
  }
}

// off[d][b] = (the kept samples whose digit is below d) + cnt[d][b' < b]:
// chunk b's first output position for digit d. A block a digit.
__global__ void __launch_bounds__(THREADS) ga_spine(const unsigned* __restrict__ hist,
                                                    const unsigned* __restrict__ cnt, unsigned* __restrict__ off,
                                                    int G) {
  constexpr int PER = 8;
  __shared__ unsigned warp_sums[THREADS / 32];
  const int d = blockIdx.x, tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  unsigned below = 0;  // the samples of the digits before d
  for (int i = tid; i < d; i += THREADS) below += hist[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) below += __shfl_xor_sync(0xffffffffu, below, o);
  if (lane == 0) warp_sums[w] = below;
  __syncthreads();
  unsigned carry = 0;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) carry += warp_sums[i];
  const unsigned* row = cnt + (size_t)d * G;
  unsigned* out = off + (size_t)d * G;
  for (int seg = 0; seg < G; seg += THREADS * PER) {  // a thread's PER consecutive chunks at a time
    const int b0 = seg + tid * PER;
    unsigned v[PER], s = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] = b0 + i < G ? row[b0 + i] : 0u;
      s += v[i];
    }
    unsigned x = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    __syncthreads();  // warp_sums free
    if (lane == 31) warp_sums[w] = x;
    __syncthreads();
    unsigned before = 0, total = 0;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) {
      const unsigned t = warp_sums[i];
      before += i < w ? t : 0u;
      total += t;
    }
    unsigned run = carry + before + x - s;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if (b0 + i < G) out[b0 + i] = run;
      run += v[i];
    }
    carry += total;
  }
}

struct ScatterArgs {
  const int* in_keys;  // the first pass: the raw samples
  const float* in_vals;
  const uint2* in;     // later passes: the last pass's (key, value bits)
  uint2* out;
  const unsigned* cnt;  // [digit][chunk] counts
  const unsigned* off;  // [digit][chunk] first output positions
  const unsigned* kept;
  long long n;  // the first pass's samples
  unsigned voxels;
  int G, shift, bits;
};

// One block a chunk, tile by tile: each tile ranked stably by digit into a
// stage of the chunk ordered by digit, whose runs (one a digit, after those
// of the chunks before) are then written with consecutive threads on
// consecutive pairs.
template <bool FIRST>
__global__ void __launch_bounds__(SCATTER_THREADS) ga_scatter(ScatterArgs a) {
  extern __shared__ __align__(16) unsigned char ga_smem[];
  uint2* sorted = reinterpret_cast<uint2*>(ga_smem);  // the chunk by digit
  int* start = reinterpret_cast<int*>(sorted + CHUNK);  // the digit's first slot in `sorted`
  int* done = start + MAX_BINS;                         // the digit's samples placed from earlier tiles
  int* tcount = done + MAX_BINS;                        // the tile's count per digit
  int* run = tcount + MAX_BINS;                         // the digit's first output position
  // [ROWS][WARPS]: per digit, each warp's count in the tile, then the
  // counts of the warps before it; a digit's row is 32 bytes
  unsigned short* whist = reinterpret_cast<unsigned short*>(run + MAX_BINS);
  __shared__ int s_warp_sums[WARPS];

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int nb = 1 << a.bits;
  const unsigned mask = (unsigned)nb - 1u;
  long long lo, hi;
  chunk_of(FIRST ? a.n : (long long)*a.kept, a.G, blockIdx.x, lo, hi);
  if (lo >= hi) return;
  for (int d = tid; d < nb; d += SCATTER_THREADS) {
    start[d] = (int)a.cnt[(size_t)d * a.G + blockIdx.x];
    run[d] = (int)a.off[(size_t)d * a.G + blockIdx.x];
    done[d] = 0;
  }
  const int total = block_exclusive_scan<SCATTER_THREADS>(start, nb, s_warp_sums);
  const unsigned below = (1u << lane) - 1u;

  for (long long t0 = lo; t0 < hi; t0 += TILE) {
    for (int i = tid; i < 2 * (nb + 1); i += SCATTER_THREADS) reinterpret_cast<uint4*>(whist)[i] = make_uint4(0, 0, 0, 0);
    uint2 e[ITEMS];
    int dig[ITEMS], rank[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long p = t0 + (w * ITEMS + j) * 32 + lane;
      bool ok = p < hi;
      if (FIRST) {
        const unsigned k = ok ? (unsigned)a.in_keys[p] : 0u;
        const float v = ok ? a.in_vals[p] : 0.0f;
        ok = ok && k < a.voxels && !is_zero(v);
        e[j] = make_uint2(k, __float_as_uint(v));
      } else {
        e[j] = ok ? a.in[p] : make_uint2(0u, 0u);
      }
      dig[j] = ok ? (int)((e[j].x >> a.shift) & mask) : nb;  // nb: dropped, counted nowhere
    }
    __syncthreads();  // whist cleared
    // rank within the warp, in the order of the samples (item-major, then
    // lane); the lanes with the same digit found by a ballot per digit bit
    // (and one for the dropped flag, bit `bits`)
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      unsigned peers = 0xffffffffu;
      for (int b = 0; b <= a.bits; ++b) {
        const bool bit = (dig[j] >> b) & 1;
        const unsigned vote = __ballot_sync(0xffffffffu, bit);
        peers &= bit ? vote : ~vote;
      }
      unsigned short* slot = whist + dig[j] * WARPS + w;
      const int c = *slot;
      rank[j] = c + __popc(peers & below);
      __syncwarp();
      if ((peers >> lane) == 1u) *slot = (unsigned short)(c + __popc(peers));  // the group's last lane
      __syncwarp();
    }
    __syncthreads();
    for (int d = tid; d < nb; d += SCATTER_THREADS) {  // a digit's row: the warps' counts -> their prefix
      uint4* row = reinterpret_cast<uint4*>(whist + d * WARPS);
      const uint4 r0 = row[0], r1 = row[1];
      const unsigned words[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
      unsigned out[8], s = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const unsigned lo16 = words[i] & 0xffffu, hi16 = words[i] >> 16;
        out[i] = s | ((s + lo16) << 16);
        s += lo16 + hi16;
      }
      row[0] = make_uint4(out[0], out[1], out[2], out[3]);
      row[1] = make_uint4(out[4], out[5], out[6], out[7]);
      tcount[d] = (int)s;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (dig[j] < nb) sorted[start[dig[j]] + done[dig[j]] + whist[dig[j] * WARPS + w] + rank[j]] = e[j];
    __syncthreads();
    for (int d = tid; d < nb; d += SCATTER_THREADS) done[d] += tcount[d];
  }
  __syncthreads();
  for (int q = tid; q < total; q += SCATTER_THREADS) {
    const uint2 e = sorted[q];
    const int d = (int)((e.x >> a.shift) & mask);
    a.out[run[d] + q - start[d]] = e;
  }
}

// A thread a sorted sample, a warp 32 in a row: the lane that heads a key's
// run starts from grid[key] and adds the run's values in order, those of
// its warp by shuffles and any beyond the warp from memory, then writes the
// key once.
__global__ void __launch_bounds__(THREADS) ga_walk(const uint2* __restrict__ sorted, const unsigned* __restrict__ kept,
                                                   float* __restrict__ grid) {
  const long long m = *kept;
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x, base = i - lane;
  if (base >= m) return;  // the whole warp
  const bool in = i < m;
  const uint2 e = in ? sorted[i] : make_uint2(~0u, 0u);
  unsigned prev = __shfl_up_sync(0xffffffffu, e.x, 1);
  if (lane == 0) prev = i > 0 ? sorted[i - 1].x : ~0u;  // keys are below 2^31
  const bool head = in && e.x != prev;
  const unsigned later = __ballot_sync(0xffffffffu, head) & ~((2u << lane) - 1u);  // heads after this lane
  const int end = later ? __ffs(later) - 1 : 32;  // the run's end in the warp
  float acc = head ? grid[e.x] : 0.0f;
  const float v = __uint_as_float(e.y);
  for (int r = 0; r < 32; ++r) {
    const float x = __shfl_sync(0xffffffffu, v, (lane + r) & 31);
    if (head && lane + r < end && base + lane + r < m) acc = __fadd_rn(acc, x);
    if (!__any_sync(0xffffffffu, head && lane + r + 1 < end)) break;
  }
  if (!head) return;
  if (end == 32)  // the run goes on past the warp
    for (long long j = base + 32; j < m; ++j) {
      const uint2 f = sorted[j];
      if (f.x != e.x) break;
      acc = __fadd_rn(acc, __uint_as_float(f.y));
    }
  grid[e.x] = acc;
}

// The first version's walk: keys sorted stably by the caller, vals in their order.
__global__ void grid_accumulate_sorted_kernel(const int* __restrict__ keys, const float* __restrict__ vals,
                                              float* __restrict__ grid, long long n) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const int key = keys[i];
  if (i > 0 && keys[i - 1] == key) return;
  float acc = grid[key];
  for (long long j = i; j < n && keys[j] == key; ++j) acc += vals[j];
  grid[key] = acc;
}

// The chunks of n samples: G = ceil(n / CHUNK), each at most CHUNK samples
// in every pass (ops/grid_accumulate.py's _chunks is the same).
long long chunks(long long n) { return (n + CHUNK - 1) / CHUNK; }

// The scratch's 4-byte words for n samples; ops/grid_accumulate.py's
// _scratch_words is the same.
long long scratch_words(long long n) {
  return COUNTERS + MAX_PASSES * MAX_BINS + 2LL * MAX_BINS * chunks(n) + 4 * n;
}

cudaError_t launch_sort(const int* idx, const float* vals, float* grid, long long n, long long voxels,
                        unsigned* scratch, int max_bits, cudaStream_t st) {
  static bool ready = false;  // the scatter's shared memory granted, once
  cudaError_t e = cudaSuccess;
  if (!ready) {
    e = cudaFuncSetAttribute(ga_scatter<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, SCATTER_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ga_scatter<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, SCATTER_SMEM);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const int G = (int)chunks(n);
  const Plan plan = digit_plan(voxels, max_bits);
  unsigned* kept = scratch;
  unsigned* hist = scratch + COUNTERS;  // [pass][MAX_BINS]
  unsigned* cnt = hist + MAX_PASSES * MAX_BINS;
  unsigned* off = cnt + (size_t)MAX_BINS * G;
  uint2* buf[2] = {(uint2*)(off + (size_t)MAX_BINS * G), (uint2*)(off + (size_t)MAX_BINS * G) + n};

  ga_zero<<<1, 1024, 0, st>>>(scratch, COUNTERS + plan.passes * MAX_BINS);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ga_prep<<<G, COUNT_THREADS, 0, st>>>(idx, vals, grid, n, (unsigned)voxels, G, plan.bits[0], hist, kept, cnt);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ScatterArgs a{};
  a.in_keys = idx;
  a.in_vals = vals;
  a.cnt = cnt;
  a.off = off;
  a.kept = kept;
  a.n = n;
  a.voxels = (unsigned)voxels;
  a.G = G;
  for (int p = 0; p < plan.passes; ++p) {
    if (p > 0) {
      ga_count<<<G, COUNT_THREADS, 0, st>>>(buf[(p - 1) & 1], kept, hist + p * MAX_BINS, cnt, G, plan.shift[p],
                                            plan.bits[p]);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    ga_spine<<<1 << plan.bits[p], THREADS, 0, st>>>(hist + p * MAX_BINS, cnt, off, G);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    a.in = p ? buf[(p - 1) & 1] : nullptr;
    a.out = buf[p & 1];
    a.shift = plan.shift[p];
    a.bits = plan.bits[p];
    if (p == 0)
      ga_scatter<true><<<G, SCATTER_THREADS, SCATTER_SMEM, st>>>(a);
    else
      ga_scatter<false><<<G, SCATTER_THREADS, SCATTER_SMEM, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  ga_walk<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, st>>>(buf[(plan.passes - 1) & 1], kept, grid);
  return cudaGetLastError();
}

}  // namespace

// grid[idx[i]] += vals[i] for the n samples, each key's in their order (the
// contract above). scratch: at least scratch_words(n) 4-byte words, 8-byte
// aligned (ops/grid_accumulate.py's _scratch_words). max_bits: the widest
// digit (8-10). Returns a cudaError_t.
extern "C" int grid_accumulate_launch(const void* idx, const void* vals, void* grid, long long n, long long voxels,
                                      void* scratch, long long scratch_bytes, int max_bits, void* stream) {
  if (n <= 0) return 0;
  if (n >= (1LL << 30) || voxels <= 0 || voxels > (1LL << 31) || max_bits < 8 || max_bits > MAX_BITS ||
      scratch_bytes < 4 * scratch_words(n) || ((uintptr_t)scratch & 7) || chunks(n) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return (int)launch_sort((const int*)idx, (const float*)vals, (float*)grid, n, voxels, (unsigned*)scratch, max_bits,
                          (cudaStream_t)stream);
}

extern "C" int grid_accumulate_sorted_launch(const void* keys, const void* vals, void* grid, long long n,
                                             void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  grid_accumulate_sorted_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>((const int*)keys,
                                                                                     (const float*)vals,
                                                                                     (float*)grid, n);
  return (int)cudaGetLastError();
}
