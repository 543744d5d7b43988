// Segmented inclusive prefix max on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/seg_scan.py::seg_scan
// (_seg_scan_kernel): out[i] = max over the current segment up to i, where
// a segment restarts at every heads[i] and the elements before the first
// head continue a segment that starts at NEG = -3e38 (the TPU kernel's
// initial carry, and the plain version kernels/ref.py::seg_scan_ref). The
// max is jnp.maximum's: a NaN propagates, and of two zeros +0 is the
// larger.
//
// Bound on this card: bytes. Each element is read once (4 B value + 1 B
// head) and written once (4 B); there is one max per element. At the main
// path's n = 8192 the whole call moves 72 KiB, so the launch and the
// latency of a few dependent steps, not the 3.35 TB/s of HBM, set its
// time: the design spends one launch a call and spreads a tile over
// eight SMs.
//
// Design. The TPU kernel walked 256-wide tiles in grid order and carried
// the running value between grid steps. Here a tile of 8192 elements is
// one thread block cluster of 8 CTAs of 256 threads, so the main shape is
// one cluster with no global carry and no scratch:
//   * each thread folds 4 consecutive elements in registers, loaded as one
//     16-byte vector of values and one 4-byte word of heads;
//   * a warp-shuffle scan over the threads' (head seen, value) pairs, then
//     one shared-memory pass over the 8 warp totals, gives each thread the
//     pair before it within its CTA;
//   * the CTAs' aggregates are read across the cluster through
//     distributed shared memory, giving each CTA the pair before it within
//     the tile; each thread re-folds its elements from there and stores
//     one 16-byte vector.
// Past one tile the tiles run in one pass with a decoupled look-back
// (Merrill and Garland): a cluster takes its tile from an atomic ticket, so
// a tile only ever waits on tiles that clusters already resident hold; its
// last CTA publishes the tile's aggregate (or, when the tile holds a head,
// its inclusive prefix at once), and warp 0 of every CTA reads 32
// predecessors at a time until it meets an inclusive prefix or a tile
// with a head. A tile's status, head flag and f32 value share one 64-bit
// word, stored with release and loaded with acquire semantics, so a reader
// never sees a torn pair. The ticket and the status words live in a
// scratch that the launch function zeroes with cudaMemsetAsync; the
// one-tile case launches without either.
//
// Every max is one max.NaN.f32: +0 above -0, and a NaN in gives the
// canonical NaN 0x7FFFFFFF out. Each value is passed through it once as it
// is loaded, so every NaN the kernel stores is 0x7FFFFFFF, the NaN the
// plain version pins. The max is exact, associative and commutative on
// such values, so the result is bit-identical to the sequential fold for
// any input and any tiling. The ragged tail and misaligned inputs take
// scalar loads and stores.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // CTAs a tile (the portable cluster maximum)
constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kSpan = kThreads * kItems;  // elements a CTA
constexpr int kTile = kCluster * kSpan;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -3e38f;

// A look-back status word: the status in bits 63-62, the head flag in bit
// 32, the value's bits in bits 31-0. Zero means "not published yet".
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kFlagBit = 1ull << 32;

struct Pair {
  int f;    // a head was seen
  float v;  // the running max since the last head
};

// max(a, b) with a NaN propagating (as the canonical NaN) and +0 above -0.
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The scan's operator: a (earlier) then b (later).
__device__ __forceinline__ Pair comb(Pair a, Pair b) {
  return {a.f | b.f, b.f ? b.v : nan_max(a.v, b.v)};
}

__device__ __forceinline__ Pair identity() { return {0, -INFINITY}; }

__device__ __forceinline__ Pair shfl_up(Pair p, int d) {
  return {__shfl_up_sync(kFull, p.f, d), __shfl_up_sync(kFull, p.v, d)};
}

__device__ __forceinline__ Pair shfl_down(Pair p, int d) {
  return {__shfl_down_sync(kFull, p.f, d), __shfl_down_sync(kFull, p.v, d)};
}

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned long long status, Pair p) {
  const unsigned long long w = status |
                               (p.f ? kFlagBit : 0ull) |
                               static_cast<unsigned long long>(
                                   __float_as_uint(p.v));
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long acquire(
    const unsigned long long* word) {
  unsigned long long w;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(w)
               : "l"(word)
               : "memory");
  return w;
}

// Warp 0 of a CTA of tile t > 0: the pair of everything before the tile
// (the seed NEG included), from the status words of tiles t-1, t-2, ...;
// lane i reads tile base - i. Stops at the nearest inclusive prefix or
// head-flagged aggregate. Every lane returns the same pair.
__device__ Pair look_back(const unsigned long long* status, long long t,
                          int lane) {
  Pair acc = identity();
  for (long long base = t - 1;; base -= 32) {
    const long long j = base - lane;
    unsigned long long w = kInclusive;  // before tile 0: identity, unused
    if (j >= 0) {
      do {
        w = acquire(status + j);
      } while ((w >> 62) == 0);
    }
    const bool stop = (w & kInclusive) || (w & kFlagBit);
    const unsigned stops = __ballot_sync(kFull, stop);
    const int last = stops ? __ffs(stops) - 1 : 31;
    Pair p = identity();
    if (lane <= last && j >= 0) {
      p = {(w & kFlagBit) ? 1 : 0,
           __uint_as_float(static_cast<unsigned>(w))};
    }
    // Lane 0 folds lanes 0..31, the farther (higher) lane on the left.
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Pair o = shfl_down(p, d);
      if (lane + d < 32) p = comb(o, p);
    }
    const Pair win = {__shfl_sync(kFull, p.f, 0), __shfl_sync(kFull, p.v, 0)};
    acc = comb(win, acc);
    if (stops) return acc;
  }
}

// The cluster barrier in two halves: arrive once this CTA's reads of the
// other CTAs' shared memory are done, wait before leaving, so that no CTA
// exits while another still reads its shared memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// kLookBack: more than one tile (scratch holds the ticket and the status
// words); the one-tile instantiation carries neither.
template <bool kLookBack>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    seg_scan_kernel(const float* __restrict__ values,
                    const unsigned char* __restrict__ heads,
                    float* __restrict__ out,
                    unsigned long long* __restrict__ scratch, long long n) {
  __shared__ Pair s_warp[kWarps];
  __shared__ Pair s_agg;
  __shared__ Pair s_prefix;
  __shared__ long long s_tile;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // scratch[0] is the ticket counter, scratch[1 + t] tile t's status; the
  // cluster's first CTA takes the ticket.
  long long tile = 0;
  if (kLookBack) {
    if (rank == 0 && threadIdx.x == 0) {
      s_tile = static_cast<long long>(atomicAdd(scratch, 1ull));
    }
    cluster.sync();
    tile = *cluster.map_shared_rank(&s_tile, 0);
  }
  const long long start = tile * kTile + rank * kSpan + threadIdx.x * kItems;
  const bool vec =
      start + kItems <= n &&
      ((reinterpret_cast<uintptr_t>(values) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(heads) & 3) == 0;

  float x[kItems];
  int h[kItems];
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(values + start));
    const unsigned hb =
        __ldg(reinterpret_cast<const unsigned*>(heads + start));
    x[0] = a.x;
    x[1] = a.y;
    x[2] = a.z;
    x[3] = a.w;
#pragma unroll
    for (int k = 0; k < kItems; ++k) h[k] = (hb >> (8 * k)) & 0xff;
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool in = start + k < n;
      x[k] = in ? values[start + k] : -INFINITY;
      h[k] = in ? heads[start + k] : 0;
    }
  }
  Pair t = identity();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    x[k] = nan_max(x[k], -INFINITY);  // pin every NaN to the canonical one
    h[k] = h[k] != 0;
    t = comb(t, {h[k], x[k]});
  }

  // CTA scan of the threads' pairs: inclusive in the warp, then the warp
  // totals in shared memory.
  Pair inc = t;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Pair o = shfl_up(inc, d);
    if (lane >= d) inc = comb(o, inc);
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Pair w = lane < kWarps ? s_warp[lane] : identity();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Pair o = shfl_up(w, d);
      if (lane >= d) w = comb(o, w);
    }
    // s_warp[i] becomes the pair before warp i; lane 31 holds the CTA's
    // aggregate.
    const Pair before = shfl_up(w, 1);
    if (lane < kWarps) s_warp[lane] = lane == 0 ? identity() : before;
    if (lane == 31) s_agg = w;
  }
  cluster.sync();

  // Warp 0: the pair before this CTA within the tile, from the aggregates
  // of the CTAs before it, and the tile's aggregate; then the pair before
  // the tile, from the look-back, with the seed NEG at the front.
  if (warp == 0) {
    Pair p = lane < kCluster ? *cluster.map_shared_rank(&s_agg, lane)
                             : identity();
#pragma unroll
    for (int d = 1; d < kCluster; d <<= 1) {
      const Pair o = shfl_up(p, d);
      if (lane >= d) p = comb(o, p);
    }
    const Pair before = shfl_up(p, 1);
    const Pair agg = {__shfl_sync(kFull, p.f, kCluster - 1),
                      __shfl_sync(kFull, p.v, kCluster - 1)};
    const Pair in_tile = {__shfl_sync(kFull, before.f, rank),
                          __shfl_sync(kFull, before.v, rank)};
    Pair prefix = {0, kNeg};
    if (kLookBack) {
      unsigned long long* status = scratch + 1;
      const bool last = rank == kCluster - 1;
      if (tile == 0) {
        if (last && lane == 0) publish(status, kInclusive, comb(prefix, agg));
      } else {
        if (last && lane == 0) {
          publish(status + tile, agg.f ? kInclusive : kAggregate, agg);
        }
        prefix = look_back(status, tile, lane);
        if (last && lane == 0 && !agg.f) {
          publish(status + tile, kInclusive, comb(prefix, agg));
        }
      }
    }
    if (lane == 0) s_prefix = rank == 0 ? prefix : comb(prefix, in_tile);
  }
  cluster_arrive();
  __syncthreads();

  Pair run = comb(s_prefix, s_warp[warp]);
  const Pair lane_before = shfl_up(inc, 1);
  if (lane > 0) run = comb(run, lane_before);
  float y[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    run = comb(run, {h[k], x[k]});
    y[k] = run.v;
  }
  if (vec) {
    *reinterpret_cast<float4*>(out + start) =
        make_float4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (start + k < n) out[start + k] = y[k];
    }
  }
  cluster_wait();
}

}  // namespace

// The elements one cluster scans: a call with n above it needs a scratch of
// ceil(n / tile) + 1 64-bit words.
extern "C" int seg_scan_tile() { return kTile; }

extern "C" int seg_scan_launch(const float* values, const unsigned char* heads,
                               float* out, unsigned long long* scratch,
                               long long n, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n > 0) {
    const long long tiles = (n + kTile - 1) / kTile;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (tiles > 1) {
      const cudaError_t z = cudaMemsetAsync(
          scratch, 0, (tiles + 1) * sizeof(unsigned long long), s);
      if (z != cudaSuccess) return static_cast<int>(z);
    }
    const dim3 grid(static_cast<unsigned>(tiles * kCluster));
    if (tiles > 1) {
      seg_scan_kernel<true><<<grid, kThreads, 0, s>>>(values, heads, out,
                                                      scratch, n);
    } else {
      seg_scan_kernel<false><<<grid, kThreads, 0, s>>>(values, heads, out,
                                                       nullptr, n);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* seg_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
