// Per-die flash contention on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/die_contention.py::die_contention
// (_die_contention_kernel): a fold over the epoch's rows in dispatch order
// where every event row i on die c observes
//     b = max(cur[c], ready[i]) + cost[i];  busy[i] = b;  cur[c] = b
// and non-event rows get busy[i] = 0. Returns busy (N,) and the advanced
// cursors (K,). The max is jnp.maximum's: a NaN propagates, and of two
// zeros +0 is the larger.
//
// Bound on this card: neither bytes nor operations. The bytes (13 B a row
// in, 4 B out: about 136 KiB at N = 8192) take HBM a few hundredths of a
// microsecond; the floor is each die's chain of dependent max-then-add
// steps, one per event row of the die (about 77 on average at the main
// path's N = 8192, K = 32, 30% event rows).
//
// Design. One CTA of 32 warps owns a group of 8 dies, one warp a die (a
// CTA per group: 4 CTAs on 4 SMs at K = 32, so that the dies' chains do
// not queue for one SM's four schedulers; every CTA reads all rows). The
// rows go through shared memory in tiles of 4096, double-buffered:
// cp.async 16-byte copies of tile t + 1 are in flight while tile t is
// folded, and each tile comes in two groups (chip and event first, then
// ready and cost), so the bitmaps of a tile are built while its times
// still land. For each tile:
//   1. Every warp takes 32-row chunks of the tile and casts four ballots:
//      the rows on a die of the group, and the three bits of that die's
//      index in the group; lane d combines them into die d's bitmap word
//      for the chunk. A die's bitmap (128 words a tile) lists its
//      event rows in row order, with no sort and no atomics. CTA 0 also
//      writes the zeros of the non-event rows (and of event rows whose
//      chip lies outside [0, K)), so every output element is written
//      exactly once.
//   2. The die's warp reads its bitmap (four words a lane, 128 rows), and
//      every lane lists the rows of its set bits, placed by popcount and
//      a warp scan, in a list of the tile's events in row order.
//   3. The warp folds the list in groups of 32 events: lane j gathers the
//      (ready, cost) pair of the group's j-th event from the staged tile
//      one group ahead, into a ring of two groups in shared memory; every
//      lane then runs the die's chain on the group's pairs, read from the
//      ring as broadcasts eight steps ahead of the eight steps that use
//      them; lane j keeps the cursor after the group's j-th event and
//      writes it to that event's row of busy. The cursor stays in a
//      register from tile to tile.
// A step is one max.NaN.f32 (the NaN-propagating max, +0 above -0: the
// reference's rule in one instruction) and one correctly rounded add,
// never contracted, in row order, so each die's fold is the sequential
// one operation for operation. A NaN comes out as the card's canonical
// NaN, as from the plain version's add on the card.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kDies = 8;                    // dies a CTA, one warp each
static_assert(kDies == 8, "the bitmap build spells a die in three bits");
constexpr int kWarps = 32;                  // all stage and build
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 4096;                 // rows a tile
constexpr int kWords = kTile / 32;          // bitmap words a die a tile
constexpr int kLaneWords = kWords / 32;     // bitmap words a lane reads
constexpr int kStageBytes = kTile * 13;     // ready, cost, chip, event
constexpr int kBitmapOff = 2 * kStageBytes;
constexpr int kListOff = kBitmapOff + kDies * kWords * 4;
constexpr int kRingOff = kListOff + kDies * kTile * 2;
constexpr int kRing = 64;                   // (ready, cost) pairs a warp
constexpr int kSmemBytes = kRingOff + kDies * kRing * 8;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kLaneWords == 4, "a lane reads its bitmap words as one uint4");
static_assert(kTile <= 65536, "list entries are 16-bit rows of a tile");
static_assert(kSmemBytes <= 227 * 1024, "one CTA an SM");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most ``kPending`` of this thread's cp.async groups are
// still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copies ``bytes`` bytes to shared memory: 16-byte cp.async (the last
// one zero-filled past the end) when both sides are 16-byte aligned,
// plain byte copies otherwise.
__device__ __forceinline__ void stage_bytes(unsigned char* dst,
                                            const unsigned char* src,
                                            int bytes, bool vec) {
  if (vec) {
    for (int o = threadIdx.x * 16; o < bytes; o += kThreads * 16) {
      cp_async16(dst + o, src + o, min(16, bytes - o));
    }
  } else {
    for (int o = threadIdx.x; o < bytes; o += kThreads) dst[o] = src[o];
  }
}

// Stages tile t's chip and event columns (what the bitmaps need).
__device__ __forceinline__ void stage_events(unsigned char* smem, int t,
                                             const int* chip,
                                             const unsigned char* event,
                                             int n, bool vec) {
  unsigned char* sb = smem + (t & 1) * kStageBytes;
  const int base = t * kTile;
  const int rows = min(kTile, n - base);
  stage_bytes(sb + 8 * kTile,
              reinterpret_cast<const unsigned char*>(chip + base), rows * 4,
              vec);
  stage_bytes(sb + 12 * kTile, event + base, rows, vec);
}

// Stages tile t's ready and cost columns (what the fold needs).
__device__ __forceinline__ void stage_times(unsigned char* smem, int t,
                                            const float* ready,
                                            const float* cost, int n,
                                            bool vec) {
  unsigned char* sb = smem + (t & 1) * kStageBytes;
  const int base = t * kTile;
  const int rows = min(kTile, n - base);
  stage_bytes(sb, reinterpret_cast<const unsigned char*>(ready + base),
              rows * 4, vec);
  stage_bytes(sb + 4 * kTile,
              reinterpret_cast<const unsigned char*>(cost + base), rows * 4,
              vec);
}

// max(a, b) with a NaN propagating and +0 above -0.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// (ready, cost) of the tile's event ``i`` of the die (``rows`` lists them
// in row order), or past the list's end the identity pair (-inf, -0):
// max(cur, -inf) + -0 = cur for every number cur, and a NaN stays NaN.
__device__ __forceinline__ float2 pair_at(const unsigned short* rows, int i,
                                          int tot, const float* s_ready,
                                          const float* s_cost) {
  if (i >= tot) {
    return make_float2(__int_as_float(static_cast<int>(0xff800000u)), -0.0f);
  }
  const int r = rows[i];
  return make_float2(s_ready[r], s_cost[r]);
}

// Folds the ``tot`` events listed in ``rows`` into ``cur`` and writes each
// event row's busy time (step 3 above).
__device__ __forceinline__ float fold_list(const unsigned short* rows,
                                           int tot, const float* s_ready,
                                           const float* s_cost, float2* ring,
                                           float* busy_tile, float cur,
                                           int lane) {
  float2 next = pair_at(rows, lane, tot, s_ready, s_cost);
  for (int g0 = 0; g0 < tot; g0 += 32) {
    const int mine = g0 + lane;
    const int my_row = mine < tot ? rows[mine] : 0;
    const int m = min(32, tot - g0);
    float2* grp = ring + ((g0 >> 5) & 1) * 32;
    grp[lane] = next;
    __syncwarp();
    next = pair_at(rows, mine + 32, tot, s_ready, s_cost);
    float b = 0.0f;
    float2 p[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) p[jj] = grp[jj];
    for (int j0 = 0; j0 < m; j0 += 8) {
      float2 q[8];
      const int jn = min(j0 + 8, 24);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) q[jj] = grp[jn + jj];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        cur = __fadd_rn(max_nan(cur, p[jj].x), p[jj].y);
        if (lane == j0 + jj) b = cur;
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) p[jj] = q[jj];
    }
    if (mine < tot) busy_tile[my_row] = b;
  }
  return cur;
}

__global__ void __launch_bounds__(kThreads, 1)
die_contention_kernel(const float* __restrict__ ready,
                      const float* __restrict__ cost,
                      const int* __restrict__ chip,
                      const unsigned char* __restrict__ event,
                      const float* __restrict__ chip_busy,
                      float* __restrict__ busy, float* __restrict__ cur_out,
                      int n, int k, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* bitmap = reinterpret_cast<unsigned*>(smem + kBitmapOff);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lo = blockIdx.x * kDies;  // first die of this CTA's group
  const int die = lo + warp;
  const bool folds = warp < kDies && die < k;  // the warp folds this die
  const unsigned* my_bits = bitmap + warp * kWords;
  unsigned short* my_list =
      reinterpret_cast<unsigned short*>(smem + kListOff) + warp * kTile;
  float2* my_ring = reinterpret_cast<float2*>(smem + kRingOff) + warp * kRing;
  float cur = folds ? chip_busy[die] : 0.0f;
  const int tiles = (n + kTile - 1) / kTile;

  // Two cp.async groups a tile: chip and event, then ready and cost.
  if (tiles > 0) stage_events(smem, 0, chip, event, n, vec);
  cp_async_commit();
  if (tiles > 0) stage_times(smem, 0, ready, cost, n, vec);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    // Tile t - 1 is folded: its buffers and the bitmaps are free.
    __syncthreads();
    if (t + 1 < tiles) stage_events(smem, t + 1, chip, event, n, vec);
    cp_async_commit();  // possibly empty, so that the waits are uniform
    if (t + 1 < tiles) stage_times(smem, t + 1, ready, cost, n, vec);
    cp_async_commit();
    cp_async_wait<3>();  // tile t's chip and event
    __syncthreads();

    const int base = t * kTile;
    const int rows = min(kTile, n - base);
    const unsigned char* sb = smem + (t & 1) * kStageBytes;
    const float* s_ready = reinterpret_cast<const float*>(sb);
    const float* s_cost = reinterpret_cast<const float*>(sb + 4 * kTile);
    const int* s_chip = reinterpret_cast<const int*>(sb + 8 * kTile);
    const unsigned char* s_event = sb + 12 * kTile;

    // 1. The group's bitmaps, one 32-row chunk a warp at a time.
    for (int w = warp; w < kWords; w += kWarps) {
      const int r = w * 32 + lane;
      const bool in = r < rows;
      const int c = in ? s_chip[r] : -1;
      const bool on_die = in && s_event[r] != 0 && c >= 0 && c < k;
      const bool mine = on_die && c >= lo && c < lo + kDies;
      // Lane d < 8 assembles die d's word from the ballots of "mine" and
      // of the three bits of the die's index within the group.
      const int tag = c - lo;
      unsigned word = __ballot_sync(kFull, mine);
#pragma unroll
      for (int bit = 0; bit < 3; ++bit) {
        const unsigned set = __ballot_sync(kFull, (tag >> bit) & 1);
        word &= (lane >> bit) & 1 ? set : ~set;
      }
      if (lane < kDies) bitmap[lane * kWords + w] = word;
      if (blockIdx.x == 0 && in && !on_die) busy[base + r] = 0.0f;
    }
    cp_async_wait<2>();  // tile t's ready and cost
    __syncthreads();

    // 2. The die's list of its event rows of the tile, in row order.
    // Lane l holds the bitmap words of rows [128 l, 128 l + 128).
    if (!folds) continue;
    const uint4 wv = reinterpret_cast<const uint4*>(my_bits)[lane];
    const unsigned wd[kLaneWords] = {wv.x, wv.y, wv.z, wv.w};
    const int cnt = __popc(wd[0]) + __popc(wd[1]) + __popc(wd[2]) +
                    __popc(wd[3]);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int tot = __shfl_sync(kFull, incl, 31);
    if (tot == 0) continue;
    // Every lane lists the set bits of its words, in row order.
    int pos = incl - cnt;
#pragma unroll
    for (int q = 0; q < kLaneWords; ++q) {
      unsigned bits = wd[q];
      const int row0 = (lane * kLaneWords + q) * 32;
      while (bits) {
        my_list[pos++] = static_cast<unsigned short>(row0 + __ffs(bits) - 1);
        bits &= bits - 1;
      }
    }
    __syncwarp();
    // 3. The die's fold over the list.
    cur = fold_list(my_list, tot, s_ready, s_cost, my_ring, busy + base, cur,
                    lane);
  }
  if (folds && lane == 0) cur_out[die] = cur;
}

}  // namespace

extern "C" int die_contention_launch(const float* ready, const float* cost,
                                     const int* chip,
                                     const unsigned char* event,
                                     const float* chip_busy, float* busy,
                                     float* cur_out, int n, int k,
                                     int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  static bool attr_set[64] = {};
  if (device >= 64 || !attr_set[device]) {
    const cudaError_t a = cudaFuncSetAttribute(
        die_contention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (a != cudaSuccess) return static_cast<int>(a);
    if (device < 64) attr_set[device] = true;
  }
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool vec = aligned(ready) && aligned(cost) && aligned(chip) &&
                   aligned(event);
  // One CTA per group of 8 dies; at least one, which also writes the
  // zeros of rows on no die.
  const int groups = k > 0 ? (k + kDies - 1) / kDies : 1;
  die_contention_kernel<<<groups, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      ready, cost, chip, event, chip_busy, busy, cur_out, n, k, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* die_contention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
