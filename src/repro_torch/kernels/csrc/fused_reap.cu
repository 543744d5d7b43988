// Fused neutral CQ post on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused_reap.py::fused_reap
// (_fused_reap_kernel): one pass over the epoch's rows in which every
// valid row of CQ c = clip(key, 0, Q-1) writes (done, done, req_id) at
// ring slot (tail[c] + cnt[c]) mod D and bumps cnt[c]; counts = cnt.
//
// Bound on this card: bytes. Rows are read (13 B each) and the three
// (Q, D) rings are read and written once (24 B a slot); about 1 MB at
// Q = 32, D = 1024, N = 8192, a fraction of a microsecond of HBM time, so
// latency (one launch, a few dependent steps) sets the time.
//
// Design. One CTA of 1024 threads owns one CQ and makes one pass:
//   1. Each thread loads a contiguous run of 8 rows (two 16-byte loads of
//      key, one 8-byte load of valid, all in flight at once), clips the
//      keys and flags its CQ's valid rows. Runs of 8192 rows loop.
//   2. One block-wide exclusive scan of the per-thread counts (warp
//      shuffles, then one warp over the 32 warp totals) gives each flagged
//      row its posting rank, and the running count carries to the next
//      run of rows.
//   3. Each flagged row computes its slot with the reference's int32
//      arithmetic (wrapping tail + rank, floor modulo D) and does
//      atomicMax(win[slot], row) into a table of D ints in shared memory
//      (a Q x D global scratch that the wrapper allocates when D exceeds
//      kSmemSlots). A slot's writer is the largest row index that lands on
//      it: ranks grow with the row index inside a CQ, so that is the last
//      post of the sequential pass, for every tail and every D (also where
//      tail + rank wraps past 2^31 and D does not divide 2^32, so that the
//      slots of consecutive ranks jump).
//   4. After one __syncthreads the threads sweep the D slots with
//      coalesced stores into fresh output rings: (done[w], done[w],
//      req_id[w]) where slot has a winner w, the old ring value otherwise.
// The caller's rings are only read, so the post is functional (as in the
// reference) without cloning them first: one launch, one device event.
// Integer bookkeeping and data movement only, so the result is exact.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                    // rows a thread per run
constexpr int kRun = kThreads * kRows;      // rows a CTA per run
constexpr int kSmemSlots = 48 * 1024;       // slot table in shared memory
constexpr unsigned kFull = 0xffffffffu;

// Flags (bit j) the rows r0 .. r0 + 7 that post to CQ c.
__device__ __forceinline__ unsigned flag_rows(const int* __restrict__ key,
                                              const unsigned char* __restrict__ valid,
                                              int r0, int n, int q, int c,
                                              bool vec) {
  int kk[kRows];
  unsigned char vv[kRows];
  if (vec && r0 + kRows <= n) {
    const int4 k0 = *reinterpret_cast<const int4*>(key + r0);
    const int4 k1 = *reinterpret_cast<const int4*>(key + r0 + 4);
    const uint2 v = *reinterpret_cast<const uint2*>(valid + r0);
    kk[0] = k0.x; kk[1] = k0.y; kk[2] = k0.z; kk[3] = k0.w;
    kk[4] = k1.x; kk[5] = k1.y; kk[6] = k1.z; kk[7] = k1.w;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      vv[j] = static_cast<unsigned char>(v.x >> (8 * j));
      vv[4 + j] = static_cast<unsigned char>(v.y >> (8 * j));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const bool in = r0 + j < n;
      kk[j] = in ? key[r0 + j] : 0;
      vv[j] = in ? valid[r0 + j] : 0;
    }
  }
  unsigned flags = 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int k = kk[j] < 0 ? 0 : (kk[j] > q - 1 ? q - 1 : kk[j]);
    flags |= (vv[j] != 0 && k == c) ? (1u << j) : 0u;
  }
  return flags;
}

// kGlobal: the slot table lives in the (Q, D) global scratch.
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads, 1)
fused_reap_kernel(const float* __restrict__ done_ring,
                  const float* __restrict__ visible_ring,
                  const int* __restrict__ rid_ring,
                  const int* __restrict__ tail, const int* __restrict__ key,
                  const float* __restrict__ done,
                  const int* __restrict__ req_id,
                  const unsigned char* __restrict__ valid,
                  float* __restrict__ out_done, float* __restrict__ out_visible,
                  int* __restrict__ out_rid, int* __restrict__ counts,
                  int* __restrict__ global_win, int q, int d, int n,
                  bool vec) {
  extern __shared__ int smem_win[];
  __shared__ int s_warp[2][kWarps];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* win = kGlobal ? global_win + static_cast<size_t>(c) * d : smem_win;
  for (int s = tid; s < d; s += kThreads) win[s] = -1;
  __syncthreads();

  const unsigned t0 = static_cast<unsigned>(tail[c]);
  int running = 0;
  int parity = 0;
  for (int base = 0; base < n; base += kRun, parity ^= 1) {
    const int r0 = base + tid * kRows;
    unsigned flags = flag_rows(key, valid, r0, n, q, c, vec);
    const int cnt = __popc(flags);
    // Block-wide exclusive scan of cnt. s_warp alternates between runs,
    // so a run's totals are never overwritten while a thread still reads
    // the previous run's.
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    int* sw = s_warp[parity];
    if (lane == 31) sw[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = sw[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      sw[lane] = w;
    }
    __syncthreads();
    int rank = running + (warp ? sw[warp - 1] : 0) + incl - cnt;
    while (flags) {
      const int j = __ffs(flags) - 1;
      flags &= flags - 1;
      const int x = static_cast<int>(t0 + static_cast<unsigned>(rank));
      int pos = x % d;
      if (pos < 0) pos += d;
      atomicMax(win + pos, r0 + j);
      ++rank;
    }
    running += sw[kWarps - 1];
  }
  __syncthreads();

  const size_t row0 = static_cast<size_t>(c) * d;
  for (int s = tid; s < d; s += kThreads) {
    const int w = win[s];
    const size_t o = row0 + s;
    if (w >= 0) {
      const float dv = done[w];
      out_done[o] = dv;
      out_visible[o] = dv;
      out_rid[o] = req_id[w];
    } else {
      out_done[o] = done_ring[o];
      out_visible[o] = visible_ring[o];
      out_rid[o] = rid_ring[o];
    }
  }
  if (tid == 0) counts[c] = running;
}

}  // namespace

extern "C" int fused_reap_smem_slots() { return kSmemSlots; }

// ``scratch`` is a (q, d) int32 buffer when d > kSmemSlots, else null.
extern "C" int fused_reap_launch(const float* done_ring,
                                 const float* visible_ring,
                                 const int* rid_ring, const int* tail,
                                 const int* key, const float* done,
                                 const int* req_id,
                                 const unsigned char* valid, float* out_done,
                                 float* out_visible, int* out_rid,
                                 int* counts, int* scratch, int q, int d,
                                 int n, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (d < 1 || (d > kSmemSlots && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool attr_set[64] = {};
  if (device >= 64 || !attr_set[device]) {
    const cudaError_t a = cudaFuncSetAttribute(
        fused_reap_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemSlots * 4);
    if (a != cudaSuccess) return static_cast<int>(a);
    if (device < 64) attr_set[device] = true;
  }
  const bool vec = (reinterpret_cast<uintptr_t>(key) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(valid) & 7) == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q > 0 && d > kSmemSlots) {
    fused_reap_kernel<true><<<q, kThreads, 0, st>>>(
        done_ring, visible_ring, rid_ring, tail, key, done, req_id, valid,
        out_done, out_visible, out_rid, counts, scratch, q, d, n, vec);
  } else if (q > 0) {
    fused_reap_kernel<false><<<q, kThreads, static_cast<size_t>(d) * 4, st>>>(
        done_ring, visible_ring, rid_ring, tail, key, done, req_id, valid,
        out_done, out_visible, out_rid, counts, nullptr, q, d, n, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_reap_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
