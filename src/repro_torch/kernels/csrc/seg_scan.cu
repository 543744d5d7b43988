// Segmented inclusive prefix max on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/seg_scan.py::seg_scan
// (_seg_scan_kernel): out[i] = max over the current segment up to i, where
// a segment restarts at every heads[i] and the elements before the first
// head continue a segment that starts at NEG = -3e38 (the TPU kernel's
// initial carry, and the sequential oracle kernels/ref.py::seg_scan_ref).
//
// Bound on this card: bytes. Each element is read once (4 B value + 1 B
// head) and written once (4 B); there is one max per element. At the main
// path's n = 8192 the whole call moves 72 KiB, so launch latency, not the
// 3.35 TB/s of HBM, sets its time.
//
// Design. The TPU kernel walked 256-wide tiles in grid order and carried
// the running value between grid steps; Hopper blocks run in no order, so
// the carry moves to a three-pass scan over (flag, value) pairs:
//   1. seg_scan_tile: each block scans its 256-element tile with warp
//      shuffles plus one shared-memory pass over the warp totals, writes
//      the tile-local result, the tile aggregate (any head, last value) and
//      the tile's first-head offset;
//   2. seg_scan_carry: one block scans the tile aggregates (exclusive), in
//      chunks of 256 with a running value, seeded with NEG;
//   3. seg_scan_fix: elements before their tile's first head take
//      max(carry, local).
// The ragged tail is masked in the kernel (out-of-range lanes hold the
// identity -inf with no head and store nothing). Max is exact and
// associative, so the result is bit-identical to the sequential fold for
// any input without NaN; kmax keeps torch.maximum's argument order so
// signed zeros come out as in the plain version.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;
constexpr int kWarps = kTile / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -3e38f;

__device__ __forceinline__ float kmax(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return b > a ? b : a;
}

// Block-wide inclusive segmented scan of one (head, value) pair per
// thread. Returns the scanned value; *any_head is the OR of the heads up to
// and including this thread. Contains __syncthreads: every thread of the
// block must call it.
__device__ float block_seg_scan(bool head, float v, bool* any_head,
                                float* s_v, int* s_f) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int f = head ? 1 : 0;
  for (int d = 1; d < 32; d <<= 1) {
    float vp = __shfl_up_sync(kFull, v, d);
    int fp = __shfl_up_sync(kFull, f, d);
    if (lane >= d) {
      if (!f) v = kmax(vp, v);
      f |= fp;
    }
  }
  if (lane == 31) {
    s_v[warp] = v;
    s_f[warp] = f;
  }
  __syncthreads();
  if (warp == 0) {
    float wv = lane < kWarps ? s_v[lane] : -INFINITY;
    int wf = lane < kWarps ? s_f[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      float vp = __shfl_up_sync(kFull, wv, d);
      int fp = __shfl_up_sync(kFull, wf, d);
      if (lane >= d) {
        if (!wf) wv = kmax(vp, wv);
        wf |= fp;
      }
    }
    // Exclusive over warps: warp w takes warp w-1's inclusive total.
    float ev = __shfl_up_sync(kFull, wv, 1);
    int ef = __shfl_up_sync(kFull, wf, 1);
    __syncwarp();
    if (lane < kWarps) {
      s_v[lane] = lane == 0 ? -INFINITY : ev;
      s_f[lane] = lane == 0 ? 0 : ef;
    }
  }
  __syncthreads();
  if (!f) v = kmax(s_v[warp], v);
  *any_head = f || s_f[warp];
  __syncthreads();  // s_v/s_f may be reused by the caller's next call
  return v;
}

__global__ void seg_scan_tile(const float* __restrict__ values,
                              const unsigned char* __restrict__ heads,
                              float* __restrict__ out,
                              float* __restrict__ agg_v,
                              int* __restrict__ agg_f,
                              int* __restrict__ first_head, int n) {
  __shared__ float s_v[kWarps];
  __shared__ int s_f[kWarps];
  __shared__ int s_first;
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool in = i < n;
  const float v = in ? values[i] : -INFINITY;
  const bool h = in && heads[i] != 0;
  if (threadIdx.x == 0) s_first = kTile;
  __syncthreads();
  if (h) atomicMin(&s_first, (int)threadIdx.x);
  bool any;
  const float r = block_seg_scan(h, v, &any, s_v, s_f);
  if (in) out[i] = r;
  const int last = min(kTile, n - (int)blockIdx.x * kTile) - 1;
  if ((int)threadIdx.x == last) {
    agg_v[blockIdx.x] = r;
    agg_f[blockIdx.x] = any ? 1 : 0;
  }
  if (threadIdx.x == 0) first_head[blockIdx.x] = s_first;
}

// carry[b] = the global inclusive value at the last element of tile b-1
// (NEG for b = 0): an exclusive segmented scan of the tile aggregates.
__global__ void seg_scan_carry(const float* __restrict__ agg_v,
                               const int* __restrict__ agg_f,
                               float* __restrict__ carry, int nb) {
  __shared__ float s_v[kWarps];
  __shared__ int s_f[kWarps];
  __shared__ float s_run;
  if (threadIdx.x == 0) {
    s_run = kNeg;
    carry[0] = kNeg;
  }
  __syncthreads();
  for (int base = 0; base < nb; base += kTile) {
    const int b = base + threadIdx.x;
    const bool in = b < nb;
    const float run = s_run;
    bool any;
    const float r = block_seg_scan(in && agg_f[b] != 0,
                                   in ? agg_v[b] : -INFINITY, &any, s_v, s_f);
    const float incl = any ? r : kmax(run, r);
    if (in) carry[b + 1] = incl;
    if (b == min(base + kTile, nb) - 1) s_run = incl;
    __syncthreads();
  }
}

__global__ void seg_scan_fix(float* __restrict__ out,
                             const float* __restrict__ carry,
                             const int* __restrict__ first_head, int n) {
  const int i = blockIdx.x * kTile + threadIdx.x;
  if (i < n && (int)threadIdx.x < first_head[blockIdx.x]) {
    out[i] = kmax(out[i], carry[blockIdx.x]);
  }
}

}  // namespace

// fscratch holds 2*nb+1 floats (tile aggregates, then nb+1 carries);
// iscratch holds 2*nb ints (aggregate flags, then first-head offsets),
// with nb = ceil(n / 256).
extern "C" int seg_scan_launch(const float* values, const unsigned char* heads,
                               float* out, float* fscratch, int* iscratch,
                               int n, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n > 0) {
    const int nb = (n + kTile - 1) / kTile;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* agg_v = fscratch;
    float* carry = fscratch + nb;
    int* agg_f = iscratch;
    int* first = iscratch + nb;
    seg_scan_tile<<<nb, kTile, 0, s>>>(values, heads, out, agg_v, agg_f,
                                      first, n);
    seg_scan_carry<<<1, kTile, 0, s>>>(agg_v, agg_f, carry, nb);
    seg_scan_fix<<<nb, kTile, 0, s>>>(out, carry, first, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* seg_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
