// Per-die flash contention on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/die_contention.py::die_contention
// (_die_contention_kernel): a fold over the epoch's rows in dispatch order
// where every event row i on die c observes
//     b = max(cur[c], ready[i]) + cost[i];  busy[i] = b;  cur[c] = b
// and non-event rows get busy[i] = 0. Returns busy (N,) and the advanced
// cursors (K,).
//
// Bound on this card: neither bytes nor operations — the fold is a chain
// of dependent adds per die. The bytes are 13 B per row in and 4 B out
// (about 136 KiB at N = 8192), which HBM moves in well under a
// microsecond; the chain of loads and shuffles over N/32 chunks sets the
// time.
//
// Design. The TPU kernel ran the fold on one core, over all dies at once.
// The dies are independent, so here one warp owns one die: it walks the
// rows in chunks of 32, finds its die's event rows with __ballot_sync and
// folds them lowest lane first — row order — with the cursor in a
// register (every lane holds the same cursor; the owning lane keeps its
// row's value). Each die's fold is the sequential one, operation for
// operation (max then one correctly rounded add, never contracted), so the
// result is bit-identical to the sequential fold for any input with chip
// in [0, K). The warp of die 0 also writes the zeros of non-event rows, so
// every output element is written exactly once.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float kmax(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return b > a ? b : a;
}

__global__ void die_contention_kernel(const float* __restrict__ ready,
                                      const float* __restrict__ cost,
                                      const int* __restrict__ chip,
                                      const unsigned char* __restrict__ event,
                                      const float* __restrict__ chip_busy,
                                      float* __restrict__ busy,
                                      float* __restrict__ cur_out, int n,
                                      int k) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (c >= k) return;  // the whole warp leaves together
  float cur = chip_busy[c];
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool in = i < n;
    const bool ev = in && event[i] != 0;
    const bool mine = ev && chip[i] == c;
    const float r = mine ? ready[i] : 0.0f;
    const float co = mine ? cost[i] : 0.0f;
    unsigned m = __ballot_sync(kFull, mine);
    float b_mine = 0.0f;
    while (m) {
      const int l = __ffs(m) - 1;
      const float rl = __shfl_sync(kFull, r, l);
      const float cl = __shfl_sync(kFull, co, l);
      cur = __fadd_rn(kmax(cur, rl), cl);
      if (lane == l) b_mine = cur;
      m &= m - 1;
    }
    if (mine) {
      busy[i] = b_mine;
    } else if (c == 0 && in && !ev) {
      busy[i] = 0.0f;
    }
  }
  if (lane == 0) cur_out[c] = cur;
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
  if (k > 0) {
    const int blocks = (k + kWarpsPerBlock - 1) / kWarpsPerBlock;
    die_contention_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        ready, cost, chip, event, chip_busy, busy, cur_out, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* die_contention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
