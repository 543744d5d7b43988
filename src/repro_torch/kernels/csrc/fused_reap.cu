// Fused neutral CQ post on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused_reap.py::fused_reap
// (_fused_reap_kernel): one pass over the epoch's rows in which every
// valid row of CQ c = clip(key, 0, Q-1) writes (done, done, req_id) at
// ring slot (tail[c] + cnt[c]) mod D and bumps cnt[c]; counts = cnt.
//
// Bound on this card: bytes. Rows are read (13 B each) and at most one
// entry of 12 B per valid row is written; about 200 KiB at N = 8192, far
// below a microsecond of HBM time, so launch latency sets the time.
//
// Design. The TPU kernel walked the rows in one sequential grid step. Here
// one block owns one CQ. For each chunk of 256 rows the block counts its
// CQ's valid rows with a ballot and __popc inside each warp and the warp
// totals in shared memory; the running count plus the exclusive warp and
// lane counts is each row's posting rank, hence its slot. Rows of one CQ
// in one chunk that land on the same slot (only when more than D of them
// post in the chunk) are resolved in the kernel: only the last of them
// writes; later chunks write after a __syncthreads, so the last row always
// wins, as in the sequential pass. The slot uses the reference's int32
// arithmetic (wrapping add, floor modulo). The wrapper clones the rings
// and the kernel updates the clones in place. Integer bookkeeping and data
// movement only, so the result is exact for any input.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void fused_reap_kernel(float* __restrict__ done_ring,
                                  float* __restrict__ visible_ring,
                                  int* __restrict__ rid_ring,
                                  const int* __restrict__ tail,
                                  const int* __restrict__ key,
                                  const float* __restrict__ done,
                                  const int* __restrict__ req_id,
                                  const unsigned char* __restrict__ valid,
                                  int* __restrict__ counts, int q, int d,
                                  int n) {
  __shared__ int s_warp[kWarps];
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned t = static_cast<unsigned>(tail[c]);
  int running = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + threadIdx.x;
    const bool in = i < n;
    int kk = in ? key[i] : 0;
    kk = kk < 0 ? 0 : (kk > q - 1 ? q - 1 : kk);
    const bool m = in && valid[i] != 0 && kk == c;
    const unsigned bal = __ballot_sync(kFull, m);
    const int lane_rank = __popc(bal & ((1u << lane) - 1u));
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    int before = 0;
    int total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int cw = s_warp[w];
      before += w < warp ? cw : 0;
      total += cw;
    }
    const int rank = running + before + lane_rank;
    const int chunk_end = running + total;
    if (m && static_cast<long long>(rank) + d >= chunk_end) {
      const int x = static_cast<int>(t + static_cast<unsigned>(rank));
      int pos = x % d;
      if (pos < 0) pos += d;
      const size_t o = static_cast<size_t>(c) * d + pos;
      const float dv = done[i];
      done_ring[o] = dv;
      visible_ring[o] = dv;
      rid_ring[o] = req_id[i];
    }
    running = chunk_end;
    __syncthreads();
  }
  if (threadIdx.x == 0) counts[c] = running;
}

}  // namespace

extern "C" int fused_reap_launch(float* done_ring, float* visible_ring,
                                 int* rid_ring, const int* tail,
                                 const int* key, const float* done,
                                 const int* req_id,
                                 const unsigned char* valid, int* counts,
                                 int q, int d, int n, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (q > 0) {
    fused_reap_kernel<<<q, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        done_ring, visible_ring, rid_ring, tail, key, done, req_id, valid,
        counts, q, d, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_reap_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
