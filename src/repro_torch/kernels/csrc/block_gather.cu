// Batched block copy (row gather) on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/block_gather.py::block_gather
// (_gather_kernel): out[i] = flash[idx[i]], one row per copy descriptor,
// the analogue of a DSA batch descriptor. Indices follow JAX's gather: a
// negative one counts from the end, and the result is clamped into range.
//
// Bound on this card: bytes — each descriptor reads one row and writes one
// row (2 x 64 B at the engine's width of 16 f32, plus the 4 B index). At
// the main path's 8192 descriptors that is under 1.1 MB, less than a
// launch costs on the device, so the kernel's own time is latency: one
// index load, then one row load, then one store.
//
// Design. The TPU kernel DMA'd one (1, width) tile per grid step behind a
// scalar-prefetched index. Here a row of U copy units (16-byte vectors
// where the row width and both base pointers allow, bytes otherwise; the
// element type only enters through its size) takes L lanes, L the power
// of two at or above U up to 32, so a warp copies 32 / L rows at once and
// a lane finds its row and its place in it with a shift and a mask: no
// address needs a division (the parent kernel divided in 64 bits for every
// vector). The L lanes of a row load its index together (one broadcast
// load), and each lane issues up to eight 16-byte loads through the
// read-only path before its stores. Row offsets are 64-bit, so a flash
// table past 2 GiB is read in place. The grid has L lanes a descriptor.
// (Spreading 32 descriptors' indices over a warp with __shfl_sync and
// copying their rows one pass after another measured slower on the card:
// the passes serialise what the lanes here do at once.)
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarpsPerBlock = kThreads / 32;

// JAX's gather index rule: a negative index counts from the end, then
// the index is clamped into [0, nb).
__device__ __forceinline__ long long clamp_row(int r, long long nb) {
  long long s = r < 0 ? r + nb : r;
  return s < 0 ? 0 : (s >= nb ? nb - 1 : s);
}

// T is the copy unit (uint4 or unsigned char), upr the units a row, L the
// lanes a row: lane l of a warp copies units l % L, l % L + L, ... of row
// 32 / L * warp + l / L.
template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    gather_rows(const T* __restrict__ flash, const int* __restrict__ idx,
                T* __restrict__ out, long long nb, long long upr,
                long long n) {
  constexpr int kRows = 32 / L;  // rows a warp
  constexpr int kBatch = 8;      // loads in flight before the stores
  const int lane = threadIdx.x & 31;
  const long long d =
      (static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
       (threadIdx.x >> 5)) * kRows + lane / L;
  if (d >= n) return;
  const long long row = clamp_row(__ldg(idx + d), nb);
  const T* src = flash + row * upr;
  T* dst = out + d * upr;
  for (long long u0 = lane % L; u0 < upr; u0 += L * kBatch) {
    T buf[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const long long u = u0 + static_cast<long long>(L) * b;
      if (u < upr) buf[b] = __ldg(src + u);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const long long u = u0 + static_cast<long long>(L) * b;
      if (u < upr) dst[u] = buf[b];
    }
  }
}

template <typename T>
cudaError_t launch(const void* flash, const int* idx, void* out,
                   long long nb, long long row_bytes, long long n,
                   cudaStream_t s) {
  const long long upr = row_bytes / static_cast<long long>(sizeof(T));
  int lanes = 1;
  while (lanes < upr && lanes < 32) lanes <<= 1;
  const long long rows_a_warp = 32 / lanes;
  const long long warps = (n + rows_a_warp - 1) / rows_a_warp;
  const unsigned blocks =
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const T* f = static_cast<const T*>(flash);
  T* o = static_cast<T*>(out);
  switch (lanes) {
    case 1:
      gather_rows<T, 1><<<blocks, kThreads, 0, s>>>(f, idx, o, nb, upr, n);
      break;
    case 2:
      gather_rows<T, 2><<<blocks, kThreads, 0, s>>>(f, idx, o, nb, upr, n);
      break;
    case 4:
      gather_rows<T, 4><<<blocks, kThreads, 0, s>>>(f, idx, o, nb, upr, n);
      break;
    case 8:
      gather_rows<T, 8><<<blocks, kThreads, 0, s>>>(f, idx, o, nb, upr, n);
      break;
    case 16:
      gather_rows<T, 16><<<blocks, kThreads, 0, s>>>(f, idx, o, nb, upr, n);
      break;
    default:
      gather_rows<T, 32><<<blocks, kThreads, 0, s>>>(f, idx, o, nb, upr, n);
      break;
  }
  return cudaGetLastError();
}

}  // namespace

// vec16 != 0 selects the 16-byte path; the caller guarantees row_bytes % 16
// == 0 and 16-byte aligned base pointers for it.
extern "C" int block_gather_launch(const void* flash, const int* idx,
                                   void* out, long long num_blocks,
                                   long long row_bytes, long long n,
                                   int vec16, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n > 0 && num_blocks > 0 && row_bytes > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        vec16 ? launch<uint4>(flash, idx, out, num_blocks, row_bytes, n, s)
              : launch<unsigned char>(flash, idx, out, num_blocks, row_bytes,
                                      n, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* block_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
