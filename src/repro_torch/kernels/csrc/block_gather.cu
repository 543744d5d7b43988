// Batched block copy (row gather) on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/block_gather.py::block_gather
// (_gather_kernel): out[i] = flash[idx[i]], one block per copy descriptor,
// the analogue of a DSA batch descriptor. Indices follow JAX's gather: a
// negative one counts from the end, and the result is clamped into range.
//
// Bound on this card: bytes — each descriptor reads one row and writes one
// row (2 x 64 B at the engine's width of 16 f32, plus the 4 B index).
//
// Design. The TPU kernel DMA'd one (1, width) tile per grid step behind a
// scalar-prefetched index. Here each thread copies one 16-byte vector when
// the row's byte width is a multiple of 16 (torch allocations are 256-byte
// aligned and the wrapper checks both base pointers), so neighbouring
// threads read neighbouring 16-byte pieces of a row and a warp moves 512
// bytes (whole rows) per instruction; any other row width is copied byte
// by byte. The element type only enters through its size, so every dtype
// is taken. A grid-stride loop covers any n.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// JAX's gather index rule: a negative index counts from the end, then
// the index is clamped into [0, nb).
__device__ __forceinline__ long long clamp_row(int r, long long nb) {
  long long s = r < 0 ? r + nb : r;
  return s < 0 ? 0 : (s >= nb ? nb - 1 : s);
}

__global__ void gather_vec16(const uint4* __restrict__ flash,
                             const int* __restrict__ idx,
                             uint4* __restrict__ out, long long nb,
                             long long vecs_per_row, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const long long row = t / vecs_per_row;
    const long long k = t - row * vecs_per_row;
    out[t] = flash[clamp_row(idx[row], nb) * vecs_per_row + k];
  }
}

__global__ void gather_bytes(const unsigned char* __restrict__ flash,
                             const int* __restrict__ idx,
                             unsigned char* __restrict__ out, long long nb,
                             long long row_bytes, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const long long row = t / row_bytes;
    const long long k = t - row * row_bytes;
    out[t] = flash[clamp_row(idx[row], nb) * row_bytes + k];
  }
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long units = vec16 ? n * (row_bytes / 16) : n * row_bytes;
  if (units > 0 && num_blocks > 0) {
    long long blocks = (units + kThreads - 1) / kThreads;
    if (blocks > 132LL * 32) blocks = 132LL * 32;
    if (vec16) {
      gather_vec16<<<static_cast<int>(blocks), kThreads, 0, s>>>(
          static_cast<const uint4*>(flash), idx, static_cast<uint4*>(out),
          num_blocks, row_bytes / 16, units);
    } else {
      gather_bytes<<<static_cast<int>(blocks), kThreads, 0, s>>>(
          static_cast<const unsigned char*>(flash), idx,
          static_cast<unsigned char*>(out), num_blocks, row_bytes, units);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* block_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
