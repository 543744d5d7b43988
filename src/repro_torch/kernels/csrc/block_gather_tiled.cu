// Tiled batched block copy (row gather) on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/block_gather.py::block_gather_tiled
// (kernel_slice): out[i] = flash[idx[i]] with `tile` copy descriptors per
// grid step, the analogue of a DSA batch descriptor of `tile` entries.
// Indices follow the reference's rule, pinned against its interpret mode:
// a negative index counts from the end, and the result is clamped into
// range (the same rule as block_gather).
//
// Bound on this card: bytes — each descriptor reads one row and writes one
// row, plus its 4-byte index.
//
// Design. The TPU kernel held the whole flash panel in VMEM and looped
// over the tile's descriptors with dynamic row slices, one grid step per
// tile. Here one CTA owns one tile and copies its `tile` rows, 16-byte
// vectors where the row's byte width allows (the wrapper checks both base
// pointers are 16-byte aligned), bytes otherwise. Neighbouring threads move
// neighbouring pieces of one row, so a warp's loads are whole rows.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ long long clamp_row(int r, long long nb) {
  long long s = r < 0 ? r + nb : r;
  return s < 0 ? 0 : (s >= nb ? nb - 1 : s);
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
    gather_tile(const U* __restrict__ flash, const int* __restrict__ idx,
                U* __restrict__ out, long long nb, long long units_per_row,
                int tile) {
  const long long first = static_cast<long long>(blockIdx.x) * tile;
  const long long units = tile * units_per_row;
  U* dst = out + first * units_per_row;
  for (long long u = threadIdx.x; u < units; u += kThreads) {
    const long long j = u / units_per_row;
    dst[u] = flash[clamp_row(idx[first + j], nb) * units_per_row +
                   (u - j * units_per_row)];
  }
}

}  // namespace

// The wrapper guarantees tile >= 1 and n % tile == 0; vec16 != 0 needs
// row_bytes % 16 == 0 and 16-byte aligned base pointers.
extern "C" int block_gather_tiled_launch(const void* flash, const int* idx,
                                         void* out, long long num_blocks,
                                         long long row_bytes, long long n,
                                         int tile, int vec16, int device,
                                         void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (tile < 1 || n % tile) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = n / tile;
  if (tiles > 0 && num_blocks > 0 && row_bytes > 0) {
    if (vec16) {
      gather_tile<uint4><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
          static_cast<const uint4*>(flash), idx, static_cast<uint4*>(out),
          num_blocks, row_bytes / 16, tile);
    } else {
      gather_tile<unsigned char>
          <<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
              static_cast<const unsigned char*>(flash), idx,
              static_cast<unsigned char*>(out), num_blocks, row_bytes, tile);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* block_gather_tiled_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
