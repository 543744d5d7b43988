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
// row, plus its 4-byte index. At 8192 descriptors of 64 bytes that is
// about 1.1 MB, so the kernel's own time is latency: one index load, one
// row load, one store.
//
// Design: block_gather's lane layout, with whole tiles a CTA. A row of U
// copy units (16-byte vectors where the row width and both base pointers
// allow, bytes otherwise) takes L lanes, L the power of two at or above U
// up to 32, so a lane finds its row and its place in it with a shift and
// a mask (the parent kernel divided in 64 bits for every unit, and gave a
// CTA of 128 threads one tile: 96 of them idle at 8 rows of 4 vectors).
// The L lanes of a row load its index together (one broadcast load) and
// issue up to eight 16-byte loads through the read-only path before their
// stores. A CTA owns a whole number of tiles, as many as its 128 threads
// cover in one pass (at least one), so `tile` keeps its meaning: the rows
// of a tile move together, in one CTA. The grid is sized in lanes. Row
// offsets are 64-bit, so a flash table past 2 GiB is read in place.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ long long clamp_row(int r, long long nb) {
  long long s = r < 0 ? r + nb : r;
  return s < 0 ? 0 : (s >= nb ? nb - 1 : s);
}

// T is the copy unit (uint4 or unsigned char), upr the units a row, L the
// lanes a row: thread t of a CTA copies units t % L, t % L + L, ... of its
// rows first + t / L, first + t / L + kThreads / L, ... below `last`.
template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    gather_tiles(const T* __restrict__ flash, const int* __restrict__ idx,
                 T* __restrict__ out, long long nb, long long upr,
                 long long rows_a_cta, long long n) {
  constexpr int kRowsAPass = kThreads / L;
  constexpr int kBatch = 8;  // loads in flight before the stores
  const long long first = static_cast<long long>(blockIdx.x) * rows_a_cta;
  const long long last = min(first + rows_a_cta, n);
  const int lane = threadIdx.x & (L - 1);
  for (long long d = first + threadIdx.x / L; d < last; d += kRowsAPass) {
    const long long row = clamp_row(__ldg(idx + d), nb);
    const T* src = flash + row * upr;
    T* dst = out + d * upr;
    for (long long u0 = lane; u0 < upr; u0 += L * kBatch) {
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
}

template <typename T>
cudaError_t launch(const void* flash, const int* idx, void* out,
                   long long nb, long long row_bytes, long long n, int tile,
                   cudaStream_t s) {
  const long long upr = row_bytes / static_cast<long long>(sizeof(T));
  int lanes = 1;
  while (lanes < upr && lanes < 32) lanes <<= 1;
  const long long tiles_a_cta =
      kThreads / lanes >= tile ? kThreads / lanes / tile : 1;
  const long long rows_a_cta = tiles_a_cta * tile;
  const unsigned blocks =
      static_cast<unsigned>((n + rows_a_cta - 1) / rows_a_cta);
  const T* f = static_cast<const T*>(flash);
  T* o = static_cast<T*>(out);
  switch (lanes) {
    case 1:
      gather_tiles<T, 1><<<blocks, kThreads, 0, s>>>(f, idx, o, nb, upr,
                                                     rows_a_cta, n);
      break;
    case 2:
      gather_tiles<T, 2><<<blocks, kThreads, 0, s>>>(f, idx, o, nb, upr,
                                                     rows_a_cta, n);
      break;
    case 4:
      gather_tiles<T, 4><<<blocks, kThreads, 0, s>>>(f, idx, o, nb, upr,
                                                     rows_a_cta, n);
      break;
    case 8:
      gather_tiles<T, 8><<<blocks, kThreads, 0, s>>>(f, idx, o, nb, upr,
                                                     rows_a_cta, n);
      break;
    case 16:
      gather_tiles<T, 16><<<blocks, kThreads, 0, s>>>(f, idx, o, nb, upr,
                                                      rows_a_cta, n);
      break;
    default:
      gather_tiles<T, 32><<<blocks, kThreads, 0, s>>>(f, idx, o, nb, upr,
                                                      rows_a_cta, n);
      break;
  }
  return cudaGetLastError();
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
  if (n > 0 && num_blocks > 0 && row_bytes > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        vec16 ? launch<uint4>(flash, idx, out, num_blocks, row_bytes, n, tile,
                              s)
              : launch<unsigned char>(flash, idx, out, num_blocks, row_bytes,
                                      n, tile, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* block_gather_tiled_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
