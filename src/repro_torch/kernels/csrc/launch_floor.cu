// An empty kernel: the device's floor for one launch on this card.
//
// Not a kernel of the port: nothing replaces a TPU kernel here, and no path
// calls it. chip_smoke.py times it as it times a kernel (device ms, card ms
// and host microseconds a call through ctypes), so a kernel whose own time
// is a few microseconds can be read against what any launch costs.
#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" int launch_floor_launch(int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* launch_floor_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
