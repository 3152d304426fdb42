// What every kernel library of the port shares: the bf16 type, the latent
// width the kernels are built for, the SM count the persistent grids are
// sized by, and the entry point that names a CUDA error code returned by
// the library's launcher. Each source is its own
// library and includes this once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace gfd {

typedef __nv_bfloat16 bf16;

constexpr int H = 128;  // latent width

// Host: the number of SMs of `device` (below 64), read once; 0 on error.
inline int sm_count(int device) {
  static std::atomic<int> count[64];  // 0 until read
  int sms = count[device].load();
  if (sms == 0) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess)
      return 0;
    count[device].store(sms);
  }
  return sms;
}

}  // namespace gfd

// Name of a CUDA error code returned by one of the entry points.
extern "C" const char* gfd_error_name(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
