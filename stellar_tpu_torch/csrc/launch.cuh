// Host-side helpers of the kernels' plain-C entries (ops/_build.py loads
// them with ctypes).
#pragma once
#include <cuda_runtime.h>

// Makes `device` current for its scope and gives the caller's current
// device back at the end, so a call never switches the thread's device.
struct DeviceScope {
  int prev = -1;
  cudaError_t err;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};
