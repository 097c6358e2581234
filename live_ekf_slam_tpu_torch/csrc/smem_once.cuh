// Dynamic shared memory beyond the default 48 KB a block, allowed once a
// device for each kernel (the Schur matvec and the Gauss-Newton system): the
// attribute is raised to the most a block can have the first time a launch
// needs more than 48 KB on a device, not at every launch.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace les {

constexpr long kMaxSmem = 227 * 1024;  // the most a block can have (sm_90)
constexpr int kMaxDevices = 64;

// the dynamic shared bytes Kernel may take on each device, as set here (0:
// the default 48 KB)
template <auto Kernel>
std::atomic<int>* smem_allowed() {
  static std::atomic<int> allowed[kMaxDevices];
  return allowed;
}

template <auto Kernel>
cudaError_t allow_smem(long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && smem <= smem_allowed<Kernel>()[dev].load()) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem);
  if (e == cudaSuccess && dev < kMaxDevices) smem_allowed<Kernel>()[dev].store((int)kMaxSmem);
  return e;
}

// after an occupancy query, which set the attribute to its own bytes: the
// next launch on this device sets it anew
template <auto Kernel>
void forget_smem() {
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess && dev < kMaxDevices)
    smem_allowed<Kernel>()[dev].store(0);
}

}  // namespace les
