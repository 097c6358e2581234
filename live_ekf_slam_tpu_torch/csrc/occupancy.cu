// What the card makes of a kernel's launch shape: its registers, local
// memory (spills) and static shared memory a thread or block, and how many
// of its blocks fit on one SM at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). A measurement for the
// records; no kernel of the port calls it.
#include <cuda_runtime.h>

// fn: the kernel's host function; threads and smem (dynamic shared bytes)
// a block as the kernel's launcher sets them. out: registers a thread,
// local bytes a thread, static shared bytes a block, blocks an SM.
extern "C" int les_kernel_occupancy(const void* fn, int threads, int smem,
                                    int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                    (size_t)smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = blocks;
  return (int)e;
}
