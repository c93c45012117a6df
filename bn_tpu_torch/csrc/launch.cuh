// What every kernel file shares: the C interface's conventions and the launch
// arithmetic.
//
// Each extern "C" entry takes device pointers (tensor.data_ptr()), sizes, the
// eight modulus words and -m^-1 mod 2^32 from the host, and the CUDA stream
// PyTorch is using.  It launches on that stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() as an int (0 = launched).
#pragma once

#include <cuda_runtime.h>

#include "fq.cuh"

static inline Mod bn_make_mod(const uint32_t* words, uint32_t inv) {
  Mod m;
  for (int i = 0; i < BN_NW; i++) m.w[i] = words[i];
  m.inv = inv;
  return m;
}

static inline unsigned bn_grid(long long n, int block) {
  return (unsigned)((n + block - 1) / block);
}

// What a kernel that gives `per_block` elements to a block of `threads`
// threads launches for n elements, as the loaded library has it: out[0]
// blocks, out[1] threads a block, out[2] static shared bytes of `kernel`
// (cudaFuncGetAttributes, -1 when it fails).  Returns that call's error code.
// The team kernels' bn_<name>_launch entries report through it.
template <class Kernel>
static int bn_launch_dims(Kernel kernel, int per_block, int threads, long long n, long long* out) {
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  out[0] = bn_grid(n, per_block);
  out[1] = threads;
  out[2] = rc == cudaSuccess ? (long long)attr.sharedSizeBytes : -1;
  return (int)rc;
}

// Lets `kernel` take `bytes` of dynamic shared memory: a launch above 48 KB
// needs the kernel's attribute raised first, once on each device (at the
// first launch there, before any graph capture that follows it).  `raised`
// is the kernel's own flag a device, BN_DEVICES of them.
#define BN_DEVICES 64
template <class Kernel>
static int bn_raise_shared(Kernel kernel, int bytes, bool* raised) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev < 0 || dev >= BN_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc != cudaSuccess) return (int)rc;
    raised[dev] = true;
  }
  return 0;
}

// Global thread index as a 64-bit value.
__device__ __forceinline__ int64_t bn_tid() {
  return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}
