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

// Global thread index as a 64-bit value.
__device__ __forceinline__ int64_t bn_tid() {
  return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}
