// Fq12 product kernel.  Replaces the Pallas TPU kernel fq12_mul
// (bn_tpu/ops/tower_pallas.py, body _fq12_mul_body).
//
// The TPU kernel keeps a whole (8, 128) tile of 1024 elements per limb in
// vector registers and reduces lazily.  Here one thread owns one Fq12 element
// and reduces after every product (the formulas of _k12_mul), which gives the
// same canonical result.
//
// What bounds it on an H100: integer multiply-add throughput, 54 base-field
// products of 136 multiply-adds each, against 3*12*64 bytes moved per
// element.  Two operands and a result are 288 words, more than the 255
// registers a thread may hold, so the compiler spills to local memory; this
// first version accepts that, and uses small blocks (64 threads) so that a
// batch of 8192 spreads over 128 of the 132 multiprocessors.
#include "launch.cuh"
#include "tower.cuh"

#define BN_BLOCK12 64

__global__ void __launch_bounds__(BN_BLOCK12)
k_fq12_mul(const int32_t* __restrict__ a, const int32_t* __restrict__ b, int32_t* __restrict__ o,
           int64_t rows, int64_t B, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  // element (row, b): twelve coefficients at (row*12 + k)*16*B + b
  int64_t off = (t / B) * 12 * BN_NLIMB * B + (t % B);
  fq12_store(o + off, B, fq12_mul(fq12_load(a + off, B), fq12_load(b + off, B), m));
}

extern "C" int bn_fq12_mul(const void* a, const void* b, void* o, long long rows, long long B,
                           const uint32_t* mod, uint32_t inv, void* stream) {
  k_fq12_mul<<<bn_grid(rows * B, BN_BLOCK12), BN_BLOCK12, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)o, rows, B, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}
