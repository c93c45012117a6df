// Cyclotomic squaring kernel (Granger-Scott).  Replaces the Pallas TPU kernel
// fq12_cyclo_sq (bn_tpu/ops/tower_pallas.py, body _fq12_cyclo_sq_body); the
// final exponentiation calls it about 190 times.
//
// One thread owns one Fq12 element and reduces after every product (the
// formulas of _k12_cyclo_sq): 18 base-field products of 136 multiply-adds
// against 2*12*64 bytes moved per element, so integer multiply-add throughput
// bounds it on an H100.  Register pressure and block size as in
// kernel_fq12_mul.cu.
#include "launch.cuh"
#include "tower.cuh"

#define BN_BLOCK12 64

__global__ void __launch_bounds__(BN_BLOCK12)
k_fq12_cyclo_sq(const int32_t* __restrict__ a, int32_t* __restrict__ o, int64_t rows, int64_t B, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t off = (t / B) * 12 * BN_NLIMB * B + (t % B);
  fq12_store(o + off, B, fq12_cyclo_sq(fq12_load(a + off, B), m));
}

extern "C" int bn_fq12_cyclo_sq(const void* a, void* o, long long rows, long long B,
                                const uint32_t* mod, uint32_t inv, void* stream) {
  k_fq12_cyclo_sq<<<bn_grid(rows * B, BN_BLOCK12), BN_BLOCK12, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)o, rows, B, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}
