// Sparse line multiply with pre-scaled coefficients.  Replaces the Pallas TPU
// kernel fq12_mul024_pre (bn_tpu/ops/tower_pallas.py, body
// _fq12_mul024_pre_body); the Miller loop calls it once per ladder step.
//
// f is an Fq12 element, ell0 an Fq2 element, and `scaled` the pair
// (ell_vw * g1.y, ell_vv * g1.x) as a (2, 2) struct; the product is
// f * ((ell0 + scaled[1] v) + scaled[0] v w).
//
// One thread owns one element and reduces after every product (the formulas
// of _k12_mul_by_024): 39 base-field products of 136 multiply-adds against
// (12 + 2 + 4 + 12)*64 bytes moved per element, so integer multiply-add throughput
// bounds it on an H100.  Register pressure and block size as in
// kernel_fq12_mul.cu.
#include "launch.cuh"
#include "tower.cuh"

#define BN_BLOCK12 64

__global__ void __launch_bounds__(BN_BLOCK12)
k_fq12_mul024_pre(const int32_t* __restrict__ f, const int32_t* __restrict__ ell0,
                  const int32_t* __restrict__ scaled, int32_t* __restrict__ o, int64_t rows,
                  int64_t B, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t row = t / B, b = t % B;
  int64_t off = row * 12 * BN_NLIMB * B + b;
  Fq12 a = fq12_load(f + off, B);
  Fq2 x0 = fq2_load(ell0 + row * 2 * BN_NLIMB * B + b, B);
  const int32_t* s = scaled + row * 4 * BN_NLIMB * B + b;
  Fq2 x4 = fq2_load(s, B);                     // ell_vw * g1.y
  Fq2 x2 = fq2_load(s + 2 * BN_NLIMB * B, B);  // ell_vv * g1.x
  fq12_store(o + off, B, fq12_mul_by_024(a, x0, x2, x4, m));
}

extern "C" int bn_fq12_mul024_pre(const void* f, const void* ell0, const void* scaled, void* o,
                                  long long rows, long long B, const uint32_t* mod, uint32_t inv,
                                  void* stream) {
  k_fq12_mul024_pre<<<bn_grid(rows * B, BN_BLOCK12), BN_BLOCK12, 0, (cudaStream_t)stream>>>(
      (const int32_t*)f, (const int32_t*)ell0, (const int32_t*)scaled, (int32_t*)o, rows, B,
      bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}
