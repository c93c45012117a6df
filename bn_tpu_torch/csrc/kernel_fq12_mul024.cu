// Sparse line multiply with the line as the precompute emits it.  Replaces the
// Pallas TPU kernel fq12_mul024 (bn_tpu/ops/tower_pallas.py, body
// _fq12_mul024_body), which tower.fq12_mul_by_024 calls.
//
// f is an Fq12 element and `coeff` the (3, 2) struct (ell_0, ell_vw, ell_vv),
// unscaled; the product is f * ((ell_0 + ell_vv v) + ell_vw v w).  Against
// kernel_fq12_mul024_pre.cu only the loads differ: the unscaled struct holds
// ell_vw in slot 1 and ell_vv in slot 2, and fq12_mul_by_024 takes them as
// x4 and x2 (fq12_mul_by_line in tower.cuh).
//
// One thread owns one element and reduces after every product: 39 base-field
// products of 136 multiply-adds against (12 + 6 + 12) * 64 bytes moved per
// element, so integer multiply-add throughput bounds it on an H100.  Register
// pressure and block size as in kernel_fq12_mul.cu; built with
// -DBN_MUL_OUT_OF_LINE (ops/build.py) like the other Fq12 kernels.
#include "launch.cuh"
#include "tower.cuh"

#define BN_BLOCK12 64

__global__ void __launch_bounds__(BN_BLOCK12)
k_fq12_mul024(const int32_t* __restrict__ f, const int32_t* __restrict__ coeff, int32_t* __restrict__ o,
              int64_t rows, int64_t B, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t row = t / B, b = t % B;
  int64_t off = row * 12 * BN_NLIMB * B + b;
  EllCoeffs c = ell_load(coeff + row * 6 * BN_NLIMB * B + b, B);
  fq12_store(o + off, B, fq12_mul_by_line(fq12_load(f + off, B), c, m));
}

extern "C" int bn_fq12_mul024(const void* f, const void* coeff, void* o, long long rows, long long B,
                              const uint32_t* mod, uint32_t inv, void* stream) {
  k_fq12_mul024<<<bn_grid(rows * B, BN_BLOCK12), BN_BLOCK12, 0, (cudaStream_t)stream>>>(
      (const int32_t*)f, (const int32_t*)coeff, (int32_t*)o, rows, B, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}
