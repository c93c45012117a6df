// A run of n cyclotomic squarings, a^(2^n).  Replaces the Pallas TPU kernel
// fq12_cyclo_sq_chain (bn_tpu/ops/tower_pallas.py, body
// _fq12_cyclo_chain_body), where the squaring count is the innermost grid axis
// and the value stays on chip in the output block between grid steps.  The
// final exponentiation's three NAF ladders are made of 69 such runs of 2 to 5.
//
// Here a loop inside the thread takes the place of that sequential grid axis:
// one thread owns one Fq12 element, loads it once, squares it n times in
// registers (fq12_cyclo_sq in tower.cuh, reduced after every product) and
// stores it once.  n is a run-time argument, so one build serves every n.
// n * 18 base-field products of 136 multiply-adds against 2*12*64 bytes moved
// once whatever n: bound by bytes at n = 1, by integer multiply-add throughput
// from n = 2 on.  Register pressure and block size as in kernel_fq12_mul.cu;
// the loop is not unrolled, so it adds nothing to the pressure of one squaring.
#include "launch.cuh"
#include "tower.cuh"

#define BN_BLOCK12 64

__global__ void __launch_bounds__(BN_BLOCK12)
k_fq12_cyclo_sq_chain(const int32_t* __restrict__ a, int32_t* __restrict__ o, int64_t rows, int64_t B,
                      int n, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t off = (t / B) * 12 * BN_NLIMB * B + (t % B);
  Fq12 v = fq12_load(a + off, B);
#pragma unroll 1
  for (int i = 0; i < n; i++) v = fq12_cyclo_sq(v, m);
  fq12_store(o + off, B, v);
}

extern "C" int bn_fq12_cyclo_sq_chain(const void* a, void* o, long long rows, long long B, int n,
                                      const uint32_t* mod, uint32_t inv, void* stream) {
  k_fq12_cyclo_sq_chain<<<bn_grid(rows * B, BN_BLOCK12), BN_BLOCK12, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)o, rows, B, n, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}
