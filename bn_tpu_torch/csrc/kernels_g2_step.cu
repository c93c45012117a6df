// The two steps of the G2 line-coefficient precompute: double_step and
// madd_step.  They replace the Pallas TPU kernels double_step and madd_step
// (bn_tpu/ops/tower_pallas.py, bodies _double_step_body and _madd_step_body),
// which keep a whole step of the 102-step ladder on chip instead of sending
// each of its Fq2 operations through device memory.
//
// One thread owns one batch element: it loads the running point (three Fq2),
// for madd_step the affine base point (two Fq2), runs the whole formula in
// registers (g2_double_step / g2_madd_step in tower.cuh, reduced after every
// product, which gives the same canonical limbs as the TPU bodies' lazy
// reduction) and stores the new point and the three line coefficients.  The
// caller names both destinations, so the ladder writes each step's
// coefficients straight into its slice of the (102, 3, 2, 16, B) result.
// 28 and 37 base-field products of 136 multiply-adds against 9*128 and 13*128
// bytes moved: integer multiply-add throughput bounds both on an H100.  The
// constants 1/2 and the twist's b are kernel arguments in Montgomery form,
// derived on the host; none is typed in here.  Both kernels are Fq2-sized
// formulas that build in seconds, so they share this file.  It is built with
// -DBN_MUL_OUT_OF_LINE (ops/build.py): 28 to 37 inlined copies of the product
// ran half as fast as calls to one copy, and spilled.
#include "launch.cuh"
#include "tower.cuh"

#define BN_BLOCK_STEP 64

__global__ void __launch_bounds__(BN_BLOCK_STEP)
k_double_step(const int32_t* __restrict__ r, int32_t* __restrict__ r_out, int32_t* __restrict__ c_out,
              int64_t rows, int64_t B, Fq two_inv, Fq2 twist_b, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t off = (t / B) * 6 * BN_NLIMB * B + (t % B);
  G2Proj p = g2_load(r + off, B);
  EllCoeffs c;
  g2_double_step(p, c, two_inv, twist_b, m);
  g2_store(r_out + off, B, p);
  ell_store(c_out + off, B, c);
}

__global__ void __launch_bounds__(BN_BLOCK_STEP)
k_madd_step(const int32_t* __restrict__ r, const int32_t* __restrict__ base, int32_t* __restrict__ r_out,
            int32_t* __restrict__ c_out, int64_t rows, int64_t B, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t row = t / B, b = t % B;
  int64_t off = row * 6 * BN_NLIMB * B + b;
  const int32_t* bp = base + row * 4 * BN_NLIMB * B + b;
  G2Proj p = g2_load(r + off, B);
  EllCoeffs c;
  g2_madd_step(p, c, fq2_load(bp, B), fq2_load(bp + 2 * BN_NLIMB * B, B), m);
  g2_store(r_out + off, B, p);
  ell_store(c_out + off, B, c);
}

static inline Fq bn_make_fq(const uint32_t* words) {
  Fq r;
  for (int i = 0; i < BN_NW; i++) r.w[i] = words[i];
  return r;
}

extern "C" {

// two_inv: eight words; twist_b: sixteen words (c0 then c1); both on the host.
int bn_double_step(const void* r, void* r_out, void* c_out, long long rows, long long B,
                   const uint32_t* two_inv, const uint32_t* twist_b, const uint32_t* mod, uint32_t inv,
                   void* stream) {
  Fq2 tb;
  tb.c0 = bn_make_fq(twist_b);
  tb.c1 = bn_make_fq(twist_b + BN_NW);
  k_double_step<<<bn_grid(rows * B, BN_BLOCK_STEP), BN_BLOCK_STEP, 0, (cudaStream_t)stream>>>(
      (const int32_t*)r, (int32_t*)r_out, (int32_t*)c_out, rows, B, bn_make_fq(two_inv), tb,
      bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}

int bn_madd_step(const void* r, const void* base, void* r_out, void* c_out, long long rows,
                 long long B, const uint32_t* mod, uint32_t inv, void* stream) {
  k_madd_step<<<bn_grid(rows * B, BN_BLOCK_STEP), BN_BLOCK_STEP, 0, (cudaStream_t)stream>>>(
      (const int32_t*)r, (const int32_t*)base, (int32_t*)r_out, (int32_t*)c_out, rows, B,
      bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}

}  // extern "C"
