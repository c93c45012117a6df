// One step of the Miller loop in one launch.  Replaces the Pallas TPU kernel
// miller_step (bn_tpu/ops/tower_pallas.py, body _miller_step_body, built as
// the two kinds miller_sq_step and miller_step), which bn_tpu/ate.py runs once
// per ladder step under BN_TPU_FUSED_MILLER=1.
//
// One thread owns one batch element: it loads f (an Fq12), the step's line
// coefficients (ell_0, ell_vw, ell_vv) as the precompute emitted them and the
// affine G1 point (px, py), squares f on a doubling step, scales ell_vw by py
// and ell_vv by px and multiplies the line in sparsely (fq12_miller_step in
// tower.cuh), then stores f.  The hoisted loop of ate.py does the same work in
// two launches a step (fq12_sq, fq12_mul024_pre) after one scaling of all 102
// steps; here f stays in registers between the square and the multiply.
//
// 79 base-field products of 136 multiply-adds with the square, 43 without,
// against (12 + 6 + 1 + 1 + 12) * 64 bytes moved per element: integer
// multiply-add throughput bounds it on an H100.  kSquare is a template
// parameter, so each kind is its own entry, and the C entry's `square` flag
// picks one, as kernels_curve.cu picks G1 or G2.  f, the coefficients and the
// two coordinates are 160 words a thread, more than the 255 registers hold
// with the square's temporaries: built with -DBN_MUL_OUT_OF_LINE
// (ops/build.py) like the other Fq12 kernels.  The result goes to a
// destination the wrapper names, never an operand (__restrict__).
#include "launch.cuh"
#include "tower.cuh"

#define BN_BLOCK12 64

template <bool kSquare>
__global__ void __launch_bounds__(BN_BLOCK12)
k_miller_step(const int32_t* __restrict__ f, const int32_t* __restrict__ coeff, const int32_t* __restrict__ px,
              const int32_t* __restrict__ py, int32_t* __restrict__ o, int64_t rows, int64_t B, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t row = t / B, b = t % B;
  int64_t off = row * 12 * BN_NLIMB * B + b;
  int64_t off1 = row * BN_NLIMB * B + b;
  EllCoeffs c = ell_load(coeff + row * 6 * BN_NLIMB * B + b, B);
  Fq12 r = fq12_miller_step<kSquare>(fq12_load(f + off, B), c, fq_load(px + off1, B), fq_load(py + off1, B), m);
  fq12_store(o + off, B, r);
}

// square = 1: a doubling step (f^2 first); square = 0: an addition step.
extern "C" int bn_miller_step(const void* f, const void* coeff, const void* px, const void* py, void* o,
                              long long rows, long long B, int square, const uint32_t* mod, uint32_t inv,
                              void* stream) {
  unsigned grid = bn_grid(rows * B, BN_BLOCK12);
  cudaStream_t s = (cudaStream_t)stream;
  Mod m = bn_make_mod(mod, inv);
  if (square)
    k_miller_step<true><<<grid, BN_BLOCK12, 0, s>>>((const int32_t*)f, (const int32_t*)coeff, (const int32_t*)px,
                                                    (const int32_t*)py, (int32_t*)o, rows, B, m);
  else
    k_miller_step<false><<<grid, BN_BLOCK12, 0, s>>>((const int32_t*)f, (const int32_t*)coeff, (const int32_t*)px,
                                                     (const int32_t*)py, (int32_t*)o, rows, B, m);
  return (int)cudaGetLastError();
}
