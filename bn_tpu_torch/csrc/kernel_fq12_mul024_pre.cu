// Sparse line multiply with pre-scaled coefficients.  Replaces the Pallas TPU
// kernel fq12_mul024_pre (bn_tpu/ops/tower_pallas.py:1047, body
// _fq12_mul024_pre_body, lazy formula _k12_mul024_lazy); the Miller loop
// calls it once per ladder step.  f is an Fq12 element and the product is
// f * ((x0 + x2 v) + x4 v w), the line's x0, x2, x4 read from ell0 and the
// (2, 2) struct `scaled` as fq12_mul024_team.cuh lays them out (LineScaled).
//
// What bounds it on an H100: integer multiply-add throughput, 39 base-field
// products of 136 32x32->64-bit multiply-adds each per element, against
// (12 + 2 + 4 + 12) * 64 bytes moved per element.
//
// The design: a team of 13 warps for each group of 32 elements, 416 threads a
// block; warp w is member w of csrc/fq12_mul024_team.cuh, one of the 13
// independent Fq2 products (3 Montgomery products) on the coefficients it
// loads and sums itself.  The products go to 26,624 bytes of shared memory;
// after one barrier warps 0-5 each combine one output Fq2 and store it
// (fq12_team_block in fq12_team.cuh).  One thread per element ran the 39
// products one after another with 255 registers and spills, and gave the
// card 2 warps a multiprocessor at B = 8192; here a thread holds one Fq2
// product's operands and a multiprocessor 13 warps.  The product, the Fq2
// additions and xi are calls (-DBN_MUL_OUT_OF_LINE, and fq12_team.cuh);
// __launch_bounds__ asks registers for two blocks a multiprocessor
// (BN_MUL024_MIN_BLOCKS): 256 blocks at B = 8192 are then one wave, and one block's
// combine can overlap the other's members (fewer registers, some spill:
// faster all the same).  tools/torch_kernel_variants.py times the team
// against the one-thread design and against registers for one block,
// tools/torch_fq12_team_phases.py a block's phases.
#include "launch.cuh"
#include "fq12_mul024_team.cuh"

__global__ void __launch_bounds__(BN_MUL024_BLOCK, BN_MUL024_MIN_BLOCKS)
k_fq12_mul024_pre(const int32_t* __restrict__ f, const int32_t* __restrict__ ell0,
                  const int32_t* __restrict__ scaled, int32_t* __restrict__ o, int64_t rows,
                  int64_t B, Mod m) {
  TeamNoMarks marks;
  fq12_team_block<BN_MUL024_MEMBERS>(o, rows, B, m, fq12_mul024_member(Fq12Global{f}, LineScaled{ell0, scaled}),
                                     Fq12Mul024Combine(), marks);
}

extern "C" int bn_fq12_mul024_pre(const void* f, const void* ell0, const void* scaled, void* o,
                                  long long rows, long long B, const uint32_t* mod, uint32_t inv,
                                  void* stream) {
  k_fq12_mul024_pre<<<bn_grid(rows * B, BN_TEAM_LANES), BN_MUL024_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)f, (const int32_t*)ell0, (const int32_t*)scaled, (int32_t*)o, rows, B,
      bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}

// What bn_fq12_mul024_pre launches for rows * B elements (bn_launch_dims).
extern "C" int bn_fq12_mul024_pre_launch(long long rows, long long B, long long* out) {
  return bn_launch_dims(k_fq12_mul024_pre, BN_TEAM_LANES, BN_MUL024_BLOCK, rows * B, out);
}
