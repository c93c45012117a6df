// Fq12 squaring kernel.  Replaces the Pallas TPU kernel fq12_sq
// (bn_tpu/ops/tower_pallas.py:1010, body _fq12_sq_body, lazy formula
// _k12_sq_lazy); the Miller loop calls it once per doubling step.
//
// What bounds it on an H100: integer multiply-add throughput, 36 base-field
// products of 136 32x32->64-bit multiply-adds each per element, against
// 2 * 12 * 64 bytes moved per element.
//
// The design: a team of 12 warps for each group of 32 elements, 384 threads a
// block; warp w is member w of csrc/fq12_sq_team.cuh, one of the 12
// independent Fq2 products of the square's two Fq6 Karatsuba products (3
// Montgomery products) on the coefficients it loads and sums itself.  The
// products go to 24,576 bytes of shared memory; after one barrier warps 0-5
// each combine one output Fq2 and store it (fq12_team_block in
// fq12_team.cuh).  One thread per element ran the 36 products one after
// another with 255 registers and spills, and gave the card 2 warps a
// multiprocessor at B = 8192; here a thread holds one Fq2 product's operands
// and a multiprocessor 12 warps.  The product, the Fq2 additions and xi are
// calls (-DBN_MUL_OUT_OF_LINE, and fq12_team.cuh);
// __launch_bounds__ asks registers for two blocks a multiprocessor
// (BN_SQ_MIN_BLOCKS): 256 blocks at B = 8192 are then one wave, and one block's
// combine can overlap the other's members (fewer registers, some spill:
// faster all the same).  tools/torch_kernel_variants.py times the team
// against the one-thread design and against registers for one block,
// tools/torch_fq12_team_phases.py a block's phases.
#include "launch.cuh"
#include "fq12_sq_team.cuh"

__global__ void __launch_bounds__(BN_SQ_BLOCK, BN_SQ_MIN_BLOCKS)
k_fq12_sq(const int32_t* __restrict__ a, int32_t* __restrict__ o, int64_t rows, int64_t B, Mod m) {
  TeamNoMarks marks;
  fq12_team_block<BN_SQ_MEMBERS>(o, rows, B, m, fq12_sq_member(Fq12Global{a}), Fq12SqCombine(), marks);
}

extern "C" int bn_fq12_sq(const void* a, void* o, long long rows, long long B,
                          const uint32_t* mod, uint32_t inv, void* stream) {
  k_fq12_sq<<<bn_grid(rows * B, BN_TEAM_LANES), BN_SQ_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)o, rows, B, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}

// What bn_fq12_sq launches for rows * B elements (bn_launch_dims).
extern "C" int bn_fq12_sq_launch(long long rows, long long B, long long* out) {
  return bn_launch_dims(k_fq12_sq, BN_TEAM_LANES, BN_SQ_BLOCK, rows * B, out);
}
