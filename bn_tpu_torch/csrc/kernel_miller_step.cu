// One step of the Miller loop in one launch.  Replaces the Pallas TPU kernel
// miller_step (bn_tpu/ops/tower_pallas.py:1059, body _miller_step_body, built
// as the two kinds miller_sq_step and miller_step), which bn_tpu/ate.py runs
// once per ladder step under BN_TPU_FUSED_MILLER=1.
//
// f (an Fq12), the step's line coefficients (ell_0, ell_vw, ell_vv) as the
// precompute emitted them and the affine G1 point (px, py): f^2 on a
// doubling step, ell_vw scaled by py and ell_vv by px, and the line
// multiplied in sparsely (fq12_miller_step in tower.cuh).  The hoisted loop
// of ate.py does the same work in two launches a step (fq12_sq,
// fq12_mul024_pre) after one scaling of all 102 steps.
//
// What bounds it on an H100: integer multiply-add throughput, 79 base-field
// products of 136 multiply-adds with the square, 43 without, against
// (12 + 6 + 1 + 1 + 12) * 64 bytes moved per element.
//
// The design: a team of 13 warps for each group of 32 elements, 416 threads a
// block (csrc/miller_step_team.cuh on team_block): six warps load f into a
// state in shared memory, a barrier; fq12_sq's 12 members on the state, a
// barrier, its 6 combines write f^2 over f while two warps scale the line, a
// barrier; the sparse multiply's 13 members on the state, a barrier, its 6
// combines store.  f and f^2 never make a round trip through device memory,
// and the step is one launch.  Without the square the two levels of fq12_sq
// are left out and the line is scaled beside the load.  One thread per
// element, the design before, ran the 79
// products one after another with 255 registers and 868-1,708 bytes of
// spill.  The product, the Fq2 additions and xi are calls
// (-DBN_MUL_OUT_OF_LINE, and team.cuh).  __launch_bounds__ asks registers
// for one block a multiprocessor in the square instance
// (BN_MILLER_SQ_MIN_BLOCKS) and for two in the other (BN_MILLER_MIN_BLOCKS):
// with both teams' code the square instance spills 3.7 KB a thread at the
// 72 registers of two 416-thread blocks, and one block with more registers
// is faster despite the second wave at B = 8192; the other instance holds
// one team's code, and two blocks (86,016 bytes of shared memory) are
// faster, as for the other teams (tools/torch_kernel_variants.py).
// kSquare is a template parameter, so each kind is its own entry, and the C
// entry's `square` flag picks one.  The result goes to a destination the
// wrapper names, never an operand.  tools/torch_kernel_variants.py times the
// team against the one-thread design.
#include "launch.cuh"
#include "miller_step_team.cuh"

template <bool kSquare>
__global__ void __launch_bounds__(BN_MILLER_BLOCK, kSquare ? BN_MILLER_SQ_MIN_BLOCKS : BN_MILLER_MIN_BLOCKS)
k_miller_step(const int32_t* __restrict__ f, const int32_t* __restrict__ coeff, const int32_t* __restrict__ px,
              const int32_t* __restrict__ py, int32_t* __restrict__ o, int64_t rows, int64_t B, Mod m) {
  TeamNoMarks marks;
  team_block(MillerStepTeam<kSquare>{f, coeff, px, py, o}, rows * B, B, m, marks);
}

// square = 1: a doubling step (f^2 first); square = 0: an addition step.
extern "C" int bn_miller_step(const void* f, const void* coeff, const void* px, const void* py, void* o,
                              long long rows, long long B, int square, const uint32_t* mod, uint32_t inv,
                              void* stream) {
  unsigned grid = bn_grid(rows * B, BN_TEAM_LANES);
  cudaStream_t s = (cudaStream_t)stream;
  Mod m = bn_make_mod(mod, inv);
  if (square)
    k_miller_step<true><<<grid, BN_MILLER_BLOCK, 0, s>>>((const int32_t*)f, (const int32_t*)coeff,
                                                         (const int32_t*)px, (const int32_t*)py, (int32_t*)o,
                                                         rows, B, m);
  else
    k_miller_step<false><<<grid, BN_MILLER_BLOCK, 0, s>>>((const int32_t*)f, (const int32_t*)coeff,
                                                          (const int32_t*)px, (const int32_t*)py, (int32_t*)o,
                                                          rows, B, m);
  return (int)cudaGetLastError();
}

// What bn_miller_step launches for rows * B elements (bn_launch_dims; the
// square instance's shared bytes, which the other's equal).
extern "C" int bn_miller_step_launch(long long rows, long long B, long long* out) {
  return bn_launch_dims(k_miller_step<true>, BN_TEAM_LANES, BN_MILLER_BLOCK, rows * B, out);
}
