// A run of n cyclotomic squarings, a^(2^n).  Replaces the Pallas TPU kernel
// fq12_cyclo_sq_chain (bn_tpu/ops/tower_pallas.py:1020, body
// _fq12_cyclo_chain_body), where the squaring count is the innermost grid axis
// and the value stays on chip in the output block between grid steps.  The
// final exponentiation's three NAF ladders are made of 69 such runs of 2 to 5.
//
// What bounds it on an H100: integer multiply-add throughput from n = 2 on,
// n * 18 base-field products of 136 32x32->64-bit multiply-adds each per
// element, against 2 * 12 * 64 bytes moved once whatever n (bound by bytes at
// n = 1).
//
// The design: a team of 6 warps for each group of 32 elements, 192 threads a
// block; lane l of every warp works on element blockIdx.x * 32 + l.  The block
// loads its 32 elements once into 12,288 bytes of shared memory (the state),
// and a loop inside the block takes the place of the TPU's sequential grid
// axis: each squaring, warp w computes Fq2 product w of csrc/
// fq12_cyclo_team.cuh (3 Montgomery products) into another 12,288 bytes, a
// barrier, then warp w combines new coefficient w in place, a barrier.  After
// n squarings the block stores the state once (fq12_cyclo_team_block, the
// block's skeleton).  n is a run-time argument, so one build serves every n.
//
// What that does about the latency: one thread per element ran 18 dependent
// products a squaring with 255 registers and spills, and at B = 8192 gave the
// card 128 blocks of 2 warps, 2 warps a multiprocessor.  Here a thread holds
// one Fq2 product's operands, __launch_bounds__ lets two blocks share a
// multiprocessor (12 warps; 256 blocks at B = 8192, one wave on 132), and the
// element never leaves the chip between squarings.  Two blocks on one
// multiprocessor do run at once and take 1.6 times one block's time, so the
// multiprocessor's instruction issue, not the products' latency, is what is
// left (a member's three products as one interleaved call ran slower).  The
// product, the Fq2 additions and xi are calls (-DBN_MUL_OUT_OF_LINE, and
// fq12_team.cuh); tools/torch_kernel_variants.py times each choice, the
// blocks a multiprocessor included (BN_CYCLO_MIN_BLOCKS), and
// tools/torch_fq12_team_phases.py splits a block's cycles into its phases
// and reads which blocks ran at once.
#include "launch.cuh"
#include "fq12_cyclo_team.cuh"

__global__ void __launch_bounds__(BN_CYCLO_BLOCK, BN_CYCLO_MIN_BLOCKS)
k_fq12_cyclo_sq_chain(const int32_t* __restrict__ a, int32_t* __restrict__ o, int64_t rows, int64_t B,
                      int n, Mod m) {
  TeamNoMarks marks;
  fq12_cyclo_team_block(a, o, rows, B, n, m, Fq12CycloMember(), marks);
}

extern "C" int bn_fq12_cyclo_sq_chain(const void* a, void* o, long long rows, long long B, int n,
                                      const uint32_t* mod, uint32_t inv, void* stream) {
  k_fq12_cyclo_sq_chain<<<bn_grid(rows * B, BN_TEAM_LANES), BN_CYCLO_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)o, rows, B, n, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}

// What bn_fq12_cyclo_sq_chain launches for rows * B elements (bn_launch_dims).
extern "C" int bn_fq12_cyclo_sq_chain_launch(long long rows, long long B, long long* out) {
  return bn_launch_dims(k_fq12_cyclo_sq_chain, BN_TEAM_LANES, BN_CYCLO_BLOCK, rows * B, out);
}
