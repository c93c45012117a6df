// Cyclotomic squaring kernel (Granger-Scott).  Replaces the Pallas TPU kernel
// fq12_cyclo_sq (bn_tpu/ops/tower_pallas.py:1015, body _fq12_cyclo_sq_body);
// the unfused final exponentiation calls it 189 times, the fused one 3 times
// (the squarings that stand alone between its ladders' runs).
//
// What bounds it on an H100: the bytes, 2 * 12 * 64 a element in and out,
// against 18 base-field products of 136 multiply-adds.
//
// The design: the squaring chain's team (csrc/fq12_cyclo_team.cuh) for one
// squaring, on the product teams' skeleton (fq12_team_block in
// fq12_team.cuh): 6 warps on 32 elements, 192 threads a block; warp w reads
// Granger-Scott pair w / 2 of its lane's element from device memory and
// computes Fq2 product w % 2 of it (3 Montgomery products) into 12,288 bytes
// of shared memory; after one barrier warp c reads old coefficient c again
// and combines and stores new coefficient c.  One thread an element ran the
// 18 products one after another with 255 registers and spills and gave the
// card 2 warps a multiprocessor at B = 8192; the chain's block at n = 1
// loads the element into a shared state first and takes three barriers.
// The product, the Fq2 additions and xi are calls (-DBN_MUL_OUT_OF_LINE, and
// fq12_team.cuh); __launch_bounds__ asks registers for two blocks a
// multiprocessor, as the chain does.  tools/torch_kernel_variants.py times
// this team against the chain's block at n = 1 and against the one-thread
// design.
#include "launch.cuh"
#include "fq12_cyclo_team.cuh"

__global__ void __launch_bounds__(BN_CYCLO_BLOCK, BN_CYCLO_MIN_BLOCKS)
k_fq12_cyclo_sq(const int32_t* __restrict__ a, int32_t* __restrict__ o, int64_t rows, int64_t B, Mod m) {
  TeamNoMarks marks;
  fq12_team_block<BN_CYCLO_MEMBERS>(o, rows, B, m, Fq12CycloSqMember{a}, Fq12CycloSqCombine{a}, marks);
}

extern "C" int bn_fq12_cyclo_sq(const void* a, void* o, long long rows, long long B,
                                const uint32_t* mod, uint32_t inv, void* stream) {
  k_fq12_cyclo_sq<<<bn_grid(rows * B, BN_TEAM_LANES), BN_CYCLO_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)o, rows, B, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}

// What bn_fq12_cyclo_sq launches for rows * B elements (bn_launch_dims).
extern "C" int bn_fq12_cyclo_sq_launch(long long rows, long long B, long long* out) {
  return bn_launch_dims(k_fq12_cyclo_sq, BN_TEAM_LANES, BN_CYCLO_BLOCK, rows * B, out);
}
