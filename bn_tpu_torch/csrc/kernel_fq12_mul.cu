// Fq12 product kernel.  Replaces the Pallas TPU kernel fq12_mul
// (bn_tpu/ops/tower_pallas.py:1002, body _fq12_mul_body, lazy formula
// _k12_mul_lazy).
//
// What bounds it on an H100: integer multiply-add throughput, 54 base-field
// products of 136 32x32->64-bit multiply-adds each per element, against
// 3 * 12 * 64 = 2,304 bytes moved per element (two operands, one result).
// The TPU kernel keeps a tile of 1024 elements per limb in vector registers
// and reduces lazily; here every product is reduced at once, which gives the
// same canonical result.
//
// The design: a team of 18 warps for each group of 32 elements, 576 threads a
// block; warp w is member w of csrc/fq12_team.cuh: it loads the coefficients
// its Fq2 product needs (one 128-byte line per limb and warp; the
// coefficients several members read come again from L1) and does 3
// Montgomery products.  The 18 products go to 36,864 bytes of shared memory;
// after one barrier warps 0-5 each combine one output Fq2 and store it
// (fq12_team_block in fq12_team.cuh, the skeleton of every team kernel).
//
// What that does about the latency: one thread per element ran 54 dependent
// products with 288 live words, spilled 2 KB, and at B = 8192 gave two warps
// to each multiprocessor.  Here a thread holds one Fq2 product's operands in
// 96 registers (what ptxas allows at 576 threads a block), and a
// multiprocessor holds 18 warps, so its four schedulers have independent
// products to interleave.  The product, the Fq2 additions and xi are calls
// (-DBN_MUL_OUT_OF_LINE, and fq12_team.cuh): tools/torch_kernel_variants.py
// and tools/torch_fq12_team_phases.py time each choice.
#include "launch.cuh"
#include "fq12_team.cuh"

#define BN_FQ12_MUL_BLOCK (BN_TEAM_LANES * BN_TEAM_MEMBERS)

__global__ void __launch_bounds__(BN_FQ12_MUL_BLOCK, 1)
k_fq12_mul(const int32_t* __restrict__ a, const int32_t* __restrict__ b, int32_t* __restrict__ o,
           int64_t rows, int64_t B, Mod m) {
  TeamNoMarks marks;
  fq12_team_block<BN_TEAM_MEMBERS>(o, rows, B, m, Fq12MulMember{a, b}, Fq12MulCombine(), marks);
}

extern "C" int bn_fq12_mul(const void* a, const void* b, void* o, long long rows, long long B,
                           const uint32_t* mod, uint32_t inv, void* stream) {
  k_fq12_mul<<<bn_grid(rows * B, BN_TEAM_LANES), BN_FQ12_MUL_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)o, rows, B, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}

// What bn_fq12_mul launches for rows * B elements (bn_launch_dims).
extern "C" int bn_fq12_mul_launch(long long rows, long long B, long long* out) {
  return bn_launch_dims(k_fq12_mul, BN_TEAM_LANES, BN_FQ12_MUL_BLOCK, rows * B, out);
}
