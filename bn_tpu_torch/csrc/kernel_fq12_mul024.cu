// Sparse line multiply with the line as the precompute emits it.  Replaces the
// Pallas TPU kernel fq12_mul024 (bn_tpu/ops/tower_pallas.py:1039, body
// _fq12_mul024_body), which tower.fq12_mul_by_024 calls.
//
// f is an Fq12 element and `coeff` the (3, 2) struct (ell_0, ell_vw, ell_vv),
// unscaled; the product is f * ((ell_0 + ell_vv v) + ell_vw v w).  Against
// kernel_fq12_mul024_pre.cu only the line's loads differ: the unscaled struct
// holds ell_vw in slot 1 and ell_vv in slot 2, and fq12_mul_by_024 takes them
// as x4 and x2 (fq12_mul_by_line in tower.cuh); no scaling.
//
// What bounds it on an H100: integer multiply-add throughput, 39 base-field
// products of 136 32x32->64-bit multiply-adds each per element, against
// (12 + 6 + 12) * 64 bytes moved per element.
//
// The design: fq12_mul024_pre's team (csrc/fq12_mul024_team.cuh on
// fq12_team_block) with the line source LineCoeffs: 13 warps for each group
// of 32 elements, 416 threads a block, one Fq2 product a warp into 26,624
// bytes of shared memory, one barrier, warps 0-5 combine and store.  One
// thread per element, the design before, ran the 39 products one after
// another with 255 registers and 1,288 bytes of spill.  Built with
// -DBN_MUL_OUT_OF_LINE (ops/build.py) like the other Fq12 kernels;
// __launch_bounds__ asks registers for two blocks a multiprocessor, as
// fq12_mul024_pre's.
#include "launch.cuh"
#include "fq12_mul024_team.cuh"

__global__ void __launch_bounds__(BN_MUL024_BLOCK, BN_MUL024_MIN_BLOCKS)
k_fq12_mul024(const int32_t* __restrict__ f, const int32_t* __restrict__ coeff, int32_t* __restrict__ o,
              int64_t rows, int64_t B, Mod m) {
  TeamNoMarks marks;
  fq12_team_block<BN_MUL024_MEMBERS>(o, rows, B, m, fq12_mul024_member(Fq12Global{f}, LineCoeffs{coeff}),
                                     Fq12Mul024Combine(), marks);
}

extern "C" int bn_fq12_mul024(const void* f, const void* coeff, void* o, long long rows, long long B,
                              const uint32_t* mod, uint32_t inv, void* stream) {
  k_fq12_mul024<<<bn_grid(rows * B, BN_TEAM_LANES), BN_MUL024_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)f, (const int32_t*)coeff, (int32_t*)o, rows, B, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}

// What bn_fq12_mul024 launches for rows * B elements (bn_launch_dims).
extern "C" int bn_fq12_mul024_launch(long long rows, long long B, long long* out) {
  return bn_launch_dims(k_fq12_mul024, BN_TEAM_LANES, BN_MUL024_BLOCK, rows * B, out);
}
