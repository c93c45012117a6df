// The two steps of the G2 line-coefficient precompute: double_step and
// madd_step.  They replace the Pallas TPU kernels double_step and madd_step
// (bn_tpu/ops/tower_pallas.py:1068 and :1077, bodies _double_step_body and
// _madd_step_body), which keep a whole step of the 102-step ladder on chip
// instead of sending each of its Fq2 operations through device memory.  The
// caller names both destinations, so the ladder writes each step's
// coefficients straight into its slice of the (102, 3, 2, 16, B) result.
//
// What bounds them on an H100: integer multiply-add throughput, 28 and 37
// base-field products of 136 32x32->64-bit multiply-adds each per element,
// against 9 * 128 and 13 * 128 bytes moved.
//
// The design: a team of 4 warps for each group of 32 elements, 128 threads a
// block; lane l of every warp works on element blockIdx.x * 32 + l.  A step
// is a chain of dependency levels, so the block loads its elements' inputs
// once into shared memory (the state) and keeps every value of the step
// there: at each level warp w computes one Fq2 product (2 or 3 Montgomery
// products) from the state into a slot of its own, or stores an output whose
// inputs are ready, and a barrier ends the level (g2_step_team_block and the
// schedules G2DoubleTeam, 3 levels, and G2MaddTeam, 4 levels, in
// csrc/g2_step_team.cuh).  The doubling step halves where the formula
// multiplies by 1/2, so it takes 24 products and no constant 1/2.
//
// What that does about the latency: one thread per element ran the 28 or 37
// mostly dependent products one after another in 196 or 251 registers, and at
// B = 8192 gave the card 128 blocks of 2 warps, 2 warps on a multiprocessor.
// Here the longest chain is 9 products (the doubling) or 12 (the addition),
// a thread holds one Fq2 product's operands, and __launch_bounds__ asks
// registers for two blocks a multiprocessor: 256 blocks at B = 8192, one
// wave (registers for four gave the same 96 a thread).  The product, the Fq2 additions, halving and xi are
// calls (-DBN_MUL_OUT_OF_LINE, and fq12_team.cuh).
// tools/torch_kernel_variants.py times the team against the one-thread design,
// tools/torch_fq12_team_phases.py a block's levels.
#include "launch.cuh"
#include "g2_step_team.cuh"

#define BN_DOUBLE_BLOCK (BN_TEAM_LANES * G2DoubleTeam::kMembers)
#define BN_MADD_BLOCK (BN_TEAM_LANES * G2MaddTeam::kMembers)

__global__ void __launch_bounds__(BN_DOUBLE_BLOCK, 2)
k_double_step(const int32_t* __restrict__ r, int32_t* __restrict__ r_out, int32_t* __restrict__ c_out,
              int64_t rows, int64_t B, Fq2 twist_b, Mod m) {
  TeamNoMarks marks;
  g2_step_team_block(G2DoubleTeam{r, twist_b}, r_out, c_out, rows, B, m, marks);
}

__global__ void __launch_bounds__(BN_MADD_BLOCK, 2)
k_madd_step(const int32_t* __restrict__ r, const int32_t* __restrict__ base, int32_t* __restrict__ r_out,
            int32_t* __restrict__ c_out, int64_t rows, int64_t B, Mod m) {
  TeamNoMarks marks;
  g2_step_team_block(G2MaddTeam{r, base}, r_out, c_out, rows, B, m, marks);
}

static inline Fq bn_make_fq(const uint32_t* words) {
  Fq r;
  for (int i = 0; i < BN_NW; i++) r.w[i] = words[i];
  return r;
}

extern "C" {

// twist_b: sixteen words on the host, c0 then c1, in Montgomery form.
int bn_double_step(const void* r, void* r_out, void* c_out, long long rows, long long B,
                   const uint32_t* twist_b, const uint32_t* mod, uint32_t inv, void* stream) {
  Fq2 tb;
  tb.c0 = bn_make_fq(twist_b);
  tb.c1 = bn_make_fq(twist_b + BN_NW);
  k_double_step<<<bn_grid(rows * B, BN_TEAM_LANES), BN_DOUBLE_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)r, (int32_t*)r_out, (int32_t*)c_out, rows, B, tb, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}

int bn_madd_step(const void* r, const void* base, void* r_out, void* c_out, long long rows,
                 long long B, const uint32_t* mod, uint32_t inv, void* stream) {
  k_madd_step<<<bn_grid(rows * B, BN_TEAM_LANES), BN_MADD_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)r, (const int32_t*)base, (int32_t*)r_out, (int32_t*)c_out, rows, B,
      bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}

// What bn_double_step and bn_madd_step launch for rows * B elements (bn_launch_dims).
int bn_double_step_launch(long long rows, long long B, long long* out) {
  return bn_launch_dims(k_double_step, BN_TEAM_LANES, BN_DOUBLE_BLOCK, rows * B, out);
}

int bn_madd_step_launch(long long rows, long long B, long long* out) {
  return bn_launch_dims(k_madd_step, BN_TEAM_LANES, BN_MADD_BLOCK, rows * B, out);
}

}  // extern "C"
