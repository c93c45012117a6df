// Fq12 product kernel.  Replaces the Pallas TPU kernel fq12_mul
// (bn_tpu/ops/tower_pallas.py:1002, body _fq12_mul_body, lazy formula
// _k12_mul_lazy), with its lazy reduction: 54 base-field products kept
// whole and 12 Montgomery reductions, one per output coefficient.
//
// What bounds it on an H100: integer multiply-add throughput, 54 whole
// products of 64 32x32->64-bit products (128 multiply-adds) and 12
// reductions of 136 per element, 8,544 multiply-adds against the 14,688 of
// 54 reduced products, and 3 * 12 * 64 = 2,304 bytes moved per element (two
// operands, one result).
//
// The design (fq12_mul_team.cuh): a team of 18 warps for each group of 32
// elements, 576 threads a block, in three phases.  Twelve warps stage the
// block's operands in shared memory, each base-field coefficient loaded once,
// with the sums a.c0 + a.c1 and b.c0 + b.c1 of the third Fq6 product; after a
// barrier warp w is member w: it reads its Fq2 product's operands
// from the stage, takes its three whole products and stores two 16-word
// values; after a second barrier warps 0-11 each sum one output base-field
// coefficient's terms (up to 21 scratch entries, each 16 independent 64-bit
// multiply-adds), reduce it once and store it; warps 12-17 are done.
// 110,592 bytes of dynamic shared memory a block.  The earlier team loaded its
// operands member by member, reduced every product at once, and 6 warps
// combined 6 Fq2 outputs with about 32 modular additions each while the
// other 12 waited.
#include "launch.cuh"
#include "fq12_mul_team.cuh"

#define BN_FQ12_MUL_BLOCK (BN_TEAM_LANES * BN_TEAM_MEMBERS)

__global__ void __launch_bounds__(BN_FQ12_MUL_BLOCK, 1)
k_fq12_mul(const Fq12MulTeam team, int64_t n, int64_t B, Mod m) {
  extern __shared__ __align__(16) unsigned char bn_fq12_mul_scratch[];
  TeamNoMarks marks;
  team_block_on(team, *reinterpret_cast<Fq12MulTeam::Shared*>(bn_fq12_mul_scratch), n, B, m, marks);
}

// The modulus must be q.  The shared memory is dynamic, above 48 KB.
extern "C" int bn_fq12_mul(const void* a, const void* b, void* o, long long rows, long long B,
                           const uint32_t* mod, uint32_t inv, void* stream) {
  static bool raised[BN_DEVICES];
  if (!fq12_mul_modulus_is_q(mod)) return (int)cudaErrorInvalidValue;
  const int bytes = (int)sizeof(Fq12MulTeam::Shared);
  const int rc = bn_raise_shared(k_fq12_mul, bytes, raised);
  if (rc != 0) return rc;
  const Fq12MulTeam team{(const int32_t*)a, (const int32_t*)b, (int32_t*)o};
  k_fq12_mul<<<bn_grid(rows * B, BN_TEAM_LANES), BN_FQ12_MUL_BLOCK, bytes, (cudaStream_t)stream>>>(
      team, rows * B, B, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}

// What bn_fq12_mul launches for rows * B elements (bn_launch_dims, the
// dynamic scratch added to the shared bytes).
extern "C" int bn_fq12_mul_launch(long long rows, long long B, long long* out) {
  const int rc = bn_launch_dims(k_fq12_mul, BN_TEAM_LANES, BN_FQ12_MUL_BLOCK, rows * B, out);
  if (out[2] >= 0) out[2] += (long long)sizeof(Fq12MulTeam::Shared);
  return rc;
}
