// Fixed-exponent power a^e, the Fermat inversion of fields/fp.py.  Replaces
// the Pallas TPU kernel pow_fixed_pallas (bn_tpu/ops/mont_pallas.py, bodies
// _pow_table_body and _pow_ladder_body), which is two calls: one builds the
// window table, one walks the digits as its innermost grid axis and carries
// the running value from grid step to grid step in its output block.
//
// Here nothing carries between blocks and nothing needs to: one launch, the
// whole window-4 ladder as a loop inside the block.  For e = q - 2 that is
// 15 + 63*5 = 330 dependent base-field products of 136 multiply-adds against
// 128 bytes moved, so integer multiply-add throughput bounds it on an H100.
//
// The design: a group of BN_POW_LANES = T consecutive lanes of a warp owns
// one element (csrc/fq_group.cuh): lane j holds words j*W .. j*W + W - 1
// (W = 8 / T) of every value, and each Montgomery product is CIOS split over
// the group, a and mu broadcast by shuffles, the accumulator in carry-save
// form moved down a lane by a shuffle each row, the carries resolved once a
// product by ballots.  A block is 32 elements, 32 * T threads; the grid
// bn_grid(rows * B, 32).  The ladder is a chain of 330 products, so one
// product's time in a warp sets the kernel's: one thread an element ran each
// product's 136 multiply-adds and their carries alone (about 1,100 cycles)
// with 2 warps a multiprocessor at B = 8192; the group runs 8 rows of 4
// multiply-adds a lane and gives the card T times the warps.  What is left
// is the warp's instruction stream: a row is about 21 instructions (the
// multiply-adds, their 64-bit sums, three shuffles), 240 a product with its
// carries resolved, and at B = 8192 two warps share each scheduler, which
// takes 1.26 times as long as one warp alone (B = 32).  Where the card is
// full (B = 16384) the one-thread design, with fewer instructions an element,
// is faster.  T = 4 beats T = 8, whose rows wait on two shuffles each
// (tools/torch_kernel_variants.py).  Lanes past rows * B clamp
// to the last element, take part in every shuffle and ballot (full masks)
// and skip the store.
//
// The table of sixteen entries is indexed by a digit known only at run time,
// so it lies in shared memory, [entry][word][thread]: 16 x 8 words x 32
// elements = 16 KB a block whatever T, and since the digit is the same for
// every thread a warp reads 32 neighbouring banks.  The exponent (eight words
// and a digit count) and the Montgomery one are kernel arguments, so one
// build serves every exponent and both moduli and nothing is uploaded per
// call; their words are read by selects, not by an index into the argument
// (which would copy it to local memory).
// tools/torch_kernel_variants.py times T = 4 against T = 8 and the group
// against the one-thread design it replaced.
#include "launch.cuh"
#include "fq_group.cuh"

#ifndef BN_POW_LANES
#define BN_POW_LANES 4  // lanes of a group: 4 or 8
#endif
#define BN_POW_BLOCK (BN_TEAM_LANES * BN_POW_LANES)
#define BN_POW_MIN_BLOCKS 2  // blocks a multiprocessor that __launch_bounds__ asks registers for

static_assert(BN_POW_LANES == 4 || BN_POW_LANES == 8, "a group of 4 or 8 lanes");

__global__ void __launch_bounds__(BN_POW_BLOCK, BN_POW_MIN_BLOCKS)
k_pow_fixed(const int32_t* __restrict__ a, int32_t* __restrict__ o, int64_t rows, int64_t B, Exp e, Fq one,
            Mod m) {
  __shared__ uint32_t tab[16 * BN_NW * BN_TEAM_LANES];
  using G = WarpGroup<BN_POW_LANES>;
  const G g;
  const int64_t total = rows * B;
  int64_t el = (int64_t)blockIdx.x * BN_TEAM_LANES + threadIdx.x / BN_POW_LANES;
  const bool live = el < total;
  if (!live) el = total - 1;
  const int64_t off = (el / B) * BN_NLIMB * B + (el % B);
  G::Lv<GWords<G::W>> x;
#pragma unroll
  for (int k = 0; k < G::W; k++) {  // limbs 2j, 2j + 1 of word j
    const int64_t j = g.lane * G::W + k;
    x.v.w[k] = ((uint32_t)a[off + 2 * j * B] & 0xFFFFu) | ((uint32_t)a[off + (2 * j + 1) * B] << 16);
  }
  const G::Lv<uint32_t*> mine = {tab + threadIdx.x};
  const G::Lv<GWords<G::W>> r =
      fq_group_pow(g, x, fq_group_words(g, one.w), e, mine, BN_POW_BLOCK, fq_group_mod(g, m));
  if (!live) return;
#pragma unroll
  for (int k = 0; k < G::W; k++) {
    const int64_t j = g.lane * G::W + k;
    o[off + 2 * j * B] = (int32_t)(r.v.w[k] & 0xFFFFu);
    o[off + (2 * j + 1) * B] = (int32_t)(r.v.w[k] >> 16);
  }
}

// exp: the eight exponent words (host); nd: its count of base-16 digits, 1..64;
// one: the eight words of R mod m (host).
extern "C" int bn_pow_fixed(const void* a, void* o, long long rows, long long B, const uint32_t* exp,
                            int nd, const uint32_t* one, const uint32_t* mod, uint32_t inv,
                            void* stream) {
  Exp e;
  Fq one_;
  for (int i = 0; i < BN_NW; i++) {
    e.w[i] = exp[i];
    one_.w[i] = one[i];
  }
  e.nd = nd;
  k_pow_fixed<<<bn_grid(rows * B, BN_TEAM_LANES), BN_POW_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)o, rows, B, e, one_, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}

// What bn_pow_fixed launches for rows * B elements (bn_launch_dims).
extern "C" int bn_pow_fixed_launch(long long rows, long long B, long long* out) {
  return bn_launch_dims(k_pow_fixed, BN_TEAM_LANES, BN_POW_BLOCK, rows * B, out);
}
