// Fixed-exponent power a^e, the Fermat inversion of fields/fp.py.  Replaces
// the Pallas TPU kernel pow_fixed_pallas (bn_tpu/ops/mont_pallas.py, bodies
// _pow_table_body and _pow_ladder_body), which is two calls: one builds the
// window table, one walks the digits as its innermost grid axis and carries
// the running value from grid step to grid step in its output block.
//
// Here nothing carries between blocks and nothing needs to: one launch, one
// thread per element, the whole window-4 ladder as a loop inside the thread
// (fq_pow_fixed in fq.cuh).  For e = q - 2 that is 15 + 63*5 = 330 dependent
// base-field products of 136 multiply-adds against 128 bytes moved, so integer
// multiply-add throughput bounds it on an H100, and at a batch of 8192 there
// are only 64 warps for 132 multiprocessors, each a chain of dependent
// products: latency, not throughput, sets its time.
//
// The table of sixteen entries (512 bytes a thread) is indexed by a digit
// known only at run time, so it cannot live in registers.  It lies in shared
// memory as [entry][word][thread]: 64 threads x 512 bytes = 32 KB static, and
// since the digit is the same for every thread a warp reads 32 neighbouring
// banks.  The exponent (eight words and a digit count) and the Montgomery one
// are kernel arguments, so one build serves every exponent and both moduli
// and nothing is uploaded per call.
#include "launch.cuh"

#define BN_BLOCK_POW 64

__global__ void __launch_bounds__(BN_BLOCK_POW)
k_pow_fixed(const int32_t* __restrict__ a, int32_t* __restrict__ o, int64_t rows, int64_t B, Exp e,
            Fq one, Mod m) {
  __shared__ uint32_t tab[16 * BN_NW * BN_BLOCK_POW];
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t off = (t / B) * BN_NLIMB * B + (t % B);
  Fq r = fq_pow_fixed(fq_load(a + off, B), one, e, tab + threadIdx.x, BN_BLOCK_POW, m);
  fq_store(o + off, B, r);
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
  k_pow_fixed<<<bn_grid(rows * B, BN_BLOCK_POW), BN_BLOCK_POW, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)o, rows, B, e, one_, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}
