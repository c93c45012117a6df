// Host build of the port's CUDA field/tower headers (bn_tpu_torch/csrc/fq.cuh,
// tower.cuh are plain C++ when no CUDA compiler is at work).  One loop over
// the batch stands in for the grid, with the same offsets as the kernels, so
// the formulas and the memory layout can be checked on a machine without a
// GPU.  Built and driven by tests/test_torch_csrc_host.py.
#include "tower.cuh"

enum {
  OP_MONT_MUL, OP_MOD_ADD, OP_MOD_SUB, OP_MOD_NEG, OP_FQ2_MUL, OP_FQ2_SQ, OP_FQ2_XI,
  OP_FQ12_MUL, OP_FQ12_SQ, OP_FQ12_MUL024_PRE, OP_FQ12_CYCLO_SQ
};

extern "C" int host_run(int op, const int32_t* a, const int32_t* b, const int32_t* c, int32_t* o,
                        long long rows, long long B, const uint32_t* mod, uint32_t inv) {
  Mod m;
  for (int i = 0; i < BN_NW; i++) m.w[i] = mod[i];
  m.inv = inv;
  for (int64_t t = 0; t < rows * B; t++) {
    int64_t row = t / B, bb = t % B;
    int64_t o1 = row * BN_NLIMB * B + bb, o2 = 2 * row * BN_NLIMB * B + bb,
            o12 = 12 * row * BN_NLIMB * B + bb;
    switch (op) {
      case OP_MONT_MUL: fq_store(o + o1, B, fq_mont_mul_inline(fq_load(a + o1, B), fq_load(b + o1, B), m)); break;
      case OP_MOD_ADD: fq_store(o + o1, B, fq_add(fq_load(a + o1, B), fq_load(b + o1, B), m)); break;
      case OP_MOD_SUB: fq_store(o + o1, B, fq_sub(fq_load(a + o1, B), fq_load(b + o1, B), m)); break;
      case OP_MOD_NEG: fq_store(o + o1, B, fq_neg(fq_load(a + o1, B), m)); break;
      case OP_FQ2_MUL: fq2_store(o + o2, B, fq2_mul(fq2_load(a + o2, B), fq2_load(b + o2, B), m)); break;
      case OP_FQ2_SQ: fq2_store(o + o2, B, fq2_sq(fq2_load(a + o2, B), m)); break;
      case OP_FQ2_XI: fq2_store(o + o2, B, fq2_xi(fq2_load(a + o2, B), m)); break;
      case OP_FQ12_MUL: fq12_store(o + o12, B, fq12_mul(fq12_load(a + o12, B), fq12_load(b + o12, B), m)); break;
      case OP_FQ12_SQ: fq12_store(o + o12, B, fq12_sq(fq12_load(a + o12, B), m)); break;
      case OP_FQ12_CYCLO_SQ: fq12_store(o + o12, B, fq12_cyclo_sq(fq12_load(a + o12, B), m)); break;
      case OP_FQ12_MUL024_PRE: {
        const int32_t* s = c + 4 * row * BN_NLIMB * B + bb;
        fq12_store(o + o12, B,
                   fq12_mul_by_024(fq12_load(a + o12, B), fq2_load(b + o2, B),
                                   fq2_load(s + 2 * BN_NLIMB * B, B), fq2_load(s, B), m));
        break;
      }
      default: return 1;
    }
  }
  return 0;
}
