// Base-field and Fq2 kernels: mont_mul, mod_add, the signed sums (mod_sub,
// mod_neg, fq2_xi and a whole level of sums), fq2_mul, fq2_sq.
//
// They replace the Pallas TPU kernels of bn_tpu/ops/mont_pallas.py:
//   bn_mont_mul <- mont_mul_pallas (_k_mont_mul)   bn_fq2_mul <- fq2_mul_pallas
//   bn_mod_add  <- mod_add_pallas  (_k_add)        bn_fq2_sq  <- fq2_sq_pallas
//   bn_mod_sub  <- mod_sub_pallas  (_k_sub)        bn_fq2_xi  <- fq2_xi_pallas
//   bn_mod_neg  <- mod_neg_pallas  (_k_neg)
// bn_mod_sub, bn_mod_neg and bn_fq2_xi launch k_signed_sum (signed_sum.cuh)
// on a table of one output fixed at compile time; bn_mod_signed_sum on a
// level of up to sixteen outputs, of field elements or of Fq2 elements whose
// terms may multiply by xi.
// The TPU kernels walk (8, 128) tiles of 1024 batch elements with 16-bit
// limbs in 32-bit lanes.  Here a thread owns one field element (or one Fq2
// element): it loads the sixteen limbs, packs them into eight 32-bit words,
// computes in registers and unpacks on the store.  The batch is the innermost
// axis, so a warp's load of one limb is one coalesced 128-byte line; the
// ragged edge is a bounds test, not padding.  fq2_sq is the exception: a
// team of two warps on 32 elements (Fq2SqTeam, team.cuh), one coefficient a
// warp.
//
// What bounds them on an H100 at B = 8192 (PERF.md, chip_smoke.py): the
// launch floor, 0.95-1.16 us, then the bytes, 0.47-0.94 us (4.70 for
// fq2_mul's five rows); the multiply-adds of the products, 136 32x32->64 a
// base-field product, take less (0.32 us for fq2_sq's 16,384 products).  The
// sums and fq2_xi come within 0.2-0.5 us of floor plus bytes, and a level of
// sums is one launch because the floor is more than half of a single sum's
// time.  What mont_mul, fq2_mul and fq2_sq lose above floor plus bytes
// (0.5-0.8 us) is the latency of a product's dependent chain with too few
// warps to hide it: fq2_sq's team gives each thread one product in place of
// two and the card four times the blocks (256 of 64 threads), 2.28 us
// against the one-thread design's 2.8-3.0.  Every operand stays in registers
// (an Fq2 product needs about 60) so that none spills.
#include "launch.cuh"
#include "signed_sum.cuh"
#include "team.cuh"

#define BN_BLOCK 128

// Flat elementwise kernels over `rows` field elements of batch B: thread t
// owns element (row, b) = (t / B, t % B), whose limb i is at (row*16 + i)*B + b.
enum { OP_MUL = 0, OP_ADD = 1 };

template <int OP>
__global__ void __launch_bounds__(BN_BLOCK)
k_binary(const int32_t* __restrict__ a, const int32_t* __restrict__ b, int32_t* __restrict__ o,
         int64_t rows, int64_t B, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t off = (t / B) * BN_NLIMB * B + (t % B);
  Fq x = fq_load(a + off, B);
  Fq y = fq_load(b + off, B);
  Fq r;
  if (OP == OP_MUL) r = fq_mont_mul(x, y, m);
  if (OP == OP_ADD) r = fq_add(x, y, m);
  fq_store(o + off, B, r);
}

// A level of signed sums: block (x, y, z) holds lanes 128x .. 128x + 127 of
// row y (and of every row gridDim.y further on) of output z, so a warp's load
// of one limb is one coalesced 128-byte line and the output, its terms and
// their sources are the same for the whole block.  The table is a
// __grid_constant__ parameter: a SumTable (an Fq2SumTable for the Fq2 form),
// indexed by the block's output and a term's source, is read from the
// constant bank and never copied to local memory; a single operation's
// SumDense has its terms in the instantiation.
template <class Table>
__global__ void __launch_bounds__(BN_BLOCK)
k_signed_sum(const __grid_constant__ Table t, const __grid_constant__ Mod m) {
  const int64_t b = (int64_t)blockIdx.x * BN_BLOCK + threadIdx.x;
  if (b >= t.B) return;
  for (int32_t row = blockIdx.y; row < t.rows; row += gridDim.y) signed_sum_element(t, blockIdx.z, row, b, m);
}

template <class Table>
static int signed_sum_launch(const Table& t, const Mod& m, void* stream) {
  if (t.rows == 0 || t.B == 0) return 0;
  const dim3 grid(bn_grid(t.B, BN_BLOCK), t.rows < 65535 ? t.rows : 65535, t.n_out);
  k_signed_sum<<<grid, BN_BLOCK, 0, (cudaStream_t)stream>>>(t, m);
  return (int)cudaGetLastError();
}

// Fq2 kernels over `rows` Fq2 elements of batch B: element (row, b) has its
// two coefficients at (row*2 + c)*16*B + b.
__global__ void __launch_bounds__(BN_BLOCK)
k_fq2_mul(const int32_t* __restrict__ a, const int32_t* __restrict__ b, int32_t* __restrict__ o,
          int64_t rows, int64_t B, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t off = (t / B) * 2 * BN_NLIMB * B + (t % B);
  fq2_store(o + off, B, fq2_mul(fq2_load(a + off, B), fq2_load(b + off, B), m));
}

// fq2_sq: the team of two warps on 32 elements of the flat batch (rows * B
// Fq2 elements), on team_block's skeleton with its one phase.
#define BN_FQ2_SQ_BLOCK (Fq2SqTeam::kWarps * BN_TEAM_LANES)

__global__ void __launch_bounds__(BN_FQ2_SQ_BLOCK)
k_fq2_sq(const Fq2SqTeam team, int64_t n, int64_t B, Mod m) {
  TeamNoMarks marks;
  team_block(team, n, B, m, marks);
}

// Register-only probe of the card's rate for the multiply-add the Montgomery
// product is made of (32x32 -> 64 bits, plus a 64-bit addend): eight
// independent dependent chains per thread, no memory traffic inside the loop.
#define BN_PROBE_CHAINS 8
__global__ void k_imad_probe(uint64_t* out, int iters, uint32_t y) {
  uint64_t acc[BN_PROBE_CHAINS];
#pragma unroll
  for (int k = 0; k < BN_PROBE_CHAINS; k++) acc[k] = bn_tid() * 2654435761u + k;
  for (int it = 0; it < iters; it++) {
#pragma unroll
    for (int k = 0; k < BN_PROBE_CHAINS; k++) acc[k] = (uint64_t)(uint32_t)acc[k] * y + acc[k];
  }
  uint64_t s = 0;
#pragma unroll
  for (int k = 0; k < BN_PROBE_CHAINS; k++) s ^= acc[k];
  out[bn_tid()] = s;
}

// The launch floor: a kernel that does nothing, timed as every kernel is, so
// that a kernel's time can be read against floor + bound.
__global__ void k_empty_probe() {}

#define BN_LAUNCH(kernel, n, ...)                                              \
  kernel<<<bn_grid((n), BN_BLOCK), BN_BLOCK, 0, (cudaStream_t)stream>>>(__VA_ARGS__); \
  return (int)cudaGetLastError();

extern "C" {

int bn_mont_mul(const void* a, const void* b, void* o, long long rows, long long B,
                const uint32_t* mod, uint32_t inv, void* stream) {
  BN_LAUNCH(k_binary<OP_MUL>, rows * B, (const int32_t*)a, (const int32_t*)b, (int32_t*)o, rows, B,
            bn_make_mod(mod, inv))
}

int bn_mod_add(const void* a, const void* b, void* o, long long rows, long long B,
               const uint32_t* mod, uint32_t inv, void* stream) {
  BN_LAUNCH(k_binary<OP_ADD>, rows * B, (const int32_t*)a, (const int32_t*)b, (int32_t*)o, rows, B,
            bn_make_mod(mod, inv))
}

int bn_mod_sub(const void* a, const void* b, void* o, long long rows, long long B,
               const uint32_t* mod, uint32_t inv, void* stream) {
  SumDense<1, -2, 1> t;  // a - b
  if (!signed_sum_dense(t, (const int32_t*)a, (const int32_t*)b, (int32_t*)o, rows, B)) return (int)cudaErrorInvalidValue;
  return signed_sum_launch(t, bn_make_mod(mod, inv), stream);
}

int bn_mod_neg(const void* a, void* o, long long rows, long long B, const uint32_t* mod,
               uint32_t inv, void* stream) {
  SumDense<-1, 0, 1> t;  // -a
  if (!signed_sum_dense(t, (const int32_t*)a, nullptr, (int32_t*)o, rows, B)) return (int)cudaErrorInvalidValue;
  return signed_sum_launch(t, bn_make_mod(mod, inv), stream);
}

int bn_fq2_xi(const void* a, void* o, long long rows, long long B, const uint32_t* mod,
              uint32_t inv, void* stream) {
  SumDense<BN_SUM_XI + 1, 0, 2> t;  // xi a, on rows Fq2 elements
  if (!signed_sum_dense(t, (const int32_t*)a, nullptr, (int32_t*)o, rows, B)) return (int)cudaErrorInvalidValue;
  return signed_sum_launch(t, bn_make_mod(mod, inv), stream);
}

// desc: four int64 an operand (address, then the element strides of the row
// axes r0, r1, r2), the n_src sources then the n_out outputs; terms:
// BN_SUM_MAX_TERMS codes an output (signed_sum.cuh).  Every operand has
// `rows` rows of a dense (16, B) block, or with fq2 set of a dense (2, 16, B)
// block; n1 and n2 are the extents of r1, r2.
int bn_mod_signed_sum(const long long* desc, const int8_t* terms, int n_src, int n_out, int n1, int n2,
                      long long rows, long long B, int fq2, const uint32_t* mod, uint32_t inv, void* stream) {
  if (fq2) {
    Fq2SumTable t;
    if (!signed_sum_table(t, desc, terms, n_src, n_out, n1, n2, rows, B)) return (int)cudaErrorInvalidValue;
    return signed_sum_launch(t, bn_make_mod(mod, inv), stream);
  }
  SumTable t;
  if (!signed_sum_table(t, desc, terms, n_src, n_out, n1, n2, rows, B)) return (int)cudaErrorInvalidValue;
  return signed_sum_launch(t, bn_make_mod(mod, inv), stream);
}

int bn_fq2_mul(const void* a, const void* b, void* o, long long rows, long long B,
               const uint32_t* mod, uint32_t inv, void* stream) {
  BN_LAUNCH(k_fq2_mul, rows * B, (const int32_t*)a, (const int32_t*)b, (int32_t*)o, rows, B,
            bn_make_mod(mod, inv))
}

int bn_fq2_sq(const void* a, void* o, long long rows, long long B, const uint32_t* mod, uint32_t inv,
              void* stream) {
  k_fq2_sq<<<bn_grid(rows * B, BN_TEAM_LANES), BN_FQ2_SQ_BLOCK, 0, (cudaStream_t)stream>>>(
      Fq2SqTeam{(const int32_t*)a, (int32_t*)o}, rows * B, B, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}

// What bn_fq2_sq launches for rows * B elements (bn_launch_dims).
int bn_fq2_sq_launch(long long rows, long long B, long long* out) {
  return bn_launch_dims(k_fq2_sq, BN_TEAM_LANES, BN_FQ2_SQ_BLOCK, rows * B, out);
}

// out must hold blocks*threads uint64 values; each thread does
// iters * BN_PROBE_CHAINS multiply-adds.
int bn_imad_probe(void* out, int blocks, int threads, int iters, void* stream) {
  k_imad_probe<<<blocks, threads, 0, (cudaStream_t)stream>>>((uint64_t*)out, iters, 0x9E3779B1u);
  return (int)cudaGetLastError();
}

int bn_empty_probe(int blocks, int threads, void* stream) {
  k_empty_probe<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
