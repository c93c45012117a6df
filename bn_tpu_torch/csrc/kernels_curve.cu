// point_add and point_double: the Jacobian group law of G1 and G2, one launch
// per addition or doubling of a whole batch.  They replace the Pallas TPU
// kernels point_add and point_double (bn_tpu/ops/curve_pallas.py, bodies
// _add_body and _double_body over _point_add and _point_double), which keep a
// whole group operation on chip instead of sending each of its field
// operations through device memory: the scalar ladder of curve.mul, the
// subgroup check of a G2 decode and every round of the Pippenger MSM are
// chains of these two.
//
// One thread owns one point: it loads the three (doubling) or six (addition)
// coordinates, each its own tensor (..., [2,] 16, B) with the batch innermost,
// runs the formula of curve.cuh in registers (reduced after every product,
// which gives the same canonical limbs as the TPU bodies' lazy reduction) and
// stores three coordinates.  The addition computes the doubling only on lanes
// whose operands are the same finite point, behind a branch; the TPU body
// always computes it and selects.
//
// Over Fq an addition is 16 products of 136 multiply-adds against 9 * 64
// bytes moved, a doubling 7 against 6 * 64; over Fq2 43 and 16 products
// against twice the bytes.  On an H100 the integer multiply-add rate bounds
// all four, the G1 doubling by little (its bytes need five sixths of the time).
// The operands are read through __restrict__ pointers: the wrapper allocates
// the results, so no result is an operand.  Built with -DBN_MUL_OUT_OF_LINE
// (ops/build.py) like every kernel of more than about fifteen products.
#include "curve.cuh"
#include "launch.cuh"

#define BN_BLOCK_CURVE 64

template <class F>
__global__ void __launch_bounds__(BN_BLOCK_CURVE)
k_point_add(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1, const int32_t* __restrict__ z1,
            const int32_t* __restrict__ x2, const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
            int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
            int64_t rows, int64_t B, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t off = (t / B) * FieldIO<F>::width * BN_NLIMB * B + (t % B);
  Jac<F> p, q;
  p.x = FieldIO<F>::load(x1 + off, B);
  p.y = FieldIO<F>::load(y1 + off, B);
  p.z = FieldIO<F>::load(z1 + off, B);
  q.x = FieldIO<F>::load(x2 + off, B);
  q.y = FieldIO<F>::load(y2 + off, B);
  q.z = FieldIO<F>::load(z2 + off, B);
  Jac<F> r = jac_add(p, q, m);
  FieldIO<F>::store(ox + off, B, r.x);
  FieldIO<F>::store(oy + off, B, r.y);
  FieldIO<F>::store(oz + off, B, r.z);
}

template <class F>
__global__ void __launch_bounds__(BN_BLOCK_CURVE)
k_point_double(const int32_t* __restrict__ x, const int32_t* __restrict__ y, const int32_t* __restrict__ z,
               int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
               int64_t rows, int64_t B, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t off = (t / B) * FieldIO<F>::width * BN_NLIMB * B + (t % B);
  Jac<F> p;
  p.x = FieldIO<F>::load(x + off, B);
  p.y = FieldIO<F>::load(y + off, B);
  p.z = FieldIO<F>::load(z + off, B);
  Jac<F> r = jac_double(p, m);
  FieldIO<F>::store(ox + off, B, r.x);
  FieldIO<F>::store(oy + off, B, r.y);
  FieldIO<F>::store(oz + off, B, r.z);
}

extern "C" {

// fq2 = 0: G1, coordinates (rows, 16, B); fq2 = 1: G2, coordinates (rows, 2, 16, B).
int bn_point_add(const void* x1, const void* y1, const void* z1, const void* x2, const void* y2,
                 const void* z2, void* ox, void* oy, void* oz, long long rows, long long B, int fq2,
                 const uint32_t* mod, uint32_t inv, void* stream) {
  unsigned grid = bn_grid(rows * B, BN_BLOCK_CURVE);
  cudaStream_t s = (cudaStream_t)stream;
  Mod m = bn_make_mod(mod, inv);
  if (fq2)
    k_point_add<Fq2><<<grid, BN_BLOCK_CURVE, 0, s>>>(
        (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)z1, (const int32_t*)x2, (const int32_t*)y2,
        (const int32_t*)z2, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, rows, B, m);
  else
    k_point_add<Fq><<<grid, BN_BLOCK_CURVE, 0, s>>>(
        (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)z1, (const int32_t*)x2, (const int32_t*)y2,
        (const int32_t*)z2, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, rows, B, m);
  return (int)cudaGetLastError();
}

int bn_point_double(const void* x, const void* y, const void* z, void* ox, void* oy, void* oz,
                    long long rows, long long B, int fq2, const uint32_t* mod, uint32_t inv, void* stream) {
  unsigned grid = bn_grid(rows * B, BN_BLOCK_CURVE);
  cudaStream_t s = (cudaStream_t)stream;
  Mod m = bn_make_mod(mod, inv);
  if (fq2)
    k_point_double<Fq2><<<grid, BN_BLOCK_CURVE, 0, s>>>(
        (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz,
        rows, B, m);
  else
    k_point_double<Fq><<<grid, BN_BLOCK_CURVE, 0, s>>>(
        (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz,
        rows, B, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
