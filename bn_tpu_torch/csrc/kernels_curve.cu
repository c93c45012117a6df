// point_add and point_double: the Jacobian group law of G1 and G2, one launch
// per addition or doubling of a whole batch.  They replace the Pallas TPU
// kernels point_add and point_double (bn_tpu/ops/curve_pallas.py:410 and
// :417, bodies _add_body and _double_body over _point_add and _point_double),
// which keep a whole group operation on chip instead of sending each of its
// field operations through device memory: the scalar ladder of curve.mul, the
// subgroup check of a G2 decode and every round of the Pippenger MSM are
// chains of these two.
//
// What bounds them on an H100: over Fq an addition is 16 products of 136
// multiply-adds against 9 * 64 bytes moved, a doubling 7 against 6 * 64; over
// Fq2 43 and 16 products against twice the bytes.  The integer multiply-add
// rate bounds all four, the G1 doubling by little (its bytes need five sixths
// of the time).  But the formulas are chains: 16, 7, 43 or 16 products of
// which at most four (Fq) or twelve (Fq2 Karatsuba products) are independent
// at any point, so a design that gives one element to a thread waits on the
// latency of one product after another, and at B = 8192 puts two warps on a
// multiprocessor.
//
// Two designs, both hand-written; the C entries take the design as an
// argument, and ops/curve_cuda.py picks it by the number of lanes (rows * B):
//
// design 1, the team (below the crossover): k_curve_team, a team of warps on
// 32 elements a block, lane l of every warp on element blockIdx.x * 32 + l,
// one base-field product a warp over Fq, one Fq2 product a warp over Fq2,
// the formula's values
// in shared memory across its dependency levels: 5 levels for the addition,
// 3 for the doubling, and the doubling's 3 after the addition's only in a
// block where some lane adds a finite point to itself (csrc/curve_team.cuh,
// run by team_block_on of csrc/team.cuh).  The longest chain is then 5 or 3
// products a thread, and 4 or 3 warps a block interleave theirs.  The state
// (10 to 59 KB) is dynamic shared memory.  A G2 team with each Fq2 product's
// Karatsuba products on warps of their own (12 and 7 warps) was slower at
// every width (tools/torch_kernel_variants.py keeps it as the variant
// team_fq_a_warp): its readers join the parts again and again.
//
// design 0, one thread a point (at the MSM's width, above the crossover):
// k_point_add / k_point_double load the three or six coordinates, run the
// formula of curve.cuh in registers and store three; the addition computes
// the doubling only on lanes whose operands are the same finite point,
// behind a branch.  With 2^20 lanes the card is full of independent points,
// and this design needs no shared memory and no barriers.
//
// Every product is reduced at once, which gives the same canonical limbs as
// the TPU bodies' lazy reduction, in both designs.  The operands are read
// through __restrict__ pointers: the wrapper allocates the results, so no
// result is an operand.  Built with -DBN_MUL_OUT_OF_LINE (ops/build.py) like
// every kernel of more than about fifteen products.
#include "curve_team.cuh"
#include "launch.cuh"

#define BN_BLOCK_CURVE 64
#define BN_CURVE_MIN_BLOCKS 2

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

// The team of curve_team.cuh on its block; the state is the dynamic shared
// memory of the launch.
template <class Team>
__global__ void __launch_bounds__(Team::kWarps * BN_TEAM_LANES, BN_CURVE_MIN_BLOCKS)
k_curve_team(const Team team, int64_t n, int64_t B, Mod m) {
  extern __shared__ __align__(16) unsigned char bn_curve_state[];
  TeamNoMarks marks;
  team_block_on(team, *reinterpret_cast<typename Team::Shared*>(bn_curve_state), n, B, m, marks);
}

// The team's launch for n elements, its state in dynamic shared memory.
template <class Team>
static int curve_team_launch(const Team& team, long long n, long long B, const Mod& m, cudaStream_t s) {
  static bool raised[BN_DEVICES];
  const int bytes = (int)sizeof(typename Team::Shared);
  const int rc = bn_raise_shared(k_curve_team<Team>, bytes, raised);
  if (rc != 0) return rc;
  k_curve_team<Team><<<bn_grid(n, BN_TEAM_LANES), Team::kWarps * BN_TEAM_LANES, bytes, s>>>(team, n, B, m);
  return (int)cudaGetLastError();
}

// The team of jac_add (kAdd) or jac_double over F on the six or three
// coordinates in[], into out[].
template <class F, bool kAdd>
static int curve_team(const void* const* in, void* const* out, long long rows, long long B, const Mod& m,
                      cudaStream_t s) {
  CurveTeam<F, kAdd> team;
  for (int k = 0; k < CurveTeam<F, kAdd>::kInputs; k++) team.in[k] = (const int32_t*)in[k];
  for (int k = 0; k < 3; k++) team.out[k] = (int32_t*)out[k];
  return curve_team_launch(team, rows * B, B, m, s);
}

template <class Team>
static int curve_team_dims(long long n, long long* out) {
  const int rc = bn_launch_dims(k_curve_team<Team>, BN_TEAM_LANES, Team::kWarps * BN_TEAM_LANES, n, out);
  if (out[2] >= 0) out[2] += (long long)sizeof(typename Team::Shared);
  return rc;
}

extern "C" {

// fq2 = 0: G1, coordinates (rows, 16, B); fq2 = 1: G2, coordinates (rows, 2, 16, B).
// design = 0: one thread a point; design = 1: the team.
int bn_point_add(const void* x1, const void* y1, const void* z1, const void* x2, const void* y2,
                 const void* z2, void* ox, void* oy, void* oz, long long rows, long long B, int fq2,
                 int design, const uint32_t* mod, uint32_t inv, void* stream) {
  unsigned grid = bn_grid(rows * B, BN_BLOCK_CURVE);
  cudaStream_t s = (cudaStream_t)stream;
  Mod m = bn_make_mod(mod, inv);
  if (design) {
    const void* in[6] = {x1, y1, z1, x2, y2, z2};
    void* out[3] = {ox, oy, oz};
    return fq2 ? curve_team<Fq2, true>(in, out, rows, B, m, s) : curve_team<Fq, true>(in, out, rows, B, m, s);
  }
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
                    long long rows, long long B, int fq2, int design, const uint32_t* mod, uint32_t inv,
                    void* stream) {
  unsigned grid = bn_grid(rows * B, BN_BLOCK_CURVE);
  cudaStream_t s = (cudaStream_t)stream;
  Mod m = bn_make_mod(mod, inv);
  if (design) {
    const void* in[3] = {x, y, z};
    void* out[3] = {ox, oy, oz};
    return fq2 ? curve_team<Fq2, false>(in, out, rows, B, m, s) : curve_team<Fq, false>(in, out, rows, B, m, s);
  }
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

// What bn_point_add (add = 1) or bn_point_double launches for rows * B
// elements with these flags (bn_launch_dims; out[2] adds the team's dynamic
// shared memory, its state, to the static).
int bn_point_launch(int add, int fq2, int design, long long rows, long long B, long long* out) {
  const long long n = rows * B;
  int rc;
  if (!design) {
    if (add) rc = fq2 ? bn_launch_dims(k_point_add<Fq2>, BN_BLOCK_CURVE, BN_BLOCK_CURVE, n, out)
                      : bn_launch_dims(k_point_add<Fq>, BN_BLOCK_CURVE, BN_BLOCK_CURVE, n, out);
    else rc = fq2 ? bn_launch_dims(k_point_double<Fq2>, BN_BLOCK_CURVE, BN_BLOCK_CURVE, n, out)
                  : bn_launch_dims(k_point_double<Fq>, BN_BLOCK_CURVE, BN_BLOCK_CURVE, n, out);
    return rc;
  }
  if (add) rc = fq2 ? curve_team_dims<CurveTeam<Fq2, true>>(n, out) : curve_team_dims<CurveTeam<Fq, true>>(n, out);
  else rc = fq2 ? curve_team_dims<CurveTeam<Fq2, false>>(n, out) : curve_team_dims<CurveTeam<Fq, false>>(n, out);
  return rc;
}

}  // extern "C"
