// The Granger-Scott cyclotomic squaring split over a team of 6 members, for
// kernels that give one Fq12 element to several warps: the chain, which keeps
// the element in shared memory for a whole run of squarings
// (kernel_fq12_cyclo_sq_chain.cu), and the single squaring, which runs the
// same members and combines on the product teams' one-barrier skeleton and
// reads the element from device memory (kernel_fq12_cyclo_sq.cu).
//
// Slots.  The element's six Fq2 coefficients c{k/3}.c{k%3}, k = 0..5 in
// memory order, are the state's slots; fq12_cyclo_sq (tower.cuh) names them
//   slot 0: z0   1: z4   2: z3   3: z2   4: z1   5: z5.
// A squaring is three fq12_gs_pairs on the pairs of slots
//   p = 0: (zu, zv) = (z0, z1) = slots (0, 4)
//       1: (z2, z3) = slots (3, 2)
//       2: (z4, z5) = slots (1, 5),
// each with two independent Fq2 products: tmp = zu*zv and
// big = (zu + zv)(xi zv + zu).
// Member order.  Member w, 0 <= w < 6, computes product w % 2 (0: tmp,
// 1: big) of pair w / 2, with its pre-sums: 3 base-field products.  The team's
// scratch holds the 6 products, product w at entries 2w, 2w + 1 of
// fq_tab_store's layout (fq2_tab_store in team.cuh).
// Combine c, 0 <= c < 6, returns new slot c from the products and old slot c
// alone; with t_a = big - tmp - xi tmp and t_b = 2 tmp of a pair,
//   c = 0: nz0 = 3 t_a(p0) - 2 z0     3: nz2 = 3 xi t_b(p2) + 2 z2
//       1: nz4 = 3 t_a(p1) - 2 z4     4: nz1 = 3 t_b(p0) + 2 z1
//       2: nz3 = 3 t_a(p2) - 2 z3     5: nz5 = 3 t_b(p1) + 2 z5.
// Because each new coefficient reads only its own old one, combine c may
// write slot c in place while the other combines run: no third buffer.  This
// holds only while no combine reads another slot; the host test runs the
// combines in order and last to first to check it.
//
// Every sum and difference is taken modulo q and every product reduced at
// once, so the result is that of tower.cuh's fq12_cyclo_sq applied n times,
// bit for bit, whatever order the members and the combines run in.
#pragma once

#include "fq12_team.cuh"
#include "team.cuh"

#define BN_CYCLO_MEMBERS 6  // Fq2 products of one cyclotomic squaring
#define BN_CYCLO_SLOTS 6    // Fq2 coefficients of an Fq12 element
#define BN_CYCLO_BLOCK (BN_TEAM_LANES * BN_CYCLO_MEMBERS)  // threads of a block: 6 warps
#ifndef BN_CYCLO_MIN_BLOCKS
#define BN_CYCLO_MIN_BLOCKS 2  // blocks a multiprocessor that __launch_bounds__ asks registers for
#endif

// The slots of pair p's zu and zv.
BN_DEV int fq12_cyclo_u(int p) { return p == 0 ? 0 : p == 1 ? 3 : 1; }
BN_DEV int fq12_cyclo_v(int p) { return p == 0 ? 4 : p == 1 ? 2 : 5; }

// Member w's two Fq2 operands from its pair's zu and zv.
BN_DEV void fq12_cyclo_operands(int w, const Fq2& zu, const Fq2& zv, const Mod& m, Fq2& x, Fq2& y) {
  if (w % 2 == 0) {  // tmp
    x = zu;
    y = zv;
  } else {  // big
    x = team_add(zu, zv, m);
    y = team_add(team_xi(zv, m), zu, m);
  }
}

BN_DEV Fq2 fq12_cyclo_pair_product(int w, const Fq2& zu, const Fq2& zv, const Mod& m) {
  Fq2 x, y;
  fq12_cyclo_operands(w, zu, zv, m, x, y);
  return fq2_mul(x, y, m);
}

// Member w with its operands read from the state.
BN_DEV Fq2 fq12_cyclo_member(int w, const uint32_t* state, int stride, const Mod& m) {
  const int p = w / 2;
  return fq12_cyclo_pair_product(w, fq2_tab_load(state, stride, fq12_cyclo_u(p)),
                                 fq2_tab_load(state, stride, fq12_cyclo_v(p)), m);
}

// New slot c from the products in the scratch and old slot c, z:
// 3t - 2z (fq2_m3_sub) for c < 3, 3t + 2z (fq2_m3_add) for the rest.
BN_DEV Fq2 fq12_cyclo_combine_z(int c, const uint32_t* prods, int stride, const Fq2& z, const Mod& m) {
  const int p = c < 3 ? c : (c + 2) % 3;
  const Fq2 tmp = fq2_tab_load(prods, stride, 2 * p);
  Fq2 t, r;
  if (c < 3) {
    t = team_sub(team_sub(fq2_tab_load(prods, stride, 2 * p + 1), tmp, m), team_xi(tmp, m), m);
    r = team_sub(t, z, m);
  } else {
    t = team_add(tmp, tmp, m);
    if (c == 3) t = team_xi(t, m);
    r = team_add(t, z, m);
  }
  return team_add(team_add(r, r, m), t, m);
}

// The same with old slot c read from the state.
BN_DEV Fq2 fq12_cyclo_combine(int c, const uint32_t* prods, const uint32_t* state, int stride, const Mod& m) {
  return fq12_cyclo_combine_z(c, prods, stride, fq2_tab_load(state, stride, c), m);
}

// One squaring on the product teams' skeleton (fq12_team_block in
// fq12_team.cuh, kernel_fq12_cyclo_sq.cu): the members read their pair and
// the combines their old slot straight from the element in device memory, a
// (rows, 2, 3, 2, 16, B) tensor (Fq12Global), so the element makes no round
// trip through a shared state and the block needs one barrier.
struct Fq12CycloSqMember {
  const int32_t* a;
  BN_DEV Fq2 operator()(int w, int64_t e, int64_t B, const Mod& m) const {
    const int p = w / 2;
    const Fq12Global::Element z = Fq12Global{a}.at(e, B);
    return fq12_cyclo_pair_product(w, z(fq12_cyclo_u(p)), z(fq12_cyclo_v(p)), m);
  }
};

struct Fq12CycloSqCombine {
  const int32_t* a;
  BN_DEV Fq2 operator()(int c, int64_t e, int64_t B, const uint32_t* prods, int stride, const Mod& m) const {
    return fq12_cyclo_combine_z(c, prods, stride, Fq12Global{a}.at(e, B)(c), m);
  }
};

#ifdef __CUDACC__
// The block of the chain's team: 6 warps, lane l of warp w on element
// blockIdx.x * BN_TEAM_LANES + l.  Warp w loads slot w of its lane's element
// into the state once; then each of the n squarings is: member w writes its
// product to the scratch, a barrier, combine w rewrites slot w, a barrier.
// At the end warp w stores slot w.  State and scratch are [slot][coefficient]
// [word][lane] (fq2_tab_store's layout: neighbouring lanes on neighbouring
// banks), 12,288 bytes each.  A lane past the end clamps its element to the
// last one, computes with the others and skips the store (team_lane in
// team.cuh): no thread leaves before a barrier.  `member` computes a
// member's Fq2 (Fq12CycloMember in the package's kernel); `marks(s)` is
// called at the start (s = 0), after the load's barrier (1), in squaring i
// after the member's store (2 + 4i), after the first barrier (3 + 4i), after
// the combine's store (4 + 4i) and after the second barrier (5 + 4i), and
// after the final store (2 + 4n): it does nothing in the package's kernel,
// and tools/torch_fq12_team_phases.py reads the clock there.
struct Fq12CycloMember {
  __device__ __forceinline__ Fq2 operator()(int w, const uint32_t* state, int stride, const Mod& m) const {
    return fq12_cyclo_member(w, state, stride, m);
  }
};

template <class Member, class Marks>
__device__ __forceinline__ void fq12_cyclo_team_block(const int32_t* __restrict__ a, int32_t* __restrict__ o,
                                                      int64_t rows, int64_t B, int n, const Mod& m,
                                                      const Member& member, Marks& marks) {
  __shared__ uint32_t state[BN_CYCLO_SLOTS][2][BN_NW][BN_TEAM_LANES];
  __shared__ uint32_t prods[BN_CYCLO_MEMBERS][2][BN_NW][BN_TEAM_LANES];
  marks(0);
  const TeamLane t = team_lane(rows * B);
  const int w = t.w;
  const int64_t off = fq12_offset(t.e, B) + (int64_t)w * 2 * BN_NLIMB * B;  // slot w of the element
  uint32_t* st = &state[0][0][0][0] + t.lane;  // stride BN_TEAM_LANES
  uint32_t* pr = &prods[0][0][0][0] + t.lane;
  Fq2 v = fq2_load(a + off, B);
  fq2_tab_store(st, BN_TEAM_LANES, w, v);
  __syncthreads();
  marks(1);
#pragma unroll 1
  for (int i = 0; i < n; i++) {
    fq2_tab_store(pr, BN_TEAM_LANES, w, member(w, st, BN_TEAM_LANES, m));
    marks(2 + 4 * i);
    __syncthreads();
    marks(3 + 4 * i);
    v = fq12_cyclo_combine(w, pr, st, BN_TEAM_LANES, m);
    fq2_tab_store(st, BN_TEAM_LANES, w, v);
    marks(4 + 4 * i);
    __syncthreads();
    marks(5 + 4 * i);
  }
  if (t.live) fq2_store(o + off, B, v);
  marks(2 + 4 * n);
}
#endif
