// What the Fq12 teams share: the layouts they read and write, written here
// once, the member order of the Fq12 product's 18 Fq2 products, the parts
// of an Fq6 product's recombination, and the one-barrier team that runs the
// Fq12 square and sparse products (fq12_team_block, at the end).
//
// Layouts.  An Fq12 element is (rows, 2, 3, 2, 16, B), leading axes folded
// into rows: element e is row e / B, batch index e % B, and its coefficient
// c{i}.c{s} (Fq2 coefficient k = 3i + s of the six in memory order) starts at
// fq12_offset(e, B) + k * 2 * 16 * B.  A team reads such an element through
// a source: Fq12Global from device memory, Fq12Shared from a team's shared
// memory.  The team's lanes and its shared memory's layout: team.cuh.  Its
// scratch is [member][coefficient][word][lane].
//
// Member order of the product.  The Fq12 Karatsuba (src/fields/fq12.rs:295-307) takes three
// Fq6 products, and each Fq6 Karatsuba (fq6_mul in tower.cuh) six Fq2
// products; once the pre-sums are taken the 18 Fq2 products are independent.
// Member w, 0 <= w < 18, computes Fq2 product j = w % 6 of Fq6 product
// k = w / 6, where
//   k = 0: (a.c0, b.c0)   1: (a.c1, b.c1)   2: (a.c0 + a.c1, b.c0 + b.c1)
// and, on that pair of Fq6 operands x, y,
//   j = 0: (x0, y0)  1: (x1, y1)  2: (x2, y2)
//       3: (x1 + x2, y1 + y2)  4: (x0 + x1, y0 + y1)  5: (x0 + x2, y0 + y2).
// The Fq12 square's team (fq12_sq_team.cuh) takes the same order.  The
// product's own team, with lazy reduction, is fq12_mul_team.cuh.
//
// In fq12_team_block's teams the scratch holds product w at entries 2w,
// 2w + 1 of fq_tab_store's layout; after a barrier, combine c, 0 <= c < 6,
// reads them and returns output coefficient out.c{c/3}.c{c%3}.  Every sum and
// difference is taken modulo q and every product reduced at once, so each
// intermediate is the canonical element: a team's result is that of
// tower.cuh's one-thread formula, bit for bit, whatever the order the members
// and the combines run in.  Plain C++ like the other headers, so the host
// tests run the same code.
#pragma once

#include "team.cuh"
#include "tower.cuh"

#define BN_TEAM_MEMBERS 18  // Fq2 products of one Fq12 product
#define BN_TEAM_COMBINES 6  // Fq2 coefficients of the result

// The parts of Fq6 product k's recombination (fq6_mul), from its six Fq2
// products aa, bb, cc, t12, t01, t02 in the scratch:
//   r0 = xi(u) + aa, with u = t12 - bb - cc
//   r1 = v + xi(cc), with v = t01 - aa - bb
//   r2 = t02 - aa + bb - cc.
BN_DEV Fq2 fq12_team_prod(const uint32_t* prods, int stride, int k, int j) {
  return fq2_tab_load(prods, stride, 6 * k + j);
}

BN_DEV Fq2 fq12_team_u(const uint32_t* prods, int stride, int k, const Mod& m) {
  return team_sub(fq12_team_prod(prods, stride, k, 3),
                 team_add(fq12_team_prod(prods, stride, k, 1), fq12_team_prod(prods, stride, k, 2), m), m);
}

BN_DEV Fq2 fq12_team_v(const uint32_t* prods, int stride, int k, const Mod& m) {
  return team_sub(fq12_team_prod(prods, stride, k, 4),
                 team_add(fq12_team_prod(prods, stride, k, 0), fq12_team_prod(prods, stride, k, 1), m), m);
}

BN_DEV Fq2 fq12_team_r2(const uint32_t* prods, int stride, int k, const Mod& m) {
  return team_add(team_sub(fq12_team_prod(prods, stride, k, 5), fq12_team_prod(prods, stride, k, 0), m),
                 team_sub(fq12_team_prod(prods, stride, k, 1), fq12_team_prod(prods, stride, k, 2), m), m);
}

// x_C - x_A - x_B for the three Fq6 products A, B, C (k = 0, 1, 2).
BN_DEV Fq2 fq12_team_c_minus_ab(const Fq2& xa, const Fq2& xb, const Fq2& xc, const Mod& m) {
  return team_sub(xc, team_add(xa, xb, m), m);
}

// Element e of a (rows, 2, 3, 2, 16, B) tensor: row e / B, batch index e % B.
BN_DEV int64_t fq12_offset(int64_t e, int64_t B) { return (e / B) * 12 * BN_NLIMB * B + (e % B); }

// Sources of an Fq12 operand: src.at(e, B) is element e's, and
// src.at(e, B)(k) its coefficient k (memory order), read from device memory
// or from a team's shared memory at the thread's lane.  The element's
// offset is taken once, in at().
struct Fq12Global {
  const int32_t* a;
  struct Element {
    const int32_t* p;
    int64_t B;
    BN_DEV Fq2 operator()(int k) const { return fq2_load(p + (int64_t)k * 2 * BN_NLIMB * B, B); }
  };
  BN_DEV Element at(int64_t e, int64_t B) const { return Element{a + fq12_offset(e, B), B}; }
};

struct Fq12Shared {
  const uint32_t* tab;
  BN_DEV Fq12Shared at(int64_t, int64_t) const { return *this; }
  BN_DEV Fq2 operator()(int k) const { return fq2_tab_load(tab, BN_TEAM_LANES, k); }
};

// The two phases of a one-barrier team, plain C++ so the host tests run
// them too: member t.w writes its Fq2 product for element t.e into the
// scratch (`prods` at the thread's lane); after the barrier warps 0-5 each
// store combine(c, e, B, prods, 32, m) as output coefficient c of a live
// element (e and B for a combine that also reads the element's operand).
template <class Member>
BN_DEV void fq12_team_members(uint32_t* prods, const TeamLane& t, int64_t B, const Mod& m, const Member& member) {
  fq2_tab_store(prods, BN_TEAM_LANES, t.w, member(t.w, t.e, B, m));
}

template <class Combine>
BN_DEV void fq12_team_combines(int32_t* o, const uint32_t* prods, const TeamLane& t, int64_t B, const Mod& m,
                               const Combine& combine) {
  if (t.w < BN_TEAM_COMBINES && t.live)
    fq2_store(o + fq12_offset(t.e, B) + (int64_t)t.w * 2 * BN_NLIMB * B, B,
              combine(t.w, t.e, B, prods, BN_TEAM_LANES, m));
}

// The team of kernel_fq12_mul024.cu, kernel_fq12_mul024_pre.cu,
// kernel_fq12_sq.cu and kernel_fq12_cyclo_sq.cu:
// MEMBERS warps, a scratch of MEMBERS Fq2 a lane, two phases (team_block in
// team.cuh): the members, a barrier, the combines.
template <int MEMBERS, class Member, class Combine>
struct Fq12Team {
  static constexpr int kWarps = MEMBERS, kPhases = 2;
  struct Shared {
    uint32_t prods[MEMBERS][2][BN_NW][BN_TEAM_LANES];
  };
  int32_t* __restrict__ o;
  Member member;
  Combine combine;
  BN_DEV void phase(int p, const TeamLane& t, int64_t B, Shared& sh, const Mod& m) const {
    uint32_t* prods = &sh.prods[0][0][0][0] + t.lane;
    if (p == 0)
      fq12_team_members(prods, t, B, m, member);
    else
      fq12_team_combines(o, prods, t, B, m, combine);
  }
};

#ifdef __CUDACC__
// The block of such a team.  `marks(i)` is called at the start (0), after
// the member's store (1), after the barrier (2) and at the end (3).
template <int MEMBERS, class Member, class Combine, class Marks>
__device__ __forceinline__ void fq12_team_block(int32_t* __restrict__ o, int64_t rows, int64_t B, const Mod& m,
                                                const Member& member, const Combine& combine, Marks& marks) {
  team_block(Fq12Team<MEMBERS, Member, Combine>{o, member, combine}, rows * B, B, m, marks);
}
#endif
