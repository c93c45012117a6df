// The Fq12 square split over a team of 12 members, for kernel_fq12_sq.cu
// (layouts and lanes: fq12_team.cuh).
//
// Member order.  tower.cuh's fq12_sq (src/fields/fq12.rs:275-282) takes two
// Fq6 Karatsuba products, ab = a.c0 * a.c1 and t = (a.c0 + v a.c1)(a.c0 +
// a.c1), with v (x0, x1, x2) = (xi x2, x0, x1).  Member w, 0 <= w < 12,
// computes Fq2 product j = w % 6 of Fq6 product k = w / 6, in the order and
// with the operand sums of the Fq12 product's members (fq12_team.cuh), on
//   k = 0: (a.c0, a.c1)
//   k = 1: (a.c0 + v a.c1, a.c0 + a.c1), whose first operand is
//          (a00 + xi a12, a01 + a10, a02 + a11).
// After the barrier, combine c, 0 <= c < 6, returns output coefficient
// out.c{c/3}.c{c%3} of out.c0 = t - ab - v ab, out.c1 = 2 ab, with xi taken
// once an output on the recombination parts u, v, r2 of fq12_team.cuh
// (A for ab, T for t):
//   c0 = xi(u_T - u_A - r2_A) + (aa_T - aa_A)
//   c1 = xi(cc_T - cc_A - u_A) + (v_T - v_A - aa_A)
//   c2 = (r2_T - r2_A - v_A) - xi(cc_A)
//   c3 = 2 (xi(u_A) + aa_A)    c4 = 2 (xi(cc_A) + v_A)    c5 = 2 r2_A.
#pragma once

#include "fq12_team.cuh"
#include "team.cuh"

#define BN_SQ_MEMBERS 12  // Fq2 products of one Fq12 square
#define BN_SQ_BLOCK (BN_TEAM_LANES * BN_SQ_MEMBERS)  // threads of a block: 12 warps
#ifndef BN_SQ_MIN_BLOCKS
#define BN_SQ_MIN_BLOCKS 2  // blocks a multiprocessor that __launch_bounds__ asks registers for
#endif

// Fq2 coefficient s of operand `side` (0 or 1) of Fq6 product k, for the
// element whose view (an Fq12 source's at(), fq12_team.cuh) is z: a.c0.c{s},
// a.c1.c{s}; (a.c0 + v a.c1).c{s}, (a.c0 + a.c1).c{s}.
template <class Element>
BN_DEV Fq2 fq12_sq_coeff(const Element& z, int k, int side, int s, const Mod& m) {
  if (k == 0) return z(3 * side + s);
  if (side == 1) return team_add(z(s), z(3 + s), m);
  const Fq2 hi = z(3 + (s + 2) % 3);  // (v a.c1).c{s} = xi a.c1.c2, a.c1.c0, a.c1.c1
  return team_add(z(s), s == 0 ? team_xi(hi, m) : hi, m);
}

// The operand of Fq2 product j on side `side` of Fq6 product k: one
// coefficient or the sum of two.
template <class Element>
BN_DEV Fq2 fq12_sq_operand(const Element& z, int k, int side, int j, const Mod& m) {
  if (j < 3) return fq12_sq_coeff(z, k, side, j, m);
  const int s = j == 3 ? 1 : 0, t = j == 4 ? 1 : 2;
  return team_add(fq12_sq_coeff(z, k, side, s, m), fq12_sq_coeff(z, k, side, t, m), m);
}

// The member as fq12_team_block calls it, on the element of an Fq12 source:
// device memory in kernel_fq12_sq.cu, the shared state in
// kernel_miller_step.cu.
template <class FSrc>
struct Fq12SqMember {
  FSrc a;
  BN_DEV Fq2 operator()(int w, int64_t e, int64_t B, const Mod& m) const {
    const auto z = a.at(e, B);
    const int k = w / 6, j = w % 6;
    return fq2_mul(fq12_sq_operand(z, k, 0, j, m), fq12_sq_operand(z, k, 1, j, m), m);
  }
};

template <class FSrc>
BN_DEV Fq12SqMember<FSrc> fq12_sq_member(const FSrc& a) {
  return Fq12SqMember<FSrc>{a};
}

// Output coefficient c from the 12 products in the scratch.
struct Fq12SqCombine {
  BN_DEV Fq2 operator()(int c, int64_t, int64_t, const uint32_t* prods, int stride, const Mod& m) const {
    if (c >= 3) {  // out.c1 = 2 ab
      Fq2 t;
      if (c == 3)
        t = team_add(team_xi(fq12_team_u(prods, stride, 0, m), m), fq12_team_prod(prods, stride, 0, 0), m);
      else if (c == 4)
        t = team_add(team_xi(fq12_team_prod(prods, stride, 0, 2), m), fq12_team_v(prods, stride, 0, m), m);
      else
        t = fq12_team_r2(prods, stride, 0, m);
      return team_add(t, t, m);
    }
    if (c == 2)
      return team_sub(fq12_team_c_minus_ab(fq12_team_r2(prods, stride, 0, m), fq12_team_v(prods, stride, 0, m),
                                           fq12_team_r2(prods, stride, 1, m), m),
                      team_xi(fq12_team_prod(prods, stride, 0, 2), m), m);
    Fq2 x, y;  // out = xi(x) + y
    if (c == 0) {
      x = fq12_team_c_minus_ab(fq12_team_u(prods, stride, 0, m), fq12_team_r2(prods, stride, 0, m),
                               fq12_team_u(prods, stride, 1, m), m);
      y = team_sub(fq12_team_prod(prods, stride, 1, 0), fq12_team_prod(prods, stride, 0, 0), m);
    } else {
      x = fq12_team_c_minus_ab(fq12_team_prod(prods, stride, 0, 2), fq12_team_u(prods, stride, 0, m),
                               fq12_team_prod(prods, stride, 1, 2), m);
      y = fq12_team_c_minus_ab(fq12_team_v(prods, stride, 0, m), fq12_team_prod(prods, stride, 0, 0),
                               fq12_team_v(prods, stride, 1, m), m);
    }
    return team_add(team_xi(x, m), y, m);
  }
};
