// The Fq12 product split over a team of 18 members, for kernels that give one
// Fq12 element to several warps instead of one thread.
//
// Member order.  The Fq12 Karatsuba (src/fields/fq12.rs:295-307) takes three
// Fq6 products, and each Fq6 Karatsuba (fq6_mul in tower.cuh) six Fq2
// products; once the pre-sums are taken the 18 Fq2 products are independent.
// Member w, 0 <= w < 18, computes Fq2 product j = w % 6 of Fq6 product
// k = w / 6, where
//   k = 0: (a.c0, b.c0)   1: (a.c1, b.c1)   2: (a.c0 + a.c1, b.c0 + b.c1)
// and, on that pair of Fq6 operands x, y,
//   j = 0: (x0, y0)  1: (x1, y1)  2: (x2, y2)
//       3: (x1 + x2, y1 + y2)  4: (x0 + x1, y0 + y1)  5: (x0 + x2, y0 + y2).
// The team's scratch holds the 18 products, word j of product w at
// prods[(w*2*BN_NW + j) * stride] (the layout of fq_tab_store in fq.cuh, two
// base-field entries per product).  After a barrier, combine c, 0 <= c < 6,
// reads them and returns output coefficient out.c{c/3}.c{c%3}.
//
// Every sum and difference is taken modulo q and every product reduced at
// once, so each intermediate is the canonical element: the result is that of
// tower.cuh's fq12_mul, bit for bit, whatever the order the members run in.
// Plain C++ like the other headers, so the host tests run the same code; only
// the block's skeleton at the end, fq12_mul_team_block, is device code.
#pragma once

#include "tower.cuh"

#define BN_TEAM_MEMBERS 18  // Fq2 products of one Fq12 product
#define BN_TEAM_COMBINES 6  // Fq2 coefficients of the result
#define BN_TEAM_LANES 32    // elements a team kernel's block works on: one per lane

// The team's Fq2 additions and xi are calls, not inlined copies.  A member's
// loads and pre-sums and a combine are straight-line code that each warp runs
// once, in 18 and 6 versions; inlined, the combine took half of a block's
// cycles for at most 32 base-field additions, and as calls two fifths
// (tools/torch_fq12_team_phases.py).  The likely cause is instruction fetch:
// inlined, every instruction of that code is fetched once, from beyond the
// instruction cache; as calls, every warp runs the same few hundred.
static BN_DEV_NOINLINE Fq2 team_add(Fq2 a, Fq2 b, Mod m) { return fq2_add(a, b, m); }
static BN_DEV_NOINLINE Fq2 team_sub(Fq2 a, Fq2 b, Mod m) { return fq2_sub(a, b, m); }
static BN_DEV_NOINLINE Fq2 team_xi(Fq2 a, Mod m) { return fq2_xi(a, m); }

// An Fq2 in the team's scratch: entries 2k and 2k+1 of fq_tab_store.
BN_DEV void fq2_tab_store(uint32_t* tab, int stride, int k, const Fq2& v) {
  fq_tab_store(tab, stride, 2 * k, v.c0);
  fq_tab_store(tab, stride, 2 * k + 1, v.c1);
}

BN_DEV Fq2 fq2_tab_load(const uint32_t* tab, int stride, int k) {
  Fq2 r;
  r.c0 = fq_tab_load(tab, stride, 2 * k);
  r.c1 = fq_tab_load(tab, stride, 2 * k + 1);
  return r;
}

// Fq2 coefficient s (0..2) of Fq6 operand k of the element at p: a.c0.c{s},
// a.c1.c{s} or their sum.  Coefficient c{i}.c{s} starts at p + (3i + s)*2*16*stride.
BN_DEV Fq2 fq12_team_coeff(const int32_t* p, int64_t stride, int k, int s, const Mod& m) {
  const int32_t* lo = p + (int64_t)s * 2 * BN_NLIMB * stride;
  const int32_t* hi = lo + (int64_t)6 * BN_NLIMB * stride;
  if (k == 0) return fq2_load(lo, stride);
  if (k == 1) return fq2_load(hi, stride);
  return team_add(fq2_load(lo, stride), fq2_load(hi, stride), m);
}

// The operand of Fq2 product j on Fq6 operand k: one coefficient or the sum of two.
BN_DEV Fq2 fq12_team_operand(const int32_t* p, int64_t stride, int k, int j, const Mod& m) {
  if (j < 3) return fq12_team_coeff(p, stride, k, j, m);
  int s = j == 3 ? 1 : 0, t = j == 4 ? 1 : 2;
  return team_add(fq12_team_coeff(p, stride, k, s, m), fq12_team_coeff(p, stride, k, t, m), m);
}

// Member w's Fq2 product, 3 base-field products.  It reads from a and b only
// the coefficients it needs: at most four Fq2 of each.
BN_DEV Fq2 fq12_mul_member(int w, const int32_t* a, const int32_t* b, int64_t stride, const Mod& m) {
  int k = w / 6, j = w % 6;
  return fq2_mul(fq12_team_operand(a, stride, k, j, m), fq12_team_operand(b, stride, k, j, m), m);
}

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

// Output coefficient out.c{c/3}.c{c%3} of the Fq12 Karatsuba, with A, B, C
// the three Fq6 products: out.c0 = v*B + A, out.c1 = C - A - B, where
// v*(x0, x1, x2) = (xi x2, x0, x1).  xi is linear, so each output takes it
// once, on the sum of what the recombinations would give it:
//   c0 = xi(B.r2) + A.r0     = xi(r2_B + u_A) + aa_A
//   c1 = B.r0 + A.r1         = xi(u_B + cc_A) + (aa_B + v_A)
//   c2 = B.r1 + A.r2         = xi(cc_B) + (v_B + r2_A)
//   c3 = C.r0 - A.r0 - B.r0  = xi(u_C - u_A - u_B) + (aa_C - aa_A - aa_B)
//   c4 = C.r1 - A.r1 - B.r1  = xi(cc_C - cc_A - cc_B) + (v_C - v_A - v_B)
//   c5 = C.r2 - A.r2 - B.r2.
BN_DEV Fq2 fq12_mul_combine(int c, const uint32_t* prods, int stride, const Mod& m) {
  if (c == 5)
    return fq12_team_c_minus_ab(fq12_team_r2(prods, stride, 0, m), fq12_team_r2(prods, stride, 1, m),
                                fq12_team_r2(prods, stride, 2, m), m);
  Fq2 x, y;  // out = xi(x) + y
  if (c == 0) {
    x = team_add(fq12_team_r2(prods, stride, 1, m), fq12_team_u(prods, stride, 0, m), m);
    y = fq12_team_prod(prods, stride, 0, 0);
  } else if (c == 1) {
    x = team_add(fq12_team_u(prods, stride, 1, m), fq12_team_prod(prods, stride, 0, 2), m);
    y = team_add(fq12_team_prod(prods, stride, 1, 0), fq12_team_v(prods, stride, 0, m), m);
  } else if (c == 2) {
    x = fq12_team_prod(prods, stride, 1, 2);
    y = team_add(fq12_team_v(prods, stride, 1, m), fq12_team_r2(prods, stride, 0, m), m);
  } else if (c == 3) {
    x = fq12_team_c_minus_ab(fq12_team_u(prods, stride, 0, m), fq12_team_u(prods, stride, 1, m),
                             fq12_team_u(prods, stride, 2, m), m);
    y = fq12_team_c_minus_ab(fq12_team_prod(prods, stride, 0, 0), fq12_team_prod(prods, stride, 1, 0),
                             fq12_team_prod(prods, stride, 2, 0), m);
  } else {
    x = fq12_team_c_minus_ab(fq12_team_prod(prods, stride, 0, 2), fq12_team_prod(prods, stride, 1, 2),
                             fq12_team_prod(prods, stride, 2, 2), m);
    y = fq12_team_c_minus_ab(fq12_team_v(prods, stride, 0, m), fq12_team_v(prods, stride, 1, m),
                             fq12_team_v(prods, stride, 2, m), m);
  }
  return team_add(team_xi(x, m), y, m);
}

// Element e of a (rows, 2, 3, 2, 16, B) tensor: row e / B, batch index e % B.
BN_DEV int64_t fq12_offset(int64_t e, int64_t B) { return (e / B) * 12 * BN_NLIMB * B + (e % B); }

#ifdef __CUDACC__
// The block of a team kernel: lane l of warp w works on element
// blockIdx.x * BN_TEAM_LANES + l as member w, the 18 products go to shared
// memory laid out [member][coefficient][word][lane] (neighbouring lanes on
// neighbouring banks), and after one barrier warps 0-5 each combine one output
// Fq2 and store it.  A lane past the end clamps its element to the last one,
// computes with the others and skips the store: no thread leaves before the
// barrier.  `member` computes a member's Fq2 (Fq12MulMember in the package's
// kernel); `marks(i)` is called at the start (0), after the member's store (1),
// after the barrier (2) and at the end (3): it does nothing in the package's
// kernel, and tools/torch_fq12_team_phases.py reads the clock there.
struct Fq12MulMember {
  __device__ __forceinline__ Fq2 operator()(int w, const int32_t* a, const int32_t* b, int64_t stride,
                                            const Mod& m) const {
    return fq12_mul_member(w, a, b, stride, m);
  }
};

struct TeamNoMarks {
  __device__ __forceinline__ void operator()(int) {}
};

template <class Member, class Marks>
__device__ __forceinline__ void fq12_mul_team_block(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                                                    int32_t* __restrict__ o, int64_t rows, int64_t B, const Mod& m,
                                                    const Member& member, Marks& marks) {
  __shared__ uint32_t prods[BN_TEAM_MEMBERS][2][BN_NW][BN_TEAM_LANES];
  marks(0);
  const int lane = threadIdx.x % BN_TEAM_LANES, w = threadIdx.x / BN_TEAM_LANES;
  const int64_t n = rows * B;
  int64_t e = (int64_t)blockIdx.x * BN_TEAM_LANES + lane;
  const bool live = e < n;
  if (!live) e = n - 1;
  const int64_t off = fq12_offset(e, B);
  uint32_t* mine = &prods[0][0][0][0] + lane;  // stride BN_TEAM_LANES: the layout of fq2_tab_store
  fq2_tab_store(mine, BN_TEAM_LANES, w, member(w, a + off, b + off, B, m));
  marks(1);
  __syncthreads();
  marks(2);
  if (w < BN_TEAM_COMBINES && live)
    fq2_store(o + off + (int64_t)w * 2 * BN_NLIMB * B, B, fq12_mul_combine(w, mine, BN_TEAM_LANES, m));
  marks(3);
}
#endif
