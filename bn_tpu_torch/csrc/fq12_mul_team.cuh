// The Fq12 product of kernel_fq12_mul.cu with lazy reduction: 54 base-field
// products kept whole (fq_dw.cuh) and one Montgomery reduction per output
// coefficient, 12 in all.  The members and their order are fq12_team.cuh's
// (18 Fq2 products of the three Fq6 Karatsuba products); the staging, the
// scratch and the combines are this header's own.
//
// A block works on 32 elements in three phases (team.cuh's skeleton).
// Staging: 12 warps load the 24 base-field coefficients of both operands,
// each once, into shared memory (all loads in flight at once), with the sums
// c0 + c1 that the third Fq6 product takes.  Members: warp w computes Fq2
// product w on its operands x, y (canonical coefficients and pre-sums,
// fq12_mul_operand, read from the stage) with
// three whole products and no reduction, and stores two 16-word values:
//   X0 = x0 y0 - x1 y1 + q^2          in (0, 2 q^2), standing for x0 y0 - x1 y1
//   X1 = (x0 + x1)(y0 + y1) - x0 y0 - x1 y1 = x0 y1 + x1 y0   in [0, 2 q^2)
// (the sums x0 + x1, y0 + y1 not reduced, below 2q) at entries 2w, 2w + 1 of
// the scratch, [entry][word][lane].  Shared memory: 36,864 bytes of stage and
// 73,728 of scratch a block, dynamic.
//
// Combines: warp i, 0 <= i < 12, computes output base-field coefficient i
// (Fq2 coefficient i / 2, component i % 2) as one signed sum of scratch
// entries, weights +-1 and +-9 (xi = 9 + u taken on whole values: xi(x) =
// (9 x0 - x1, x0 + 9 x1)), plus K q^2 so that the sum is never negative; one
// REDC and dw_canonical give the canonical coefficient.  The weights come
// from the recombination below (fq12_mul_xy, the formula the eager combine
// had), computed at compile time into the plan kFq12MulPlan, which the
// combines read from constant memory.
//
// Bounds: for each combine the sum's worst case over all members' ranges is
// computed from q at compile time (fq12_mul_combine_fits) and static_asserted
// to be non-negative and inside dw_redc's and dw_canonical's ranges, so a
// change of a formula that breaks a bound fails the build.
// tests/test_torch_csrc_host.py recomputes the same bounds from its own
// derivation with Python integers.
//
// Each output is the canonical residue, so the result equals tower.cuh's
// fq12_mul and the plain version bit for bit.  Plain C++ like the other
// headers, so the host tests run the same code.
#pragma once

#include "fq12_team.cuh"
#include "fq_dw.cuh"

#define BN_MUL_ENTRIES (2 * BN_TEAM_MEMBERS)  // scratch entries: two a member
#define BN_MUL_COMBINES 12                    // base-field coefficients of the result
#define BN_MUL_MAX_TERMS 24                   // scratch entries one combine reads, at most
#define BN_MUL_OFFSET_K 86                    // the combines add K q^2

// ---- the recombination, as signed sums of the member products ----------------

// An Fq2 value as the coefficients of the 18 members' Fq2 products.
struct Fq12MulLin {
  int c[BN_TEAM_MEMBERS];
};

BN_CONSTEXPR Fq12MulLin lin_prod(int k, int j) {
  Fq12MulLin r{};
  r.c[6 * k + j] = 1;
  return r;
}

BN_CONSTEXPR Fq12MulLin lin_add(const Fq12MulLin& a, const Fq12MulLin& b, int s) {
  Fq12MulLin r{};
  for (int w = 0; w < BN_TEAM_MEMBERS; w++) r.c[w] = a.c[w] + s * b.c[w];
  return r;
}

// fq12_team.cuh's parts of Fq6 product k: u = t12 - bb - cc, v = t01 - aa - bb,
// r2 = t02 - aa + bb - cc; and x_C - x_A - x_B.
BN_CONSTEXPR Fq12MulLin lin_u(int k) {
  return lin_add(lin_add(lin_prod(k, 3), lin_prod(k, 1), -1), lin_prod(k, 2), -1);
}

BN_CONSTEXPR Fq12MulLin lin_v(int k) {
  return lin_add(lin_add(lin_prod(k, 4), lin_prod(k, 0), -1), lin_prod(k, 1), -1);
}

BN_CONSTEXPR Fq12MulLin lin_r2(int k) {
  return lin_add(lin_add(lin_add(lin_prod(k, 5), lin_prod(k, 0), -1), lin_prod(k, 1), 1), lin_prod(k, 2), -1);
}

BN_CONSTEXPR Fq12MulLin lin_c_minus_ab(const Fq12MulLin& a, const Fq12MulLin& b, const Fq12MulLin& c) {
  return lin_add(lin_add(c, a, -1), b, -1);
}

// Output Fq2 coefficient c = xi(x) + y of the Fq12 Karatsuba with the three
// Fq6 products A, B, C (k = 0, 1, 2): out.c0 = v B + A, out.c1 = C - A - B,
// v (x0, x1, x2) = (xi x2, x0, x1), xi taken once an output:
//   c0 = xi(r2_B + u_A) + aa_A         c3 = xi(u_C - u_A - u_B) + (aa_C - aa_A - aa_B)
//   c1 = xi(u_B + cc_A) + (aa_B + v_A) c4 = xi(cc_C - cc_A - cc_B) + (v_C - v_A - v_B)
//   c2 = xi(cc_B) + (v_B + r2_A)       c5 = r2_C - r2_A - r2_B.
struct Fq12MulXY {
  Fq12MulLin x, y;
};

BN_CONSTEXPR Fq12MulXY fq12_mul_xy(int c) {
  if (c == 0) return {lin_add(lin_r2(1), lin_u(0), 1), lin_prod(0, 0)};
  if (c == 1) return {lin_add(lin_u(1), lin_prod(0, 2), 1), lin_add(lin_prod(1, 0), lin_v(0), 1)};
  if (c == 2) return {lin_prod(1, 2), lin_add(lin_v(1), lin_r2(0), 1)};
  if (c == 3)
    return {lin_c_minus_ab(lin_u(0), lin_u(1), lin_u(2)),
            lin_c_minus_ab(lin_prod(0, 0), lin_prod(1, 0), lin_prod(2, 0))};
  if (c == 4)
    return {lin_c_minus_ab(lin_prod(0, 2), lin_prod(1, 2), lin_prod(2, 2)), lin_c_minus_ab(lin_v(0), lin_v(1), lin_v(2))};
  return {Fq12MulLin{}, lin_c_minus_ab(lin_r2(0), lin_r2(1), lin_r2(2))};
}

// The weight of scratch entry e (member e / 2, X0 or X1) in combine i:
// component 0 of xi(x) + y is 9 x0 - x1 + y0, component 1 x0 + 9 x1 + y1.
BN_CONSTEXPR int fq12_mul_weight(int i, int e) {
  const Fq12MulXY xy = fq12_mul_xy(i / 2);
  const int w = e / 2, s = e % 2, comp = i % 2;
  const int x = xy.x.c[w], y = s == comp ? xy.y.c[w] : 0;
  return (s == comp ? 9 * x : comp == 0 ? -x : x) + y;
}

// ---- the plan: the combines' terms and the offsets --------------------------------

#define BN_MUL_NINE 64  // a term's flag: weight 9

// A combine adds its terms in 16 columns of 64 bits, column j the terms'
// words j times their weights' magnitudes, and a term of negative weight w
// as |w| (2^512 - 1 - X), the complement of its words: so each term is 16
// independent multiply-adds, and the complements' surplus, (2^512 - 1) times
// the negative weights' magnitudes, comes off with the offset.
struct Fq12MulPlan {
  int8_t term[BN_MUL_COMBINES][BN_MUL_MAX_TERMS];  // +-(entry + 1), BN_MUL_NINE added for weight 9
  int8_t terms[BN_MUL_COMBINES];
  uint32_t q2[BN_DW];                           // q^2, the members' X0 offset
  uint32_t offset[BN_MUL_COMBINES][BN_DW_ACC];  // K q^2 - (2^512 - 1) sum_{w<0} |w|, mod 2^544
  uint32_t est;                                 // dw_canonical's multiplier for q
};

BN_CONSTEXPR Fq12MulPlan fq12_mul_plan() {
  Fq12MulPlan p{};
  const DwInt q2 = dw_int_mul(dw_q(), dw_q()), kq2 = dw_int_mul_small(q2, BN_MUL_OFFSET_K);
  const DwInt ones = dw_int_sub(dw_int_pow2(512), dw_int(1));
  for (int i = 0; i < BN_MUL_COMBINES; i++) {
    int n = 0;
    uint32_t neg = 0;
    for (int e = 0; e < BN_MUL_ENTRIES; e++) {
      const int wt = fq12_mul_weight(i, e), mag = wt < 0 ? -wt : wt;
      if (wt == 0) continue;
      const int code = e + 1 + (mag == 9 ? BN_MUL_NINE : 0);
      p.term[i][n++] = (int8_t)(wt < 0 ? -code : code);
      if (wt < 0) neg += (uint32_t)mag;
    }
    p.terms[i] = (int8_t)n;
    const DwInt off = dw_int_sub(dw_int_add(dw_int_pow2(32 * BN_DW_ACC), kq2), dw_int_mul_small(ones, neg));
    for (int j = 0; j < BN_DW_ACC; j++) p.offset[i][j] = off.w[j];
  }
  for (int j = 0; j < BN_DW; j++) p.q2[j] = q2.w[j];
  p.est = dw_est();
  return p;
}

// Every weight is 0, +-1 or +-9, and no combine reads more than its room.
BN_CONSTEXPR bool fq12_mul_plan_complete() {
  for (int i = 0; i < BN_MUL_COMBINES; i++) {
    int n = 0;
    for (int e = 0; e < BN_MUL_ENTRIES; e++) {
      const int wt = fq12_mul_weight(i, e);
      if (wt != 0 && wt != 1 && wt != -1 && wt != 9 && wt != -9) return false;
      n += wt != 0;
    }
    if (n > BN_MUL_MAX_TERMS) return false;
  }
  // a column: the offset's word and at most 24 words times 9, far inside 64 bits
  return BN_MUL_ENTRIES < BN_MUL_NINE && BN_MUL_ENTRIES + 1 + BN_MUL_NINE <= 127 && BN_MUL_MAX_TERMS * 9 + 1 < (1 << 30);
}

// The scratch entries' ranges: X0 = x0 y0 - x1 y1 + q^2 in [q^2 - (q-1)^2,
// q^2 + (q-1)^2], X1 = x0 y1 + x1 y0 in [0, 2 (q-1)^2].
struct Fq12MulRanges {
  DwInt min[2], max[2];
};

BN_CONSTEXPR Fq12MulRanges fq12_mul_ranges() {
  const DwInt q1 = dw_int_sub(dw_q(), dw_int(1)), qq = dw_int_mul(dw_q(), dw_q()), q1q1 = dw_int_mul(q1, q1);
  return {{dw_int_sub(qq, q1q1), dw_int(0)}, {dw_int_add(qq, q1q1), dw_int_add(q1q1, q1q1)}};
}

// The member's values inside their words: x0 + x1 < 2^256, the whole
// products and x0 y0 + x1 y1 <= (2q - 2)^2 < 2^512, X0 < 2^512.
BN_CONSTEXPR bool fq12_mul_member_fits() {
  const DwInt two_q1 = dw_int_mul_small(dw_int_sub(dw_q(), dw_int(1)), 2);
  return dw_int_less(two_q1, dw_int_pow2(256)) && dw_int_less(dw_int_mul(two_q1, two_q1), dw_int_pow2(512)) &&
         dw_int_less(fq12_mul_ranges().max[0], dw_int_pow2(512));
}

// Combine i's sum over the entries' ranges: its least value (>= 0 asked) and
// its largest (dw_redc_fits asked): lo = K q^2 + sum_{w>0} w min - sum_{w<0}
// |w| max, hi = K q^2 + sum_{w>0} w max - sum_{w<0} |w| min.
BN_CONSTEXPR bool fq12_mul_combine_fits(int i) {
  const Fq12MulRanges x = fq12_mul_ranges();
  const DwInt base = dw_int_mul_small(dw_int_mul(dw_q(), dw_q()), BN_MUL_OFFSET_K);
  DwInt pos_lo = base, pos_hi = base, neg_lo{}, neg_hi{};
  for (int e = 0; e < BN_MUL_ENTRIES; e++) {
    const int wt = fq12_mul_weight(i, e);
    const uint32_t mag = (uint32_t)(wt < 0 ? -wt : wt);
    const DwInt lo = dw_int_mul_small(x.min[e % 2], mag), hi = dw_int_mul_small(x.max[e % 2], mag);
    if (wt > 0) {
      pos_lo = dw_int_add(pos_lo, lo);
      pos_hi = dw_int_add(pos_hi, hi);
    } else if (wt < 0) {
      neg_lo = dw_int_add(neg_lo, lo);
      neg_hi = dw_int_add(neg_hi, hi);
    }
  }
  return !dw_int_less(pos_lo, neg_hi) && dw_redc_fits(dw_int_sub(pos_hi, neg_lo));
}

static_assert(fq12_mul_plan_complete(), "a combine's weight is not 0, +-1 or +-9, or it reads too many entries");
static_assert(fq12_mul_member_fits(), "a member's whole products leave 16 words");
static_assert(fq12_mul_combine_fits(0) && fq12_mul_combine_fits(1), "combine 0 or 1 leaves its range");
static_assert(fq12_mul_combine_fits(2) && fq12_mul_combine_fits(3), "combine 2 or 3 leaves its range");
static_assert(fq12_mul_combine_fits(4) && fq12_mul_combine_fits(5), "combine 4 or 5 leaves its range");
static_assert(fq12_mul_combine_fits(6) && fq12_mul_combine_fits(7), "combine 6 or 7 leaves its range");
static_assert(fq12_mul_combine_fits(8) && fq12_mul_combine_fits(9), "combine 8 or 9 leaves its range");
static_assert(fq12_mul_combine_fits(10) && fq12_mul_combine_fits(11), "combine 10 or 11 leaves its range");

#ifdef __CUDACC__
#define BN_MUL_PLAN static __constant__
#else
#define BN_MUL_PLAN static const
#endif
BN_MUL_PLAN Fq12MulPlan kFq12MulPlan = fq12_mul_plan();

// ---- the team ----------------------------------------------------------------------

// The operand of Fq2 product j on an Fq6 operand z (a source's at()):
// one coefficient or the sum of two.
template <class Element>
BN_DEV Fq2 fq12_mul_operand(const Element& z, int j, const Mod& m) {
  if (j < 3) return z(j);
  const int s = j == 3 ? 1 : 0, t = j == 4 ? 1 : 2;
  return team_add(z(s), z(t), m);
}

// Member w on the staged operands `in` (for each of a and b, the Fq6 operands
// c0, c1 and c0 + c1 of the three Fq6 products), its two values into `tab`.
BN_DEV void fq12_mul_member(uint32_t* tab, const uint32_t* in, int w, const Mod& m) {
  const int k = w / 6, j = w % 6;
  const Fq2 x = fq12_mul_operand(Fq12Shared{in + 6 * k * BN_NW * BN_TEAM_LANES}, j, m);
  const Fq2 y = fq12_mul_operand(Fq12Shared{in + (18 + 6 * k) * BN_NW * BN_TEAM_LANES}, j, m);
  Fq sx, sy;
  fq_add_raw(sx, x.c0, x.c1);
  fq_add_raw(sy, y.c0, y.c1);
  uint32_t p0[BN_DW], p1[BN_DW], d[BN_DW];
  dw_mul(p0, x.c0.w, y.c0.w);
  dw_mul(p1, x.c1.w, y.c1.w);
  dw_sub(d, p0, p1);
  dw_add(d, d, kFq12MulPlan.q2);
  dw_tab_store(tab, BN_TEAM_LANES, 2 * w, d);
  dw_add(p0, p0, p1);
  dw_mul(p1, sx.w, sy.w);
  dw_sub(p1, p1, p0);
  dw_tab_store(tab, BN_TEAM_LANES, 2 * w + 1, p1);
}

// Output base-field coefficient i of the product, from the scratch: the
// plan's columns (Fq12MulPlan), carried into 17 words, one REDC.
BN_DEV Fq fq12_mul_combine(int i, const uint32_t* tab, const Mod& m) {
  const Fq12MulPlan& p = kFq12MulPlan;
  uint64_t col[BN_DW];
#pragma unroll
  for (int j = 0; j < BN_DW; j++) col[j] = p.offset[i][j];
  const int terms = p.terms[i];
#pragma unroll 2
  for (int t = 0; t < terms; t++) {
    const int code = p.term[i][t], mag = code < 0 ? -code : code;
    const uint32_t flip = code < 0 ? 0xffffffffu : 0u, k = mag & BN_MUL_NINE ? 9u : 1u;
    const uint32_t* x = tab + ((mag & (BN_MUL_NINE - 1)) - 1) * BN_DW * BN_TEAM_LANES;
#pragma unroll
    for (int j = 0; j < BN_DW; j++) col[j] += (uint64_t)(x[j * BN_TEAM_LANES] ^ flip) * k;
  }
  uint32_t acc[BN_DW_ACC];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < BN_DW; j++) {
    c += col[j];
    acc[j] = (uint32_t)c;
    c >>= 32;
  }
  acc[BN_DW] = (uint32_t)c + p.offset[i][BN_DW];
  uint32_t r[BN_NW + 1];
  dw_redc(r, acc, m);
  return dw_canonical(r, p.est, m);
}

// The team on team.cuh's skeleton (team_block_on, its shared memory
// dynamic), three phases: warps 0-11 stage the block's operands (warp w
// loads base-field coefficient w % 6 of c0 and c1 of a, w < 6, or of b, once,
// and stores both and their sum: the three Fq6 operands the members read);
// the 18 members; the 12 combines, each storing its coefficient of a live
// element.  The modulus must be q.
struct Fq12MulTeam {
  static constexpr int kWarps = BN_TEAM_MEMBERS, kPhases = 3;
  struct Shared {
    uint32_t in[2 * 18][BN_NW][BN_TEAM_LANES];
    uint32_t x[BN_MUL_ENTRIES][BN_DW][BN_TEAM_LANES];
  };
  const int32_t* a;
  const int32_t* b;
  int32_t* o;
  BN_DEV void phase(int p, const TeamLane& t, int64_t B, Shared& sh, const Mod& m) const {
    uint32_t* in = &sh.in[0][0][0] + t.lane;
    uint32_t* tab = &sh.x[0][0][0] + t.lane;
    const int64_t off = fq12_offset(t.e, B);
    if (p == 0) {
      if (t.w < 12) {  // coefficient w % 6 of c0, of c1 and of their sum, of a (w < 6) or of b
        const int side = t.w / 6, s = t.w % 6;
        const int32_t* src = (side ? b : a) + off + (int64_t)s * BN_NLIMB * B;
        const Fq lo = fq_load(src, B), hi = fq_load(src + (int64_t)6 * BN_NLIMB * B, B);
        fq_tab_store(in, BN_TEAM_LANES, 18 * side + s, lo);
        fq_tab_store(in, BN_TEAM_LANES, 18 * side + 6 + s, hi);
        fq_tab_store(in, BN_TEAM_LANES, 18 * side + 12 + s, fq_add(lo, hi, m));
      }
    } else if (p == 1) {
      fq12_mul_member(tab, in, t.w, m);
    } else if (t.w < BN_MUL_COMBINES && t.live) {
      fq_store(o + off + (int64_t)t.w * BN_NLIMB * B, B, fq12_mul_combine(t.w, tab, m));
    }
  }
};

// Whether the modulus words are q's: the plan's offsets are multiples of q^2.
BN_CONSTEXPR bool fq12_mul_modulus_is_q(const uint32_t* mod) {
  const DwInt q = dw_q();
  for (int j = 0; j < BN_NW; j++)
    if (mod[j] != q.w[j]) return false;
  return true;
}
