// The group law of curve.cuh split over a team of warps, for kernels_curve.cu:
// jac_add and jac_double on 32 elements a block, one product of the base
// field a warp (an Fq product for G1, an Fq2 product for G2), the formula's
// values in shared memory across its dependency levels (CurveTeam, run by
// team_block_on of team.cuh).
//
// Lanes, as in every team (team.cuh): a block works on 32 consecutive
// elements (across rows), lane l of every warp on element blockIdx.x * 32 +
// l, and warp w is member w.  A coordinate is (rows, [2,] 16, B), each its
// own tensor, as for the one-thread kernels.
//
// State.  The inputs (3 or 6 coordinates) are loaded once into the state,
// [entry][word][lane] of Fq entries (fq_tab_store with stride 32), in the
// first phase, whose level's warps read their own operands from device
// memory beside those loads; every product goes to entries of its own:
// nothing is overwritten, so a level may read any value of an earlier level.
// A warp computes one product (curve_product): over Fq a Montgomery product,
// over Fq2 tower.cuh's fq2_mul or fq2_sq, its operands with their pre-sums
// read from the state.
//
// Levels (the products of CurveProduct; after a level, what its readers
// derive):
//   jac_add:  L0  z1s = z1^2      z2s = z2^2      zz = (z1 + z2)^2
//             L1  u1 = x1 z2s     u2 = x2 z1s     z1c = z1 z1s    z2c = z2 z2s
//                 then h = u2 - u1
//             L2  s1 = y1 z2c     s2 = y2 z1c     i = (2h)^2      z3 = (zz - z1s - z2s) h
//                 then r = 2 (s2 - s1)
//             L3  j = h i         v = u1 i        rr = r^2,       and the flag below
//                 then x3 = rr - j - 2v
//             L4  s1j = s1 j      rv = r (v - x3)
//                 then y3 = rv - 2 s1j
//   jac_double: D0  a = x^2     b = y^2         yz = y z
//                   then e = 3a
//               D1  c = b^2     xb2 = (x + b)^2 ee = e^2
//                   then d = 2 (xb2 - a - c), x3 = ee - 2d
//               D2  ed = e (d - x3)
//                   then y3 = ed - 8c, z3 = 2 yz
// The addition takes 4 warps (L1), the doubling 3, over Fq and over Fq2.
//
// Degenerate lanes, in the order of curve.cuh's jac_add.  At L3 the first
// warp without a product there writes each lane's flag, same point and both
// finite (u1 = u2, s1 = s2, z1 != 0, z2 != 0), and at L4 whether any lane's
// is set.  After L4 the addition runs the doubling's levels on p, whose
// coordinates are in the state, only if one is: the levels read that word
// and do nothing otherwise, so a block of generic points pays three
// barriers for them.  The store takes, lane by lane, p where q is infinite,
// else q where p is infinite, else the doubling where the flag is set, else
// the chord.  p + (-p) needs no case: h = 0 gives z3 = 0.
//
// Every sum and difference is taken modulo q and every product reduced at
// once, so each value is the canonical residue and a team's result is that
// of curve.cuh's one-thread formula, bit for bit, whatever the order its
// members run in within a level.  Plain C++ like the other headers, so the
// host tests run the same code; only team_block_on is device code.
#pragma once

#include "curve.cuh"
#include "team.cuh"

// The products of the two laws in level order: jac_add's five levels (global
// levels 0-4), then jac_double's three (5-7).
enum CurveProduct {
  C_Z1S, C_Z2S, C_ZZ,        // L0
  C_U1, C_U2, C_Z1C, C_Z2C,  // L1
  C_S1, C_S2, C_I, C_Z3,     // L2
  C_J, C_V, C_RR,            // L3
  C_S1J, C_RV,               // L4
  C_A, C_B, C_YZ,            // D0
  C_C, C_XB2, C_EE,          // D1
  C_ED,                      // D2
  C_PRODUCTS
};
#define BN_CURVE_DOUBLE_LEVEL 5  // the global level of D0

// The first product of global level gl (gl = 8: the end).
BN_CONSTEXPR int curve_level_start(int gl) {
  return gl == 0 ? C_Z1S : gl == 1 ? C_U1 : gl == 2 ? C_S1 : gl == 3 ? C_J : gl == 4 ? C_S1J
       : gl == 5 ? C_A : gl == 6 ? C_C : gl == 7 ? C_ED : C_PRODUCTS;
}

BN_CONSTEXPR bool curve_is_sq(int k) {
  return k == C_Z1S || k == C_Z2S || k == C_ZZ || k == C_I || k == C_RR || k == C_A || k == C_B || k == C_C ||
         k == C_XB2 || k == C_EE;
}

// A value of type Fq or Fq2 at entry e of the state (an Fq2 takes e, e + 1).
BN_DEV void curve_put(uint32_t* s, int e, const Fq& v) { fq_tab_store(s, BN_TEAM_LANES, e, v); }
BN_DEV void curve_put(uint32_t* s, int e, const Fq2& v) {
  fq_tab_store(s, BN_TEAM_LANES, e, v.c0);
  fq_tab_store(s, BN_TEAM_LANES, e + 1, v.c1);
}
BN_DEV void curve_get(const uint32_t* s, int e, Fq& v) { v = fq_tab_load(s, BN_TEAM_LANES, e); }
BN_DEV void curve_get(const uint32_t* s, int e, Fq2& v) {
  v.c0 = fq_tab_load(s, BN_TEAM_LANES, e);
  v.c1 = fq_tab_load(s, BN_TEAM_LANES, e + 1);
}

// The sums and differences of the formulas: over Fq inline, over Fq2 the
// team's calls of team.cuh.
BN_DEV Fq ct_add(const Fq& a, const Fq& b, const Mod& m) { return fq_add(a, b, m); }
BN_DEV Fq ct_sub(const Fq& a, const Fq& b, const Mod& m) { return fq_sub(a, b, m); }
BN_DEV Fq2 ct_add(const Fq2& a, const Fq2& b, const Mod& m) { return team_add(a, b, m); }
BN_DEV Fq2 ct_sub(const Fq2& a, const Fq2& b, const Mod& m) { return team_sub(a, b, m); }
template <class F>
BN_DEV F ct_dbl(const F& a, const Mod& m) {
  return ct_add(a, a, m);
}

// Coefficient i of a value, for the stores.
BN_DEV Fq curve_coeff(const Fq& v, int) { return v; }
BN_DEV Fq curve_coeff(const Fq2& v, int i) { return i ? v.c1 : v.c0; }

// The product a b of one warp (a square has b = a): over Fq a Montgomery
// product, over Fq2 tower.cuh's fq2_mul or fq2_sq, its Montgomery products
// one after another.
BN_DEV Fq curve_product(bool, const Fq& a, const Fq& b, const Mod& m) { return fq_mont_mul(a, b, m); }
BN_DEV Fq2 curve_product(bool sq, const Fq2& a, const Fq2& b, const Mod& m) {
  return sq ? fq2_sq(a, m) : fq2_mul(a, b, m);
}

// The warps of the team: the most products of any level it runs (global
// levels 0-7 for the addition, which may run the doubling's, 5-7 for the
// doubling).
template <bool kAdd>
BN_CONSTEXPR int curve_team_warps() {
  int w = 0;
  for (int gl = kAdd ? 0 : BN_CURVE_DOUBLE_LEVEL; gl < 8; gl++)
    w = curve_level_start(gl + 1) - curve_level_start(gl) > w ? curve_level_start(gl + 1) - curve_level_start(gl) : w;
  return w;
}

// Fq number 0 of element e in a (rows, W, 16, B) coordinate: a 32-bit
// division where the sizes allow it (a 64-bit one is a long routine).
BN_DEV int64_t curve_offset(int64_t e, int64_t B, int W) {
  if ((((uint64_t)e | (uint64_t)B) >> 32) == 0) {
    const uint32_t e32 = (uint32_t)e, b32 = (uint32_t)B;
    return (int64_t)(e32 / b32) * W * BN_NLIMB * B + (e32 % b32);
  }
  return (e / B) * W * BN_NLIMB * B + e % B;
}

// Where a level's operands find the inputs: the state, or (the first level,
// beside the loads) device memory.
template <class F>
struct CurveFromState {
  const uint32_t* s;
  BN_DEV F operator()(int k) const {
    F v;
    curve_get(s, k * FieldIO<F>::width, v);
    return v;
  }
};

template <class F>
struct CurveFromMemory {
  const int32_t* const* in;
  int64_t off, B;
  BN_DEV F operator()(int k) const { return FieldIO<F>::load(in[k] + off, B); }
};

// jac_add (kAdd) or jac_double over F.  in[] are the coordinates x1, y1, z1
// (and x2, y2, z2), out[] x3, y3, z3.
template <class F, bool kAdd>
struct CurveTeam {
  static constexpr int W = FieldIO<F>::width;
  static constexpr int kInputs = kAdd ? 6 : 3;
  static constexpr int kFirstLevel = kAdd ? 0 : BN_CURVE_DOUBLE_LEVEL;  // the global level of phase 0
  static constexpr int kLevels = 8 - kFirstLevel;
  static constexpr int kWarps = curve_team_warps<kAdd>();
  static constexpr int kPhases = kLevels + 1;  // the loads with the first level, the other levels, the stores
  static constexpr int kFirstProduct = kAdd ? C_Z1S : C_A;
  static constexpr int kEntries = (kInputs + C_PRODUCTS - kFirstProduct) * W;  // the inputs, then the products
  static constexpr int kFlagWarp = 3;  // no product at L3 (j, v, rr) or L4 (s1j, rv)
  struct Shared {
    uint32_t state[kEntries][BN_NW][BN_TEAM_LANES];
    uint32_t flag[BN_TEAM_LANES];  // same finite point, lane by lane (jac_add)
    uint32_t any;                  // some lane's flag is set
  };
  const int32_t* in[kInputs];
  int32_t* out[3];

  static BN_DEV F input(const uint32_t* s, int k) { return CurveFromState<F>{s}(k); }
  static BN_CONSTEXPR int entry(int k) { return (kInputs + k - kFirstProduct) * W; }
  static BN_DEV F val(const uint32_t* s, int k) {
    F v;
    curve_get(s, entry(k), v);
    return v;
  }

  // What later levels derive from the products.
  static BN_DEV F h_of(const uint32_t* s, const Mod& m) { return ct_sub(val(s, C_U2), val(s, C_U1), m); }
  static BN_DEV F r_of(const uint32_t* s, const Mod& m) {
    return ct_dbl(ct_sub(val(s, C_S2), val(s, C_S1), m), m);
  }
  static BN_DEV F add_x3(const uint32_t* s, const Mod& m) {
    return ct_sub(ct_sub(val(s, C_RR), val(s, C_J), m), ct_dbl(val(s, C_V), m), m);
  }
  static BN_DEV F dbl_e(const uint32_t* s, const Mod& m) {
    const F a = val(s, C_A);
    return ct_add(ct_dbl(a, m), a, m);
  }
  static BN_DEV F dbl_d(const uint32_t* s, const Mod& m) {
    return ct_dbl(ct_sub(ct_sub(val(s, C_XB2), val(s, C_A), m), val(s, C_C), m), m);
  }
  static BN_DEV F dbl_x3(const uint32_t* s, const Mod& m) {
    return ct_sub(val(s, C_EE), ct_dbl(dbl_d(s, m), m), m);
  }

  // The operands of product k (a square gets b = a); in(i) is input i.
  template <class In>
  static BN_DEV void operands(int k, const In& in, const uint32_t* s, F& a, F& b, const Mod& m) {
    switch (k) {
      case C_Z1S: a = in(2); b = a; break;
      case C_Z2S: a = in(5); b = a; break;
      case C_ZZ: a = ct_add(in(2), in(5), m); b = a; break;
      case C_U1: a = in(0); b = val(s, C_Z2S); break;
      case C_U2: a = in(3); b = val(s, C_Z1S); break;
      case C_Z1C: a = in(2); b = val(s, C_Z1S); break;
      case C_Z2C: a = in(5); b = val(s, C_Z2S); break;
      case C_S1: a = in(1); b = val(s, C_Z2C); break;
      case C_S2: a = in(4); b = val(s, C_Z1C); break;
      case C_I: a = ct_dbl(h_of(s, m), m); b = a; break;
      case C_Z3: a = ct_sub(ct_sub(val(s, C_ZZ), val(s, C_Z1S), m), val(s, C_Z2S), m); b = h_of(s, m); break;
      case C_J: a = h_of(s, m); b = val(s, C_I); break;
      case C_V: a = val(s, C_U1); b = val(s, C_I); break;
      case C_RR: a = r_of(s, m); b = a; break;
      case C_S1J: a = val(s, C_S1); b = val(s, C_J); break;
      case C_RV: a = r_of(s, m); b = ct_sub(val(s, C_V), add_x3(s, m), m); break;
      case C_A: a = in(0); b = a; break;
      case C_B: a = in(1); b = a; break;
      case C_YZ: a = in(1); b = in(2); break;
      case C_C: a = val(s, C_B); b = a; break;
      case C_XB2: a = ct_add(in(0), val(s, C_B), m); b = a; break;
      case C_EE: a = dbl_e(s, m); b = a; break;
      default: a = dbl_e(s, m); b = ct_sub(dbl_d(s, m), dbl_x3(s, m), m); break;  // C_ED
    }
  }

  // Output coordinate j of the chord (jac_add's general case) or the doubling.
  static BN_DEV F chord_out(int j, const uint32_t* s, const Mod& m) {
    if (j == 0) return add_x3(s, m);
    if (j == 1) return ct_sub(val(s, C_RV), ct_dbl(val(s, C_S1J), m), m);
    return val(s, C_Z3);
  }
  static BN_DEV F double_out(int j, const uint32_t* s, const Mod& m) {
    if (j == 0) return dbl_x3(s, m);
    if (j == 1) return ct_sub(val(s, C_ED), ct_dbl(ct_dbl(ct_dbl(val(s, C_C), m), m), m), m);
    return ct_dbl(val(s, C_YZ), m);
  }

  // Global level gl: warp w computes the level's product w, if it has one,
  // into that product's entries; the operands' inputs from `from`.  At L3
  // warp kFlagWarp writes each lane's flag, at L4 whether any is set; the
  // doubling's levels after L4 run only if one is.
  template <class In>
  BN_DEV void level(int gl, const TeamLane& t, const In& from, uint32_t* s, Shared& sh, const Mod& m) const {
    if (kAdd && gl >= BN_CURVE_DOUBLE_LEVEL && !sh.any) return;
#pragma unroll
    for (int k = curve_level_start(gl); k < curve_level_start(gl + 1); k++) {
      if (t.w == k - curve_level_start(gl)) {
        F a, b;
        operands(k, from, s, a, b, m);
        curve_put(s, entry(k), curve_product(curve_is_sq(k), a, b, m));
      }
    }
    if (kAdd && gl == 3 && t.w == kFlagWarp) {
      const bool same = f_eq(val(s, C_U1), val(s, C_U2)) & f_eq(val(s, C_S1), val(s, C_S2));
      sh.flag[t.lane] = same & !f_is_zero(input(s, 2)) & !f_is_zero(input(s, 5));
    }
    if (kAdd && gl == 4 && t.w == kFlagWarp) {
      uint32_t any = 0;
#pragma unroll
      for (int l = 0; l < BN_TEAM_LANES; l++) any |= sh.flag[l];
      sh.any = any;  // every lane of the warp writes the same value
    }
  }

  // Phase 0: warp w loads input coefficients c = w, w + kWarps, ... into
  // the state, and runs the first level on inputs it reads from device
  // memory itself; phase p runs level p; the last phase stores output
  // coefficient c = w, w + kWarps, ...
  BN_DEV void phase(int p, const TeamLane& t, int64_t B, Shared& sh, const Mod& m) const {
    uint32_t* s = &sh.state[0][0][0] + t.lane;
    if (p > 0 && p < kLevels) {
      level(kFirstLevel + p, t, CurveFromState<F>{s}, s, sh, m);
      return;
    }
    const int64_t off = curve_offset(t.e, B, W);
    if (p == 0) {
#pragma unroll
      for (int i = 0; i < (kInputs * W + kWarps - 1) / kWarps; i++) {
        const int c = t.w + i * kWarps;
        if (c < kInputs * W)
          fq_tab_store(s, BN_TEAM_LANES, c, fq_load(in[c / W] + off + (int64_t)(c % W) * BN_NLIMB * B, B));
      }
      level(kFirstLevel, t, CurveFromMemory<F>{in, off, B}, s, sh, m);
    } else if (t.live) {
      for (int c = t.w; c < 3 * W; c += kWarps) {
        const int j = c / W;
        F v;
        if (!kAdd) v = double_out(j, s, m);
        else if (f_is_zero(input(s, 5))) v = input(s, j);      // q infinite: p
        else if (f_is_zero(input(s, 2))) v = input(s, 3 + j);  // p infinite: q
        else if (sh.flag[t.lane]) v = double_out(j, s, m);
        else v = chord_out(j, s, m);
        fq_store(out[j] + off + (int64_t)(c % W) * BN_NLIMB * B, B, curve_coeff(v, c % W));
      }
    }
  }
};
