// Jacobian group law of G1 (over Fq) and G2 (over Fq2) on register values,
// one point per thread: dbl-2009-l doubling and add-2007-bl addition
// (src/groups/mod.rs:228-312), written once over the base field.
//
// A base field F is Fq or Fq2; the overloads f_add, f_sub, f_mul, f_sq,
// f_is_zero, f_eq below give both the same names.  Every product is reduced
// at once and every sum brought back below the modulus, so each coordinate of
// a result is the canonical residue: the same limbs as the per-field-op law
// of curve.py and as the TPU bodies' lazy reduction.
//
// Plain C++ like fq.cuh and tower.cuh, so the formulas also compile for the
// host.
#pragma once

#include "tower.cuh"

// ---- the base field under one set of names -----------------------------------

BN_DEV Fq f_add(const Fq& a, const Fq& b, const Mod& m) { return fq_add(a, b, m); }
BN_DEV Fq2 f_add(const Fq2& a, const Fq2& b, const Mod& m) { return fq2_add(a, b, m); }
BN_DEV Fq f_sub(const Fq& a, const Fq& b, const Mod& m) { return fq_sub(a, b, m); }
BN_DEV Fq2 f_sub(const Fq2& a, const Fq2& b, const Mod& m) { return fq2_sub(a, b, m); }
BN_DEV Fq f_mul(const Fq& a, const Fq& b, const Mod& m) { return fq_mont_mul(a, b, m); }
BN_DEV Fq2 f_mul(const Fq2& a, const Fq2& b, const Mod& m) { return fq2_mul(a, b, m); }
BN_DEV Fq f_sq(const Fq& a, const Mod& m) { return fq_mont_mul(a, a, m); }
BN_DEV Fq2 f_sq(const Fq2& a, const Mod& m) { return fq2_sq(a, m); }

BN_DEV bool f_is_zero(const Fq& a) {
  uint32_t nz = 0;
#pragma unroll
  for (int i = 0; i < BN_NW; i++) nz |= a.w[i];
  return nz == 0;
}
BN_DEV bool f_is_zero(const Fq2& a) { return f_is_zero(a.c0) & f_is_zero(a.c1); }

BN_DEV bool f_eq(const Fq& a, const Fq& b) {
  uint32_t d = 0;
#pragma unroll
  for (int i = 0; i < BN_NW; i++) d |= a.w[i] ^ b.w[i];
  return d == 0;
}
BN_DEV bool f_eq(const Fq2& a, const Fq2& b) { return f_eq(a.c0, b.c0) & f_eq(a.c1, b.c1); }

// Memory: a coordinate is (..., 16, B) for Fq and (..., 2, 16, B) for Fq2;
// `width` base-field coefficients of 16 limbs each lie in front of the batch.
template <class F>
struct FieldIO;
template <>
struct FieldIO<Fq> {
  static const int width = 1;
  static BN_DEV Fq load(const int32_t* p, int64_t stride) { return fq_load(p, stride); }
  static BN_DEV void store(int32_t* p, int64_t stride, const Fq& a) { fq_store(p, stride, a); }
};
template <>
struct FieldIO<Fq2> {
  static const int width = 2;
  static BN_DEV Fq2 load(const int32_t* p, int64_t stride) { return fq2_load(p, stride); }
  static BN_DEV void store(int32_t* p, int64_t stride, const Fq2& a) { fq2_store(p, stride, a); }
};

// ---- the group law -----------------------------------------------------------

// A point in Jacobian coordinates; z = 0 is the point at infinity, which the
// package writes (0, 1, 0).
template <class F>
struct Jac {
  F x, y, z;
};

template <class F>
BN_DEV F f_dbl(const F& a, const Mod& m) {
  return f_add(a, a, m);
}

// dbl-2009-l: 7 products over Fq, 16 over Fq2 (5 squarings and 2 products).
// Safe at infinity: z3 = 2yz = 0.
template <class F>
BN_DEV Jac<F> jac_double(const Jac<F>& p, const Mod& m) {
  F a = f_sq(p.x, m);
  F b = f_sq(p.y, m);
  F yz = f_mul(p.y, p.z, m);
  F c = f_sq(b, m);
  F d = f_dbl(f_sub(f_sub(f_sq(f_add(p.x, b, m), m), a, m), c, m), m);
  F e = f_add(f_dbl(a, m), a, m);
  Jac<F> r;
  r.x = f_sub(f_sq(e, m), f_dbl(d, m), m);
  F c8 = f_dbl(f_dbl(f_dbl(c, m), m), m);
  r.y = f_sub(f_mul(e, f_sub(d, r.x, m), m), c8, m);
  r.z = f_dbl(yz, m);
  return r;
}

// add-2007-bl with the degenerate cases of src/groups/mod.rs:272-312: 16
// products over Fq, 43 over Fq2 (5 squarings and 11 products), and the
// doubling's on top where both operands are the same finite point.
//
// The selects keep the order of the per-field-op law: the chord, then the
// doubling where u1 = u2 and s1 = s2, then q where p is infinite, then p
// where q is infinite.  For infinity + infinity every u and s is 0, so the
// doubling's condition holds too; the last select hands p back as it came.
// The doubling is therefore computed only where it can reach the result
// (same finite point), behind a branch that costs nothing when no lane of a
// warp takes it.  p + (-p) needs no case: h = 0 gives z3 = 0.
template <class F>
BN_DEV Jac<F> jac_add(const Jac<F>& p, const Jac<F>& q, const Mod& m) {
  bool p_inf = f_is_zero(p.z);
  bool q_inf = f_is_zero(q.z);

  F z1s = f_sq(p.z, m);
  F z2s = f_sq(q.z, m);
  F u1 = f_mul(p.x, z2s, m);
  F u2 = f_mul(q.x, z1s, m);
  F s1 = f_mul(p.y, f_mul(q.z, z2s, m), m);
  F s2 = f_mul(q.y, f_mul(p.z, z1s, m), m);
  bool same = f_eq(u1, u2) & f_eq(s1, s2);

  F h = f_sub(u2, u1, m);
  F i = f_sq(f_dbl(h, m), m);
  F j = f_mul(h, i, m);
  F v = f_mul(u1, i, m);
  F r = f_dbl(f_sub(s2, s1, m), m);
  F s1j = f_mul(s1, j, m);
  Jac<F> o;
  o.x = f_sub(f_sub(f_sq(r, m), j, m), f_dbl(v, m), m);
  o.y = f_sub(f_mul(r, f_sub(v, o.x, m), m), f_dbl(s1j, m), m);
  F zz = f_sq(f_add(p.z, q.z, m), m);
  o.z = f_mul(f_sub(f_sub(zz, z1s, m), z2s, m), h, m);

  if (same & !p_inf & !q_inf) o = jac_double(p, m);
  if (p_inf) o = q;
  if (q_inf) o = p;
  return o;
}
