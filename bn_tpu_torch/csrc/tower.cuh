// Fq2 / Fq6 / Fq12 tower formulas on register values, one batch element per
// thread.  Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3-xi) with xi = 9+u,
// Fq12 = Fq6[w]/(w^2-v).
//
// Every product is reduced at once (one Montgomery reduction per base-field
// product), and every sum and difference is brought back below the modulus,
// so each intermediate is canonical and the results are bit-identical to the
// plain PyTorch versions.  The formulas are those of the reference crate
// (src/fields/fq2.rs, fq6.rs, fq12.rs), which pin the golden vectors.
#pragma once

#include "fq.cuh"

struct Fq2 {
  Fq c0, c1;
};
struct Fq6 {
  Fq2 c0, c1, c2;
};
struct Fq12 {
  Fq6 c0, c1;
};

// Memory layout of a tower element: coefficient axes in front of (16, B), so
// base-field coefficient k of the element at p starts at p + k*16*stride.
BN_DEV Fq2 fq2_load(const int32_t* p, int64_t stride) {
  Fq2 r;
  r.c0 = fq_load(p, stride);
  r.c1 = fq_load(p + BN_NLIMB * stride, stride);
  return r;
}

BN_DEV void fq2_store(int32_t* p, int64_t stride, const Fq2& a) {
  fq_store(p, stride, a.c0);
  fq_store(p + BN_NLIMB * stride, stride, a.c1);
}

BN_DEV Fq6 fq6_load(const int32_t* p, int64_t stride) {
  Fq6 r;
  r.c0 = fq2_load(p, stride);
  r.c1 = fq2_load(p + 2 * BN_NLIMB * stride, stride);
  r.c2 = fq2_load(p + 4 * BN_NLIMB * stride, stride);
  return r;
}

BN_DEV void fq6_store(int32_t* p, int64_t stride, const Fq6& a) {
  fq2_store(p, stride, a.c0);
  fq2_store(p + 2 * BN_NLIMB * stride, stride, a.c1);
  fq2_store(p + 4 * BN_NLIMB * stride, stride, a.c2);
}

BN_DEV Fq12 fq12_load(const int32_t* p, int64_t stride) {
  Fq12 r;
  r.c0 = fq6_load(p, stride);
  r.c1 = fq6_load(p + 6 * BN_NLIMB * stride, stride);
  return r;
}

BN_DEV void fq12_store(int32_t* p, int64_t stride, const Fq12& a) {
  fq6_store(p, stride, a.c0);
  fq6_store(p + 6 * BN_NLIMB * stride, stride, a.c1);
}

// ---- Fq2 -------------------------------------------------------------------

BN_DEV Fq2 fq2_add(const Fq2& a, const Fq2& b, const Mod& m) {
  Fq2 r;
  r.c0 = fq_add(a.c0, b.c0, m);
  r.c1 = fq_add(a.c1, b.c1, m);
  return r;
}

BN_DEV Fq2 fq2_sub(const Fq2& a, const Fq2& b, const Mod& m) {
  Fq2 r;
  r.c0 = fq_sub(a.c0, b.c0, m);
  r.c1 = fq_sub(a.c1, b.c1, m);
  return r;
}

BN_DEV Fq2 fq2_dbl(const Fq2& a, const Mod& m) { return fq2_add(a, a, m); }

BN_DEV Fq2 fq2_neg(const Fq2& a, const Mod& m) {
  Fq2 r;
  r.c0 = fq_neg(a.c0, m);
  r.c1 = fq_neg(a.c1, m);
  return r;
}

// 3a as 2a + a.
BN_DEV Fq2 fq2_mul3(const Fq2& a, const Mod& m) { return fq2_add(fq2_dbl(a, m), a, m); }

// Both coefficients times a base-field element, 2 products.
BN_DEV Fq2 fq2_scale_fq(const Fq2& a, const Fq& k, const Mod& m) {
  Fq2 r;
  r.c0 = fq_mont_mul(a.c0, k, m);
  r.c1 = fq_mont_mul(a.c1, k, m);
  return r;
}

// Karatsuba product, 3 base-field products (src/fields/fq2.rs:139-155).
BN_DEV Fq2 fq2_mul(const Fq2& a, const Fq2& b, const Mod& m) {
  Fq aa = fq_mont_mul(a.c0, b.c0, m);
  Fq bb = fq_mont_mul(a.c1, b.c1, m);
  Fq cc = fq_mont_mul(fq_add(a.c0, a.c1, m), fq_add(b.c0, b.c1, m), m);
  Fq2 r;
  r.c0 = fq_sub(aa, bb, m);
  r.c1 = fq_sub(fq_sub(cc, aa, m), bb, m);
  return r;
}

// Complex squaring, 2 products (src/fields/fq2.rs:112-123).
BN_DEV Fq2 fq2_sq(const Fq2& a, const Mod& m) {
  Fq p0 = fq_mont_mul(fq_add(a.c0, a.c1, m), fq_sub(a.c0, a.c1, m), m);
  Fq p1 = fq_mont_mul(a.c0, a.c1, m);
  Fq2 r;
  r.c0 = p0;
  r.c1 = fq_add(p1, p1, m);
  return r;
}

// Multiply by xi = 9 + u: (9 c0 - c1, c0 + 9 c1), no product.
BN_DEV Fq2 fq2_xi(const Fq2& a, const Mod& m) {
  Fq2 r;
  r.c0 = fq_sub(fq_mul9(a.c0, m), a.c1, m);
  r.c1 = fq_add(fq_mul9(a.c1, m), a.c0, m);
  return r;
}

// ---- Fq6 -------------------------------------------------------------------

BN_DEV Fq6 fq6_add(const Fq6& a, const Fq6& b, const Mod& m) {
  Fq6 r;
  r.c0 = fq2_add(a.c0, b.c0, m);
  r.c1 = fq2_add(a.c1, b.c1, m);
  r.c2 = fq2_add(a.c2, b.c2, m);
  return r;
}

BN_DEV Fq6 fq6_sub(const Fq6& a, const Fq6& b, const Mod& m) {
  Fq6 r;
  r.c0 = fq2_sub(a.c0, b.c0, m);
  r.c1 = fq2_sub(a.c1, b.c1, m);
  r.c2 = fq2_sub(a.c2, b.c2, m);
  return r;
}

// v * a (src/fields/fq6.rs:59-65).
BN_DEV Fq6 fq6_nr(const Fq6& a, const Mod& m) {
  Fq6 r;
  r.c0 = fq2_xi(a.c2, m);
  r.c1 = a.c0;
  r.c2 = a.c1;
  return r;
}

// Karatsuba product, 6 Fq2 products (src/fields/fq6.rs:144-158).
BN_DEV Fq6 fq6_mul(const Fq6& a, const Fq6& b, const Mod& m) {
  Fq2 aa = fq2_mul(a.c0, b.c0, m);
  Fq2 bb = fq2_mul(a.c1, b.c1, m);
  Fq2 cc = fq2_mul(a.c2, b.c2, m);
  Fq2 t12 = fq2_mul(fq2_add(a.c1, a.c2, m), fq2_add(b.c1, b.c2, m), m);
  Fq2 t01 = fq2_mul(fq2_add(a.c0, a.c1, m), fq2_add(b.c0, b.c1, m), m);
  Fq2 t02 = fq2_mul(fq2_add(a.c0, a.c2, m), fq2_add(b.c0, b.c2, m), m);
  Fq6 r;
  r.c0 = fq2_add(fq2_xi(fq2_sub(fq2_sub(t12, bb, m), cc, m), m), aa, m);
  r.c1 = fq2_add(fq2_sub(fq2_sub(t01, aa, m), bb, m), fq2_xi(cc, m), m);
  r.c2 = fq2_sub(fq2_add(fq2_sub(t02, aa, m), bb, m), cc, m);
  return r;
}

// ---- Fq12 ------------------------------------------------------------------

// Karatsuba product, 3 Fq6 products = 54 base-field products
// (src/fields/fq12.rs:295-307).
BN_DEV Fq12 fq12_mul(const Fq12& a, const Fq12& b, const Mod& m) {
  Fq6 aa = fq6_mul(a.c0, b.c0, m);
  Fq6 bb = fq6_mul(a.c1, b.c1, m);
  Fq6 cc = fq6_mul(fq6_add(a.c0, a.c1, m), fq6_add(b.c0, b.c1, m), m);
  Fq12 r;
  r.c0 = fq6_add(fq6_nr(bb, m), aa, m);
  r.c1 = fq6_sub(fq6_sub(cc, aa, m), bb, m);
  return r;
}

// Square, 2 Fq6 products = 36 base-field products (src/fields/fq12.rs:275-282).
BN_DEV Fq12 fq12_sq(const Fq12& a, const Mod& m) {
  Fq6 ab = fq6_mul(a.c0, a.c1, m);
  Fq6 t = fq6_mul(fq6_add(fq6_nr(a.c1, m), a.c0, m), fq6_add(a.c0, a.c1, m), m);
  Fq12 r;
  r.c0 = fq6_sub(fq6_sub(t, ab, m), fq6_nr(ab, m), m);
  r.c1 = fq6_add(ab, ab, m);
  return r;
}

// Sparse line multiply by (x0 + x2 v) + (x4 v) w, 13 Fq2 products = 39
// base-field products (src/fields/fq12.rs:107-176).
BN_DEV Fq12 fq12_mul_by_024(const Fq12& a, const Fq2& x0, const Fq2& x2, const Fq2& x4, const Mod& m) {
  const Fq2 &z0 = a.c0.c0, &z1 = a.c0.c1, &z2 = a.c0.c2;
  const Fq2 &z3 = a.c1.c0, &z4 = a.c1.c1, &z5 = a.c1.c2;

  Fq2 d0 = fq2_mul(z0, x0, m);
  Fq2 d2 = fq2_mul(z2, x2, m);
  Fq2 d4 = fq2_mul(z4, x4, m);
  Fq2 t2a = fq2_add(z0, z4, m);
  Fq2 t1a = fq2_add(z0, z2, m);
  Fq2 s0 = fq2_add(fq2_add(z1, z3, m), z5, m);
  Fq12 r;

  Fq2 s1 = fq2_mul(z1, x2, m);
  Fq2 t3 = fq2_add(s1, d4, m);
  Fq2 t4 = fq2_xi(t3, m);
  r.c0.c0 = fq2_add(t4, d0, m);

  t3 = fq2_mul(z5, x4, m);
  s1 = fq2_add(s1, t3, m);
  t3 = fq2_add(t3, d2, m);
  t4 = fq2_xi(t3, m);
  t3 = fq2_mul(z1, x0, m);
  s1 = fq2_add(s1, t3, m);
  r.c0.c1 = fq2_add(t4, t3, m);

  Fq2 t0 = fq2_add(x0, x2, m);
  t3 = fq2_sub(fq2_sub(fq2_mul(t1a, t0, m), d0, m), d2, m);
  t4 = fq2_mul(z3, x4, m);
  s1 = fq2_add(s1, t4, m);
  r.c0.c2 = fq2_add(t3, t4, m);

  t0 = fq2_add(z2, z4, m);
  Fq2 t1 = fq2_add(x2, x4, m);
  t3 = fq2_sub(fq2_sub(fq2_mul(t0, t1, m), d2, m), d4, m);
  t4 = fq2_xi(t3, m);
  t3 = fq2_mul(z3, x0, m);
  s1 = fq2_add(s1, t3, m);
  r.c1.c0 = fq2_add(t4, t3, m);

  t3 = fq2_mul(z5, x2, m);
  s1 = fq2_add(s1, t3, m);
  t4 = fq2_xi(t3, m);
  t0 = fq2_add(x0, x4, m);
  t3 = fq2_sub(fq2_sub(fq2_mul(t2a, t0, m), d0, m), d4, m);
  r.c1.c1 = fq2_add(t4, t3, m);

  t0 = fq2_add(fq2_add(x0, x2, m), x4, m);
  t3 = fq2_mul(s0, t0, m);
  r.c1.c2 = fq2_sub(t3, s1, m);
  return r;
}

// One pair of the Granger-Scott squaring: tmp = zu*zv,
// ta = (zu+zv)(xi zv + zu) - tmp - xi tmp, tb = 2 tmp.
BN_DEV void fq12_gs_pair(const Fq2& zu, const Fq2& zv, Fq2& ta, Fq2& tb, const Mod& m) {
  Fq2 tmp = fq2_mul(zu, zv, m);
  Fq2 big = fq2_mul(fq2_add(zu, zv, m), fq2_add(fq2_xi(zv, m), zu, m), m);
  ta = fq2_sub(fq2_sub(big, tmp, m), fq2_xi(tmp, m), m);
  tb = fq2_add(tmp, tmp, m);
}

// 3t - 2z and 3t + 2z.
BN_DEV Fq2 fq2_m3_sub(const Fq2& t, const Fq2& z, const Mod& m) {
  Fq2 r = fq2_sub(t, z, m);
  r = fq2_add(r, r, m);
  return fq2_add(r, t, m);
}

BN_DEV Fq2 fq2_m3_add(const Fq2& t, const Fq2& z, const Mod& m) {
  Fq2 r = fq2_add(t, z, m);
  r = fq2_add(r, r, m);
  return fq2_add(r, t, m);
}

// Granger-Scott squaring in the cyclotomic subgroup, 6 Fq2 products = 18
// base-field products (src/fields/fq12.rs:178-227).
BN_DEV Fq12 fq12_cyclo_sq(const Fq12& a, const Mod& m) {
  const Fq2 &z0 = a.c0.c0, &z4 = a.c0.c1, &z3 = a.c0.c2;
  const Fq2 &z2 = a.c1.c0, &z1 = a.c1.c1, &z5 = a.c1.c2;
  Fq2 t0, t1, t2, t3, t4, t5;
  fq12_gs_pair(z0, z1, t0, t1, m);
  fq12_gs_pair(z2, z3, t2, t3, m);
  fq12_gs_pair(z4, z5, t4, t5, m);
  Fq12 r;
  r.c0.c0 = fq2_m3_sub(t0, z0, m);  // nz0
  r.c0.c1 = fq2_m3_sub(t2, z4, m);  // nz4
  r.c0.c2 = fq2_m3_sub(t4, z3, m);  // nz3
  r.c1.c0 = fq2_m3_add(fq2_xi(t5, m), z2, m);  // nz2
  r.c1.c1 = fq2_m3_add(t1, z1, m);  // nz1
  r.c1.c2 = fq2_m3_add(t3, z5, m);  // nz5
  return r;
}

// ---- steps of the G2 line-coefficient precompute ----------------------------

// A point of the twist in the ladder's projective coordinates, and the three
// coefficients of the line a step emits.  In memory both are (3, 2) structs in
// front of (16, B): Fq2 number k starts at p + 2*k*16*stride.
struct G2Proj {
  Fq2 x, y, z;
};
struct EllCoeffs {
  Fq2 ell_0, ell_vw, ell_vv;
};

BN_DEV G2Proj g2_load(const int32_t* p, int64_t stride) {
  G2Proj r;
  r.x = fq2_load(p, stride);
  r.y = fq2_load(p + 2 * BN_NLIMB * stride, stride);
  r.z = fq2_load(p + 4 * BN_NLIMB * stride, stride);
  return r;
}

BN_DEV void g2_store(int32_t* p, int64_t stride, const G2Proj& r) {
  fq2_store(p, stride, r.x);
  fq2_store(p + 2 * BN_NLIMB * stride, stride, r.y);
  fq2_store(p + 4 * BN_NLIMB * stride, stride, r.z);
}

BN_DEV EllCoeffs ell_load(const int32_t* p, int64_t stride) {
  EllCoeffs c;
  c.ell_0 = fq2_load(p, stride);
  c.ell_vw = fq2_load(p + 2 * BN_NLIMB * stride, stride);
  c.ell_vv = fq2_load(p + 4 * BN_NLIMB * stride, stride);
  return c;
}

BN_DEV void ell_store(int32_t* p, int64_t stride, const EllCoeffs& c) {
  fq2_store(p, stride, c.ell_0);
  fq2_store(p + 2 * BN_NLIMB * stride, stride, c.ell_vw);
  fq2_store(p + 4 * BN_NLIMB * stride, stride, c.ell_vv);
}

// Doubling step on the running point (src/groups/mod.rs:612-634): r <- 2r and
// the tangent line's coefficients, 28 base-field products.  two_inv is 1/2 and
// twist_b the twist's curve constant, both in Montgomery form from the host.
BN_DEV void g2_double_step(G2Proj& r, EllCoeffs& c, const Fq& two_inv, const Fq2& twist_b, const Mod& m) {
  Fq2 a = fq2_scale_fq(fq2_mul(r.x, r.y, m), two_inv, m);
  Fq2 b = fq2_sq(r.y, m);
  Fq2 cc = fq2_sq(r.z, m);
  Fq2 e = fq2_mul(fq2_mul3(cc, m), twist_b, m);
  Fq2 f = fq2_mul3(e, m);
  Fq2 g = fq2_scale_fq(fq2_add(b, f, m), two_inv, m);
  Fq2 h = fq2_sub(fq2_sq(fq2_add(r.y, r.z, m), m), fq2_add(b, cc, m), m);
  Fq2 j = fq2_sq(r.x, m);
  Fq2 e_sq = fq2_sq(e, m);
  r.x = fq2_mul(a, fq2_sub(b, f, m), m);
  r.y = fq2_sub(fq2_sq(g, m), fq2_mul3(e_sq, m), m);
  r.z = fq2_mul(b, h, m);
  c.ell_0 = fq2_xi(fq2_sub(e, b, m), m);
  c.ell_vw = fq2_neg(h, m);
  c.ell_vv = fq2_mul3(j, m);
}

// Mixed-addition step with the affine base point (bx, by)
// (src/groups/mod.rs:591-610): r <- r + base and the chord's coefficients, 37
// base-field products.  Note ell_vw / ell_vv: here (d, -e), above (-h, 3j).
BN_DEV void g2_madd_step(G2Proj& r, EllCoeffs& c, const Fq2& bx, const Fq2& by, const Mod& m) {
  Fq2 d = fq2_sub(r.x, fq2_mul(r.z, bx, m), m);
  Fq2 e = fq2_sub(r.y, fq2_mul(r.z, by, m), m);
  Fq2 f = fq2_sq(d, m);
  Fq2 g = fq2_sq(e, m);
  Fq2 h = fq2_mul(d, f, m);
  Fq2 i = fq2_mul(r.x, f, m);
  Fq2 j = fq2_sub(fq2_add(fq2_mul(r.z, g, m), h, m), fq2_dbl(i, m), m);
  Fq2 ny = fq2_sub(fq2_mul(e, fq2_sub(i, j, m), m), fq2_mul(h, r.y, m), m);
  r.x = fq2_mul(d, j, m);
  r.y = ny;
  r.z = fq2_mul(r.z, h, m);
  c.ell_0 = fq2_xi(fq2_sub(fq2_mul(e, bx, m), fq2_mul(d, by, m), m), m);
  c.ell_vw = d;
  c.ell_vv = fq2_neg(e, m);
}

// ---- one step of the Miller loop --------------------------------------------

// The sparse multiply by a line as the precompute emits it: (ell_0, ell_vw,
// ell_vv), unscaled.  Note the slots: fq12_mul_by_024 takes x2 = ell_vv and
// x4 = ell_vw.
BN_DEV Fq12 fq12_mul_by_line(const Fq12& f, const EllCoeffs& c, const Mod& m) {
  return fq12_mul_by_024(f, c.ell_0, c.ell_vv, c.ell_vw, m);
}

// One Miller step (src/groups/mod.rs:494-509): f^2 on a doubling step
// (kSquare), then the line evaluated at the affine G1 point (px, py), that
// is ell_vw scaled by py and ell_vv by px, multiplied in sparsely.  36 + 4 +
// 39 = 79 base-field products with the square, 43 without.
template <bool kSquare>
BN_DEV Fq12 fq12_miller_step(const Fq12& f, const EllCoeffs& c, const Fq& px, const Fq& py, const Mod& m) {
  Fq2 vv = fq2_scale_fq(c.ell_vv, px, m);
  Fq2 vw = fq2_scale_fq(c.ell_vw, py, m);
  if constexpr (kSquare) return fq12_mul_by_024(fq12_sq(f, m), c.ell_0, vv, vw, m);
  return fq12_mul_by_024(f, c.ell_0, vv, vw, m);
}
