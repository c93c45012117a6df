// Prime-field arithmetic on 256-bit values held in registers, for one batch
// element per thread.
//
// A field element is eight 32-bit words, little endian, in Montgomery form
// with R = 2^256.  In device memory the same value is sixteen 16-bit limbs,
// one int32 each, laid out (..., 16, B) with the batch innermost: fq_load /
// fq_store pack and unpack, and with neighbouring threads on neighbouring b
// the load of one limb by a warp is one coalesced 128-byte line.
//
// The modulus and -m^-1 mod 2^32 are kernel arguments (struct Mod), so the
// same code serves the base field Fq and the scalar field Fr.
//
// The sums and the Montgomery product are carry chains of carry.cuh's
// primitives: PTX on the card, plain C++ twins on the host, so the header
// also compiles for the host and its formulas can be checked without a card.
#pragma once

#include "carry.cuh"

#define BN_NW 8      // 32-bit words of a field element
#define BN_NLIMB 16  // 16-bit limbs of a field element in memory
// Elements a block of a team or group kernel works on: one per lane of a
// warp (fq12_team.cuh, fq12_cyclo_team.cuh, g2_step_team.cuh, fq_group.cuh).
#define BN_TEAM_LANES 32

struct Fq {
  uint32_t w[BN_NW];
};

struct Mod {
  uint32_t w[BN_NW];  // modulus words
  uint32_t inv;       // -modulus^-1 mod 2^32
};

// Limb i of the element at p lies at p[i * stride]; stride is the batch size.
BN_DEV Fq fq_load(const int32_t* p, int64_t stride) {
  Fq r;
#pragma unroll
  for (int i = 0; i < BN_NW; i++) {
    uint32_t lo = (uint32_t)p[(int64_t)(2 * i) * stride];
    uint32_t hi = (uint32_t)p[(int64_t)(2 * i + 1) * stride];
    r.w[i] = (lo & 0xFFFFu) | (hi << 16);
  }
  return r;
}

BN_DEV void fq_store(int32_t* p, int64_t stride, const Fq& a) {
#pragma unroll
  for (int i = 0; i < BN_NW; i++) {
    p[(int64_t)(2 * i) * stride] = (int32_t)(a.w[i] & 0xFFFFu);
    p[(int64_t)(2 * i + 1) * stride] = (int32_t)(a.w[i] >> 16);
  }
}

// r = a + b as one chain over the eight words; the carry out is left in c.
BN_DEV void fq_add_chain(Carry& c, uint32_t* r, const uint32_t* a, const uint32_t* b) {
  r[0] = add_cc(c, a[0], b[0]);
#pragma unroll
  for (int i = 1; i < BN_NW; i++) r[i] = addc_cc(c, a[i], b[i]);
}

// r = a - b as one chain; the borrow out is left in c.
BN_DEV void fq_sub_chain(Carry& c, uint32_t* r, const uint32_t* a, const uint32_t* b) {
  r[0] = sub_cc(c, a[0], b[0]);
#pragma unroll
  for (int i = 1; i < BN_NW; i++) r[i] = subc_cc(c, a[i], b[i]);
}

// r = a + b, returns the carry out.
BN_DEV uint32_t fq_add_raw(Fq& r, const Fq& a, const Fq& b) {
  Carry c;
  fq_add_chain(c, r.w, a.w, b.w);
  return addc(c, 0u, 0u);
}

// t (< 2m, with carry flag hi) -> t mod m: one conditional subtraction,
// branch-free.  The chain of t - m runs on into a ninth word, hi - borrow,
// which is all ones exactly when hi:t < m; so hi costs one instruction.
BN_DEV Fq fq_cond_sub(const Fq& t, uint32_t hi, const Mod& m) {
  Carry c;
  Fq d;
  fq_sub_chain(c, d.w, t.w, m.w);
  const bool keep = (int32_t)subc(c, hi, 0u) < 0;
  Fq r;
#pragma unroll
  for (int i = 0; i < BN_NW; i++) r.w[i] = keep ? t.w[i] : d.w[i];
  return r;
}

// (a + b) mod m.  a + b < 2m < 2^255: the sum never carries out of its
// eight words, so the subtraction's ninth word is 0 - borrow.
BN_DEV Fq fq_add(const Fq& a, const Fq& b, const Mod& m) {
  Carry c;
  Fq s;
  fq_add_chain(c, s.w, a.w, b.w);
  return fq_cond_sub(s, 0u, m);
}

// (a - b) mod m: a - b, then m & (0 - borrow) added back (its carry out
// dropped: it is the 2^256 the borrow lent).
BN_DEV Fq fq_sub(const Fq& a, const Fq& b, const Mod& m) {
  Carry c;
  Fq d;
  fq_sub_chain(c, d.w, a.w, b.w);
  const uint32_t lend = subc(c, 0u, 0u);  // all ones on a borrow
  Fq mm;
#pragma unroll
  for (int i = 0; i < BN_NW; i++) mm.w[i] = m.w[i] & lend;
  Carry c2;
  Fq r;
  fq_add_chain(c2, r.w, d.w, mm.w);
  return r;
}

// (m - a) mod m, with -0 = 0.  a < m: the chain m - a never borrows.
BN_DEV Fq fq_neg(const Fq& a, const Mod& m) {
  uint32_t nz = 0;
#pragma unroll
  for (int i = 0; i < BN_NW; i++) nz |= a.w[i];
  Carry c;
  Fq d;
  fq_sub_chain(c, d.w, m.w, a.w);
#pragma unroll
  for (int i = 0; i < BN_NW; i++) d.w[i] = nz ? d.w[i] : 0u;
  return d;
}

BN_DEV Fq fq_dbl(const Fq& a, const Mod& m) { return fq_add(a, a, m); }

// 9a by a doubling chain: 2a, 4a, 8a, 8a + a.
BN_DEV Fq fq_mul9(const Fq& a, const Mod& m) {
  Fq r = fq_dbl(a, m);
  r = fq_dbl(r, m);
  r = fq_dbl(r, m);
  return fq_add(r, a, m);
}

// Montgomery product a*b*2^-256 mod m, a and b < m; result < m.
// Word-2^32 CIOS (coarsely integrated operand scanning): for each word b_i of
// b, the row a b_i and the reduction row mu m, then one word down.  After
// each row the accumulator T is below 2m (with m < 2^254 the ninth word of
// t < 2m is never needed: the result is eight words and the final
// subtraction's hi flag is 0).
//
// T is kept as two arrays that the chains add into, never into each other
// (Emmart, Luitjens, Weems, Woolley, ARITH 2018): T = x + y 2^32, with the
// 64-bit products a_j b_i and mu m_j of even j added into x at words j, j+1
// and those of odd j into y at words j-1, j.  A row's four products into one
// array land on disjoint word pairs, so each is one lo, hi pair of a carry
// chain and a chain is eight multiply-adds.  The reduction makes x's word 0
// zero; moving T one word down then swaps the arrays' roles: y is the array
// at word 0 and x, two words down, the one at word 1.  x's old word 1, which
// falls to word 0, is added into y's word 0, and its carry starts the chain
// of the next row's odd products.  Both arrays stay below 2^256 (y 2^32 <= T
// < 2^288 while a row runs), so the carry out of a chain into the array at
// word 0 goes into the top word of the other, and a chain into the array at
// word 1 never carries out.
//
// Row 0 on empty arrays: the eight products, no chain.
BN_DEV void fq_mont_first_row(uint32_t* x, uint32_t* y, const Fq& a, uint32_t b) {
#pragma unroll
  for (int j = 0; j < BN_NW; j += 2) {
    x[j] = a.w[j] * b;
    x[j + 1] = mul_hi(a.w[j], b);
    y[j] = a.w[j + 1] * b;
    y[j + 1] = mul_hi(a.w[j + 1], b);
  }
}

// x += the even words of v times k (v_j k at x's words j, j+1), the chain's
// carry out into y's top word.
BN_DEV void fq_mont_mad_even(uint32_t* x, uint32_t* y, const uint32_t* v, uint32_t k) {
  Carry c;
  x[0] = mad_lo_cc(c, v[0], k, x[0]);
  x[1] = madc_hi_cc(c, v[0], k, x[1]);
#pragma unroll
  for (int j = 2; j < BN_NW; j += 2) {
    x[j] = madc_lo_cc(c, v[j], k, x[j]);
    x[j + 1] = madc_hi_cc(c, v[j], k, x[j + 1]);
  }
  y[BN_NW - 1] = addc(c, y[BN_NW - 1], 0u);
}

// x, y += the even and odd words of v times k (x at word 0, y at word 1).
BN_DEV void fq_mont_mad(uint32_t* x, uint32_t* y, const uint32_t* v, uint32_t k) {
  Carry c;
  y[0] = mad_lo_cc(c, v[1], k, y[0]);
  y[1] = madc_hi_cc(c, v[1], k, y[1]);
#pragma unroll
  for (int j = 2; j < BN_NW - 2; j += 2) {
    y[j] = madc_lo_cc(c, v[j + 1], k, y[j]);
    y[j + 1] = madc_hi_cc(c, v[j + 1], k, y[j + 1]);
  }
  y[BN_NW - 2] = madc_lo_cc(c, v[BN_NW - 1], k, y[BN_NW - 2]);
  y[BN_NW - 1] = madc_hi(c, v[BN_NW - 1], k, y[BN_NW - 1]);
  fq_mont_mad_even(x, y, v, k);
}

// The reduction row: T += mu m with mu = -x_0 / m mod 2^32, so x_0 becomes 0.
BN_DEV void fq_mont_reduce(uint32_t* x, uint32_t* y, const Mod& m) {
  fq_mont_mad(x, y, m.w, x[0] * m.inv);
}

// One word down, then row i (i > 0).  On entry T = y + x 2^32 with y[0] = 0;
// x is the new array at word 0, y, moved two words down, the one at word 1.
BN_DEV void fq_mont_row(uint32_t* x, uint32_t* y, const Fq& a, uint32_t b) {
  Carry c;
  x[0] = add_cc(c, x[0], y[1]);
#pragma unroll
  for (int j = 0; j < BN_NW - 2; j += 2) {
    y[j] = madc_lo_cc(c, a.w[j + 1], b, y[j + 2]);
    y[j + 1] = madc_hi_cc(c, a.w[j + 1], b, y[j + 3]);
  }
  y[BN_NW - 2] = madc_lo_cc(c, a.w[BN_NW - 1], b, 0u);
  y[BN_NW - 1] = madc_hi(c, a.w[BN_NW - 1], b, 0u);
  fq_mont_mad_even(x, y, a.w, b);
}

BN_DEV Fq fq_mont_mul_inline(const Fq& a, const Fq& b, const Mod& m) {
  uint32_t x[BN_NW], y[BN_NW];
  fq_mont_first_row(x, y, a, b.w[0]);
  fq_mont_reduce(x, y, m);
#pragma unroll
  for (int i = 1; i < BN_NW; i += 2) {  // rows 1..7: the arrays swap roles each row
    fq_mont_row(y, x, a, b.w[i]);
    fq_mont_reduce(y, x, m);
    if (i + 1 < BN_NW) {
      fq_mont_row(x, y, a, b.w[i + 1]);
      fq_mont_reduce(x, y, m);
    }
  }
  // after row 7 T = y + x 2^32 with y[0] = 0: T / 2^32 = x + (y >> 32) < 2m
  Carry c;
  Fq r;
  r.w[0] = add_cc(c, x[0], y[1]);
#pragma unroll
  for (int i = 1; i < BN_NW - 1; i++) r.w[i] = addc_cc(c, x[i], y[i + 1]);
  r.w[BN_NW - 1] = addc(c, x[BN_NW - 1], 0u);
  return fq_cond_sub(r, 0u, m);
}

// The same product as a real call (operands by value, so that they travel in
// registers), for kernels that use it dozens of times.
static BN_DEV_NOINLINE Fq fq_mont_mul_call(Fq a, Fq b, Mod m) {
  return fq_mont_mul_inline(a, b, m);
}

// A translation unit chooses which one its formulas use by defining
// BN_MUL_OUT_OF_LINE before including this header.
#ifdef BN_MUL_OUT_OF_LINE
#define fq_mont_mul fq_mont_mul_call
#else
#define fq_mont_mul fq_mont_mul_inline
#endif

// ---- fixed-exponent power ---------------------------------------------------

// An exponent below 2^256 as eight 32-bit words, little endian, and the count
// nd >= 1 of its base-16 digits (leading zero digits stripped).  It is the
// same for every thread, so it travels as a kernel argument.
struct Exp {
  uint32_t w[BN_NW];
  int nd;
};

// Base-16 digit k of e (k = 0 is the least significant).
BN_DEV uint32_t exp_digit(const Exp& e, int k) { return (e.w[k >> 3] >> (4 * (k & 7))) & 15u; }

// The window table a^0..a^15 of one element lives in scratch memory the caller
// provides: word j of entry k at tab[(k*BN_NW + j)*stride].  A kernel passes
// shared memory offset by its thread index with stride = block size (so the
// threads of a warp touch neighbouring banks); the host passes a plain array
// with stride 1.
BN_DEV void fq_tab_store(uint32_t* tab, int stride, int k, const Fq& v) {
#pragma unroll
  for (int j = 0; j < BN_NW; j++) tab[(k * BN_NW + j) * stride] = v.w[j];
}

BN_DEV Fq fq_tab_load(const uint32_t* tab, int stride, int k) {
  Fq r;
#pragma unroll
  for (int j = 0; j < BN_NW; j++) r.w[j] = tab[(k * BN_NW + j) * stride];
  return r;
}

// a^e in the Montgomery domain by a window-4 ladder: the table once, then for
// each further digit four squarings and one product with table[digit].  `one`
// is the Montgomery one R mod m, an exact identity of the product, so a zero
// digit needs no branch; the leading digit is never zero, so 0^e = 0.
// The order of products is that of fields/fp.py's loop of mont_mul launches.
BN_DEV Fq fq_pow_fixed(const Fq& a, const Fq& one, const Exp& e, uint32_t* tab, int stride, const Mod& m) {
  Fq t = one;
  fq_tab_store(tab, stride, 0, t);
#pragma unroll 1
  for (int k = 1; k < 16; k++) {
    t = fq_mont_mul(t, a, m);
    fq_tab_store(tab, stride, k, t);
  }
  Fq res = fq_tab_load(tab, stride, exp_digit(e, e.nd - 1));
#pragma unroll 1
  for (int k = e.nd - 2; k >= 0; k--) {
#pragma unroll 1
    for (int s = 0; s < 4; s++) res = fq_mont_mul(res, res, m);
    res = fq_mont_mul(res, fq_tab_load(tab, stride, exp_digit(e, k)), m);
  }
  return res;
}
