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
// Everything here is plain C++ on uint32_t/uint64_t (no PTX), so the header
// also compiles for the host and its formulas can be checked without a card.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define BN_DEV __device__ __forceinline__
// The Montgomery product is the one function kept out of line in the tower
// kernels (see tower.cuh): an Fq12 product inlines 54 of them otherwise.
#define BN_DEV_NOINLINE __device__ __noinline__
#else
#define BN_DEV inline
#define BN_DEV_NOINLINE inline
#endif

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

// r = a + b, returns the carry out.
BN_DEV uint32_t fq_add_raw(Fq& r, const Fq& a, const Fq& b) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < BN_NW; i++) {
    c += (uint64_t)a.w[i] + b.w[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// r = a - b, returns the borrow out (1 when a < b).
BN_DEV uint32_t fq_sub_raw(Fq& r, const Fq& a, const uint32_t* b) {
  uint64_t br = 0;
#pragma unroll
  for (int i = 0; i < BN_NW; i++) {
    uint64_t d = (uint64_t)a.w[i] - b[i] - br;
    r.w[i] = (uint32_t)d;
    br = (d >> 32) & 1u;
  }
  return (uint32_t)br;
}

// t (< 2m, with carry flag hi) -> t mod m: one conditional subtract.
BN_DEV Fq fq_cond_sub(const Fq& t, uint32_t hi, const Mod& m) {
  Fq d;
  uint32_t borrow = fq_sub_raw(d, t, m.w);
  bool take = (borrow == 0) | (hi != 0);
  Fq r;
#pragma unroll
  for (int i = 0; i < BN_NW; i++) r.w[i] = take ? d.w[i] : t.w[i];
  return r;
}

// (a + b) mod m.
BN_DEV Fq fq_add(const Fq& a, const Fq& b, const Mod& m) {
  Fq s;
  uint32_t c = fq_add_raw(s, a, b);
  return fq_cond_sub(s, c, m);
}

// (a - b) mod m: add m back on borrow.
BN_DEV Fq fq_sub(const Fq& a, const Fq& b, const Mod& m) {
  Fq d;
  uint32_t borrow = fq_sub_raw(d, a, b.w);
  Fq mm;
#pragma unroll
  for (int i = 0; i < BN_NW; i++) mm.w[i] = borrow ? m.w[i] : 0u;
  Fq r;
  fq_add_raw(r, d, mm);
  return r;
}

// (m - a) mod m, with -0 = 0.
BN_DEV Fq fq_neg(const Fq& a, const Mod& m) {
  uint32_t nz = 0;
#pragma unroll
  for (int i = 0; i < BN_NW; i++) nz |= a.w[i];
  Fq mm;
#pragma unroll
  for (int i = 0; i < BN_NW; i++) mm.w[i] = m.w[i];
  Fq d;
  fq_sub_raw(d, mm, a.w);
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
// Word-2^32 CIOS (coarsely integrated operand scanning): for each word of a,
// one row of the product and one row of the reduction, 2*8*8 + 8 32x32->64
// multiply-adds in all.  t never exceeds 2m, so with m < 2^254 the ninth word
// is a carry flag only.
BN_DEV Fq fq_mont_mul_inline(const Fq& a, const Fq& b, const Mod& m) {
  uint32_t t[BN_NW + 2];
#pragma unroll
  for (int i = 0; i < BN_NW + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < BN_NW; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < BN_NW; j++) {
      uint64_t s = (uint64_t)a.w[i] * b.w[j] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[BN_NW] + c;
    t[BN_NW] = (uint32_t)s;
    t[BN_NW + 1] = (uint32_t)(s >> 32);
    uint32_t mu = t[0] * m.inv;
    c = ((uint64_t)mu * m.w[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < BN_NW; j++) {
      s = (uint64_t)mu * m.w[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[BN_NW] + c;
    t[BN_NW - 1] = (uint32_t)s;
    t[BN_NW] = t[BN_NW + 1] + (uint32_t)(s >> 32);
  }
  Fq r;
#pragma unroll
  for (int i = 0; i < BN_NW; i++) r.w[i] = t[i];
  return fq_cond_sub(r, t[BN_NW], m);
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
