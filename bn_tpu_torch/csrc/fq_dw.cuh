// Double-width arithmetic for lazy reduction: a product of two base-field
// values is kept whole, 16 words, sums and differences of such products are
// taken on the whole values, and one Montgomery reduction (REDC) brings a
// sum back to a field element.  A tower formula that adds many products
// before it next multiplies pays one reduction per output coefficient in
// place of one per product (Aranha, Karabina, Longa, Gebotys, Lopez,
// EUROCRYPT 2011; the TPU kernel's bn_tpu/ops/dw.py).  fq12_mul_team.cuh is
// its user.
//
// The values, all unsigned words, little endian:
//   a product  dw_mul(a, b) = a b, 16 words, for a, b < 2^256;
//   a sum      17 words, taken modulo 2^544 (its terms may be negative:
//              the caller adds a multiple of q^2 that makes the true sum
//              non-negative, so the final 17 words are exact);
//   dw_redc    (t + mu q) / 2^256, t < 2^515, 9 words below 2^259;
//   dw_canonical  that value mod q, one estimated quotient and one
//              conditional subtraction.
// The ranges are not trusted: the constexpr integers at the end of this
// header recompute them from q, and a sum whose worst case leaves them fails
// the build (fq12_mul_team.cuh's static_asserts).
//
// Plain C++ like the other headers, so the host tests run the same chains.
#pragma once

#include "fq.cuh"

#define BN_DW 16         // words of a product of two values below 2^256
#define BN_DW_ACC 17     // words of a sum of products
#define BN_DW_SUM_BITS 515   // a sum handed to dw_redc is below 2^515 ...
#define BN_DW_REDC_BITS 259  // ... so its reduction is below 2^259 (t / 2^256 + q)
// dw_canonical's quotient estimate: the 32 bits of r at 227..258 times
// BN_DW_EST_SHIFT + 32 bits of 1 / (q >> 227)
#define BN_DW_EST_LOW (BN_DW_REDC_BITS - 32)
#define BN_DW_EST_SHIFT 26

// A double-width value in a team's shared memory: entry k's word j at
// tab[(k * 16 + j) * stride], laid out as fq_tab_store's.
BN_DEV void dw_tab_store(uint32_t* tab, int stride, int k, const uint32_t* v) {
#pragma unroll
  for (int j = 0; j < BN_DW; j++) tab[(k * BN_DW + j) * stride] = v[j];
}

// One row of a product: w += the words of a of parity p (0: even, 1: odd)
// times b, a_j b at words j - p, j - p + 1 of the window w; the chain's
// carry out into w[8].  The products of one parity land on disjoint word
// pairs, so a row is one chain of 8 multiply-adds (fq.cuh's two arrays).
BN_DEV void dw_mul_row(uint32_t* w, const uint32_t* a, uint32_t b, int p) {
  Carry c;
  w[0] = mad_lo_cc(c, a[p], b, w[0]);
  w[1] = madc_hi_cc(c, a[p], b, w[1]);
#pragma unroll
  for (int j = p + 2; j < BN_NW; j += 2) {
    w[j - p] = madc_lo_cc(c, a[j], b, w[j - p]);
    w[j - p + 1] = madc_hi_cc(c, a[j], b, w[j - p + 1]);
  }
  w[BN_NW] = addc(c, w[BN_NW], 0u);
}

// r = a b, 16 words, no reduction.  The row of b_i adds its even products
// at words i.., its odd ones at i + 1..; the two arrays x and y hold the
// word pairs that start at even and at odd words, so every row's two chains
// go one into each, and a chain's carry lands in the word above its window,
// which holds at most an earlier carry (no carry runs on).  r = x + y.
BN_DEV void dw_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t x[BN_DW + 1] = {}, y[BN_DW + 1] = {};
#pragma unroll
  for (int i = 0; i < BN_NW; i++) {
    dw_mul_row((i & 1 ? y : x) + i, a, b[i], 0);
    dw_mul_row((i & 1 ? x : y) + i + 1, a, b[i], 1);
  }
  Carry c;
  r[0] = x[0];
  r[1] = add_cc(c, x[1], y[1]);
#pragma unroll
  for (int j = 2; j < BN_DW - 1; j++) r[j] = addc_cc(c, x[j], y[j]);
  r[BN_DW - 1] = addc(c, x[BN_DW - 1], y[BN_DW - 1]);  // a b < 2^512: nothing carries out
}

// r = a + b and r = a - b on 16 words, the carry or borrow out dropped: the
// callers' values stay inside 16 words (their bounds in fq12_mul_team.cuh).
BN_DEV void dw_add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  Carry c;
  r[0] = add_cc(c, a[0], b[0]);
#pragma unroll
  for (int j = 1; j < BN_DW - 1; j++) r[j] = addc_cc(c, a[j], b[j]);
  r[BN_DW - 1] = addc(c, a[BN_DW - 1], b[BN_DW - 1]);
}

BN_DEV void dw_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  Carry c;
  r[0] = sub_cc(c, a[0], b[0]);
#pragma unroll
  for (int j = 1; j < BN_DW - 1; j++) r[j] = subc_cc(c, a[j], b[j]);
  r[BN_DW - 1] = subc(c, a[BN_DW - 1], b[BN_DW - 1]);
}

// r = (t + mu m) / 2^256, 9 words, for the mu < 2^256 that clears t's low
// eight words: word-by-word REDC (HAC 14.32), one mu a word.  Row i adds
// mu_i m at word i as two chains, the even words of m (words i..i+7) and
// the odd ones (i+1..i+8); their carries out land at words i+8 and i+9,
// which no later mu reads, so they gather in c and join the high half at
// the end.  r < t / 2^256 + m, so t < 2^515 gives r < 2^259.  t is consumed.
BN_DEV void dw_redc(uint32_t* r, uint32_t* t, const Mod& m) {
  uint32_t c[BN_DW_ACC] = {};
#pragma unroll
  for (int i = 0; i < BN_NW; i++) {
    const uint32_t mu = t[i] * m.inv;
    Carry e;
    t[i] = mad_lo_cc(e, m.w[0], mu, t[i]);
    t[i + 1] = madc_hi_cc(e, m.w[0], mu, t[i + 1]);
#pragma unroll
    for (int j = 2; j < BN_NW; j += 2) {
      t[i + j] = madc_lo_cc(e, m.w[j], mu, t[i + j]);
      t[i + j + 1] = madc_hi_cc(e, m.w[j], mu, t[i + j + 1]);
    }
    c[i + BN_NW] = addc(e, c[i + BN_NW], 0u);
    Carry o;
    t[i + 1] = mad_lo_cc(o, m.w[1], mu, t[i + 1]);
    t[i + 2] = madc_hi_cc(o, m.w[1], mu, t[i + 2]);
#pragma unroll
    for (int j = 3; j < BN_NW; j += 2) {
      t[i + j] = madc_lo_cc(o, m.w[j], mu, t[i + j]);
      t[i + j + 1] = madc_hi_cc(o, m.w[j], mu, t[i + j + 1]);
    }
    c[i + BN_NW + 1] = addc(o, c[i + BN_NW + 1], 0u);
  }
  Carry f;
  r[0] = add_cc(f, t[BN_NW], c[BN_NW]);
#pragma unroll
  for (int j = 1; j < BN_NW; j++) r[j] = addc_cc(f, t[BN_NW + j], c[BN_NW + j]);
  r[BN_NW] = addc(f, t[BN_DW], c[BN_DW]);
}

// r mod m for r < 2^259 (9 words): k = the 32 bits of r from bit 227 times
// est, shifted down, is floor(r / m) or one less (est = floor(2^58 /
// ((m >> 227) + 1)), checked with m = q at the end of this header), so
// r - k m < 2 m, computed on eight words, and one conditional subtraction.
BN_DEV Fq dw_canonical(const uint32_t* r, uint32_t est, const Mod& m) {
  const uint32_t top = (r[BN_NW] << (32 - BN_DW_EST_LOW % 32)) | (r[BN_NW - 1] >> (BN_DW_EST_LOW % 32));
  const uint32_t k = mul_hi(top, est) >> BN_DW_EST_SHIFT;
  uint32_t km[BN_NW];
#pragma unroll
  for (int j = 0; j < BN_NW; j++) km[j] = m.w[j] * k;
  Carry c;
  km[1] = mad_hi_cc(c, m.w[0], k, km[1]);
#pragma unroll
  for (int j = 2; j < BN_NW - 1; j++) km[j] = madc_hi_cc(c, m.w[j - 1], k, km[j]);
  km[BN_NW - 1] = madc_hi(c, m.w[BN_NW - 2], k, km[BN_NW - 1]);
  Carry d;
  Fq s;
  fq_sub_chain(d, s.w, r, km);
  return fq_cond_sub(s, 0u, m);
}

// ---- the bounds, as constexpr integers -------------------------------------

// A non-negative integer below 2^576 for the compile-time checks.
struct DwInt {
  uint32_t w[18];
};

BN_CONSTEXPR DwInt dw_int(uint64_t v) {
  DwInt r{};
  r.w[0] = (uint32_t)v;
  r.w[1] = (uint32_t)(v >> 32);
  return r;
}

BN_CONSTEXPR DwInt dw_int_pow2(int n) {
  DwInt r{};
  r.w[n / 32] = 1u << (n % 32);
  return r;
}

BN_CONSTEXPR DwInt dw_int_add(const DwInt& a, const DwInt& b) {
  DwInt r{};
  uint64_t c = 0;
  for (int i = 0; i < 18; i++) {
    c += (uint64_t)a.w[i] + b.w[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return r;
}

// a - b for b <= a
BN_CONSTEXPR DwInt dw_int_sub(const DwInt& a, const DwInt& b) {
  DwInt r{};
  int64_t c = 0;
  for (int i = 0; i < 18; i++) {
    c += (int64_t)a.w[i] - b.w[i];
    r.w[i] = (uint32_t)c;
    c = c < 0 ? -1 : 0;
  }
  return r;
}

BN_CONSTEXPR DwInt dw_int_mul(const DwInt& a, const DwInt& b) {
  DwInt r{};
  for (int i = 0; i < 18; i++) {
    uint64_t c = 0;
    for (int j = 0; i + j < 18; j++) {
      c += (uint64_t)a.w[i] * b.w[j] + r.w[i + j];
      r.w[i + j] = (uint32_t)c;
      c >>= 32;
    }
  }
  return r;
}

BN_CONSTEXPR DwInt dw_int_mul_small(const DwInt& a, uint32_t k) {
  DwInt r{};
  uint64_t c = 0;
  for (int i = 0; i < 18; i++) {
    c += (uint64_t)a.w[i] * k;
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return r;
}

BN_CONSTEXPR bool dw_int_less(const DwInt& a, const DwInt& b) {
  for (int i = 17; i >= 0; i--)
    if (a.w[i] != b.w[i]) return a.w[i] < b.w[i];
  return false;
}

BN_CONSTEXPR DwInt dw_int_shr(const DwInt& a, int n) {
  DwInt r{};
  for (int i = 0; i < 18; i++) {
    const int s = i + n / 32;
    const uint64_t lo = s < 18 ? a.w[s] : 0, hi = s + 1 < 18 ? a.w[s + 1] : 0;
    r.w[i] = (uint32_t)(((hi << 32) | lo) >> (n % 32));
  }
  return r;
}

// BN254's base-field modulus q, the modulus of every lazily reduced product.
BN_CONSTEXPR DwInt dw_q() {
  DwInt q{};
  const uint32_t w[BN_NW] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                             0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
  for (int i = 0; i < BN_NW; i++) q.w[i] = w[i];
  return q;
}

// -q^-1 mod 2^32 (Newton's iteration doubles the correct low bits).
BN_CONSTEXPR uint32_t dw_q_inv() {
  const uint32_t q0 = dw_q().w[0];
  uint32_t x = 1;
  for (int i = 0; i < 5; i++) x *= 2u - q0 * x;
  return 0u - x;
}

// dw_canonical's multiplier for q, floor(2^58 / ((q >> 227) + 1)), and
// that multiplier as a word (dw_estimate_holds checks that it is one).
BN_CONSTEXPR uint64_t dw_est_wide() {
  return ((uint64_t)1 << (32 + BN_DW_EST_SHIFT)) / ((uint64_t)dw_int_shr(dw_q(), BN_DW_EST_LOW).w[0] + 1);
}

BN_CONSTEXPR uint32_t dw_est() { return (uint32_t)dw_est_wide(); }

// Whether dw_canonical's estimate is floor(r / q) or one less for every
// r < 2^259.  With t = r >> 227, qt = q >> 227, est = floor(2^58 / (qt + 1)):
// k = floor(t est / 2^58) <= t / (qt + 1) <= r / q, and
// r / q - k < (t + 1) / qt - t / (qt + 1) + t / 2^58 + 1
//           = (t + qt + 1) / (qt (qt + 1)) + t / 2^58 + 1,
// which is below 2 when (2^32 + qt + 1) 2^58 + 2^32 qt (qt + 1) < qt (qt + 1) 2^58.
BN_CONSTEXPR bool dw_estimate_holds() {
  const DwInt qt = dw_int_shr(dw_q(), BN_DW_EST_LOW);
  const DwInt qq = dw_int_mul(qt, dw_int_add(qt, dw_int(1)));
  const DwInt lhs = dw_int_add(dw_int_mul(dw_int_add(dw_int_pow2(32), dw_int_add(qt, dw_int(1))),
                                          dw_int_pow2(32 + BN_DW_EST_SHIFT)),
                               dw_int_mul(dw_int_pow2(32), qq));
  return dw_int_less(lhs, dw_int_mul(qq, dw_int_pow2(32 + BN_DW_EST_SHIFT))) &&
         dw_est_wide() < ((uint64_t)1 << 32) && dw_int_shr(dw_q(), BN_DW_EST_LOW).w[1] == 0 &&
         dw_int_less(dw_int_mul(dw_q(), dw_int(2)), dw_int_pow2(256));
}

// The largest sum dw_redc may take: (t + (2^256 - 1) q) / 2^256 < 2^259.
BN_CONSTEXPR bool dw_redc_fits(const DwInt& t_max) {
  const DwInt r = dw_int_add(t_max, dw_int_mul(dw_int_sub(dw_int_pow2(256), dw_int(1)), dw_q()));
  return dw_int_less(t_max, dw_int_pow2(BN_DW_SUM_BITS)) &&
         dw_int_less(r, dw_int_pow2(256 + BN_DW_REDC_BITS));
}

static_assert(dw_q_inv() * dw_q().w[0] == 0xffffffffu, "-q^-1 mod 2^32");
static_assert(dw_estimate_holds(), "dw_canonical's quotient estimate is off by more than one");
static_assert(BN_DW_EST_LOW % 32 != 0 && BN_DW_EST_LOW / 32 == BN_NW - 1, "the estimate's bits straddle words 7 and 8");
