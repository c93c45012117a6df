// One Montgomery product split over a group of T consecutive lanes of a warp,
// and the fixed-exponent power on it, for kernels that give one base-field
// element to T threads (kernel_pow_fixed.cu).  The teams of the Fq12 and
// step kernels give one Fq2 product to a warp; a Fermat inversion has one
// base-field element and a chain of 330 dependent products, so here the split
// goes inside the base-field product.
//
// Words.  Lane j (0 <= j < T) of a group holds words j*W .. j*W + W - 1 of
// every value of its element (W = 8 / T: 1 at T = 8, 2 at T = 4), of the
// modulus and of the window table.  A group value is G::Lv<GWords<W>>.
//
// The product is word-2^32 CIOS, fq_mont_mul_inline's, spread over the group
// by word, its accumulator in carry-save form: each word k of a lane has two
// 32-bit carries owed to it, ca[k] from the a_i b rows and cm[k] from the
// mu m rows.  Row i (i = 0..7):
//   every lane has a_i (the eight words of a are broadcast once a product);
//   each word: x = a_i b_k + word + ca[k], whose high half is the new ca[k];
//   lane 0 takes mu = (x_0 + cm[0]) m' (position 0 with all it is owed) and
//   broadcasts it;
//   each word: y = mu m_k + x + cm[k], whose high half is the new cm[k];
//   the accumulator moves down one word: the lane's words shift down and its
//   top word takes the next lane's bottom word (lane 0's bottom word, which
//   is 0, on the group's top lane).  A carry left at word k was owed to word
//   k + 1, which the shift brings to index k: the carries stay where they are.
// Every sum is a 32 x 32-bit product plus two 32-bit words, below 2^64, so
// no carry ripples within a row and none leaves the lane: mu is the one of
// fq_mont_mul_inline and the accumulator the same integer after every row.
// After 8 rows the carries are resolved once a product, not once a row:
// each lane adds its words' carries, ripples them up its own words and
// passes the overflow of its top word (at most 3) to the lane above; a
// ballot of the lanes whose words then overflow (generate) and of those
// whose words are all ones (propagate) gives every lane its carry in by one
// addition on the group's bits (fq_group_carries).  The subtraction of m
// (t < 2m) is resolved the same way with borrows, taken for both carries in
// at once so that all the ballots are one round, and the borrow out of the
// group's top word says whether t < m.  The result is < m, so it is
// fq_mont_mul_inline's limbs, bit for bit.
//
// Exchanges.  Lanes meet only in four calls of the group object G:
// bcast(x, src), rotate_down(x), rotate_up(x) and ballot(p), between phases of
// lane-local code, g.each([&](int l) { ... }), in which lane l touches only
// its own entries x[l].  On the card G is WarpGroup<T> (below): one lane a
// thread, Lv holds one value, the exchanges are warp shuffles and ballots
// over the full warp, so every lane of the warp must call them (a kernel's
// tail lanes clamp to an element and skip the store).  On the host
// (tests/torch_csrc_host.cpp) G runs the T lanes of a group phase by phase
// over arrays of lane values that start poisoned, in lane order or reversed:
// a lane that reads a value no lane has produced yet changes the result.
//
// Plain C++ like the other headers (no PTX), so g++ builds it.
#pragma once

#include "fq.cuh"

// W words of a field element, the share of one lane of a group.
template <int W>
struct GWords {
  uint32_t w[W];
};

// Word `i` of eight, i known only at run time (a lane's index): a select
// over the eight, so that an argument struct is not copied to local memory.
BN_DEV uint32_t fq_word_at(const uint32_t* words, int i) {
  uint32_t r = 0;
#pragma unroll
  for (int k = 0; k < BN_NW; k++) r = k == i ? words[k] : r;
  return r;
}

// Base-16 digit k of e, k the same for every thread, by the same select.
BN_DEV uint32_t exp_digit_at(const Exp& e, int k) { return (fq_word_at(e.w, k >> 3) >> (4 * (k & 7))) & 15u; }

// Carry (or borrow) into each lane of a group, bit l for lane l, bit T out
// of the top lane, from `gen` (lanes whose own sum carries out) and `prop`
// (lanes that pass a carry in on), two exclusive masks of T bits.  A carry
// generated at lane k enters lane k + 1 and runs on through the propagating
// lanes above it: the bits that adding gen << 1 to prop changes.
BN_DEV uint32_t fq_group_carries(uint32_t gen, uint32_t prop) { return ((gen << 1) + prop) ^ prop; }

// Lane l's share of an element whose eight words are `words` (a kernel
// argument: the Montgomery one, the modulus).
template <class G>
BN_DEV typename G::template Lv<GWords<G::W>> fq_group_words(const G& g, const uint32_t* words) {
  typename G::template Lv<GWords<G::W>> r;
  g.each([&](int l) {
#pragma unroll
    for (int k = 0; k < G::W; k++) r[l].w[k] = fq_word_at(words, l * G::W + k);
  });
  return r;
}

// One lane's share of the CIOS accumulator in carry-save form: W words and,
// for each, the carries owed to it by the a_i b row (ca) and by the mu m row
// (cm), each below 2^32.  A carry a row leaves at word k is owed one word up;
// the row's shift brings that word down to index k, so it stays at index k.
template <int W>
struct GAcc {
  uint32_t lo[W], ca[W], cm[W];
};

// s - m over W words: the difference, its borrow out (0/1) and whether it is
// zero (a borrow in then passes on).  A lane that borrows out is not zero.
template <int W>
BN_DEV void gwords_sub(GWords<W>& d, uint32_t& borrow, uint32_t& zero, const GWords<W>& s, const uint32_t* m) {
  uint32_t br = 0, any = 0;
#pragma unroll
  for (int k = 0; k < W; k++) {
    const uint64_t x = (uint64_t)s.w[k] - m[k] - br;
    d.w[k] = (uint32_t)x;
    br = (uint32_t)(x >> 32) & 1u;
    any |= d.w[k];
  }
  borrow = br;
  zero = any == 0;
}

// The modulus as the group's product takes it: each lane's share and
// -m^-1 mod 2^32.
template <class G>
struct GroupMod {
  typename G::template Lv<GWords<G::W>> m;
  uint32_t inv;
};

template <class G>
BN_DEV GroupMod<G> fq_group_mod(const G& g, const Mod& mod) {
  return {fq_group_words(g, mod.w), mod.inv};
}

// a * b * 2^-256 mod m, a and b < m, on the group g.  Every lane of the
// group calls it.
template <class G>
BN_DEV typename G::template Lv<GWords<G::W>> fq_group_mul(const G& g, const typename G::template Lv<GWords<G::W>>& a,
                                                        const typename G::template Lv<GWords<G::W>>& b,
                                                        const GroupMod<G>& gm) {
  constexpr int T = G::LANES, W = G::W;
  using Words = typename G::template Lv<GWords<W>>;
  using U32 = typename G::template Lv<uint32_t>;
  U32 av[BN_NW];  // the words of a, in every lane
#pragma unroll
  for (int i = 0; i < BN_NW; i++) {
    U32 own;
    g.each([&](int l) { own[l] = a[l].w[i % W]; });
    av[i] = g.bcast(own, i / W);
  }
  typename G::template Lv<GAcc<W>> t;
  g.each([&](int l) {
#pragma unroll
    for (int k = 0; k < W; k++) t[l].lo[k] = t[l].ca[k] = t[l].cm[k] = 0;
  });
#pragma unroll
  for (int i = 0; i < BN_NW; i++) {
    Words x;  // the a_i b row: low words; its carries go to ca
    U32 own_mu;
    g.each([&](int l) {
#pragma unroll
      for (int k = 0; k < W; k++) {
        const uint64_t r = (uint64_t)av[i][l] * b[l].w[k] + t[l].lo[k] + t[l].ca[k];  // < 2^64
        x[l].w[k] = (uint32_t)r;
        t[l].ca[k] = (uint32_t)(r >> 32);
      }
      own_mu[l] = (x[l].w[0] + t[l].cm[0]) * gm.inv;  // lane 0's: position 0 with all it is owed
    });
    const U32 mu = g.bcast(own_mu, 0);
    U32 bottom;
    g.each([&](int l) {
#pragma unroll
      for (int k = 0; k < W; k++) {
        const uint64_t r = (uint64_t)mu[l] * gm.m[l].w[k] + x[l].w[k] + t[l].cm[k];
        x[l].w[k] = (uint32_t)r;
        t[l].cm[k] = (uint32_t)(r >> 32);
      }
      bottom[l] = x[l].w[0];  // 0 on lane 0: it leaves
    });
    const U32 from_above = g.rotate_down(bottom);  // the top lane gets lane 0's 0
    g.each([&](int l) {
#pragma unroll
      for (int k = 0; k < W - 1; k++) t[l].lo[k] = x[l].w[k + 1];
      t[l].lo[W - 1] = from_above[l];
    });
  }
  // t < 2m < 2^255 in carry-save form: each word with its two carries, the
  // lane's top overflow (<= 3; 0 on the top lane, as t < 2^255) to the lane
  // above, then one carry in a lane by the ballots.
  Words s;
  U32 over;
  g.each([&](int l) {
    uint64_t r = 0;
#pragma unroll
    for (int k = 0; k < W; k++) {
      r += (uint64_t)t[l].lo[k] + t[l].ca[k] + t[l].cm[k];
      s[l].w[k] = (uint32_t)r;
      r >>= 32;
    }
    over[l] = (uint32_t)r;
  });
  const U32 from_below = g.rotate_up(over);
  U32 gen, prop;
  g.each([&](int l) {
    uint64_t r = from_below[l];
    uint32_t ones = ~0u;
#pragma unroll
    for (int k = 0; k < W; k++) {
      r += s[l].w[k];
      s[l].w[k] = (uint32_t)r;
      r >>= 32;
      ones &= s[l].w[k];
    }
    gen[l] = (uint32_t)r;  // 0 or 1; a lane that carries out is not all ones
    prop[l] = ones == ~0u;
  });
  // s - m for both carries in, 0 and 1, so that the borrows' ballots need
  // not wait for the carries'.
  Words s1, d, d1;
  U32 gen0, prop0, gen1, prop1;
  g.each([&](int l) {
    uint32_t r = 1;
#pragma unroll
    for (int k = 0; k < W; k++) {
      const uint64_t x = (uint64_t)s[l].w[k] + r;
      s1[l].w[k] = (uint32_t)x;
      r = (uint32_t)(x >> 32);
    }
    gwords_sub(d[l], gen0[l], prop0[l], s[l], gm.m[l].w);
    gwords_sub(d1[l], gen1[l], prop1[l], s1[l], gm.m[l].w);
  });
  const uint32_t carries = fq_group_carries(g.ballot(gen), g.ballot(prop));
  const uint32_t borrows = fq_group_carries((g.ballot(gen1) & carries) | (g.ballot(gen0) & ~carries),
                                            (g.ballot(prop1) & carries) | (g.ballot(prop0) & ~carries));
  const bool below_m = (borrows >> T) & 1u;  // t - m < 0: keep t
  Words r;
  g.each([&](int l) {
    const bool cin = (carries >> l) & 1u;
    uint32_t br = (borrows >> l) & 1u;
#pragma unroll
    for (int k = 0; k < W; k++) {
      const uint64_t x = (uint64_t)(cin ? d1[l].w[k] : d[l].w[k]) - br;
      r[l].w[k] = below_m ? (cin ? s1[l].w[k] : s[l].w[k]) : (uint32_t)x;
      br = (uint32_t)(x >> 32) & 1u;
    }
  });
  return r;
}

// The window table of one element: lane l's word k of entry e at
// tab[l][(e * W + k) * stride].  A kernel passes shared memory offset by the
// thread's index with stride = block size (neighbouring threads on
// neighbouring banks); the host a plain array.
template <class G>
BN_DEV void fq_group_tab_store(const G& g, const typename G::template Lv<uint32_t*>& tab, int stride, int e,
                               const typename G::template Lv<GWords<G::W>>& v) {
  g.each([&](int l) {
#pragma unroll
    for (int k = 0; k < G::W; k++) tab[l][(e * G::W + k) * stride] = v[l].w[k];
  });
}

template <class G>
BN_DEV typename G::template Lv<GWords<G::W>> fq_group_tab_load(const G& g, const typename G::template Lv<uint32_t*>& tab,
                                                             int stride, int e) {
  typename G::template Lv<GWords<G::W>> r;
  g.each([&](int l) {
#pragma unroll
    for (int k = 0; k < G::W; k++) r[l].w[k] = tab[l][(e * G::W + k) * stride];
  });
  return r;
}

// a^e in the Montgomery domain on the group: fq_pow_fixed's window-4 ladder
// (the table a^0..a^15 from `one` = R mod m, then four squarings and one
// product with table[digit] a further digit), so 0^e = 0 and the order of
// products is fields/fp.py's.  A digit is the same for every thread, so the
// table entry of the next product is read before its four squarings.
template <class G>
BN_DEV typename G::template Lv<GWords<G::W>> fq_group_pow(const G& g, const typename G::template Lv<GWords<G::W>>& a,
                                                        const typename G::template Lv<GWords<G::W>>& one,
                                                        const Exp& e, const typename G::template Lv<uint32_t*>& tab,
                                                        int stride, const GroupMod<G>& gm) {
  typename G::template Lv<GWords<G::W>> t = one;
  fq_group_tab_store(g, tab, stride, 0, t);
#pragma unroll 1
  for (int k = 1; k < 16; k++) {
    t = fq_group_mul(g, t, a, gm);
    fq_group_tab_store(g, tab, stride, k, t);
  }
  typename G::template Lv<GWords<G::W>> res = fq_group_tab_load(g, tab, stride, exp_digit_at(e, e.nd - 1));
#pragma unroll 1
  for (int k = e.nd - 2; k >= 0; k--) {
    const typename G::template Lv<GWords<G::W>> entry = fq_group_tab_load(g, tab, stride, exp_digit_at(e, k));
#pragma unroll 1
    for (int s = 0; s < 4; s++) res = fq_group_mul(g, res, res, gm);
    res = fq_group_mul(g, res, entry, gm);
  }
  return res;
}

#ifdef __CUDACC__
// The card's group: T consecutive lanes of a warp (T divides 32), one lane a
// thread.  Lv holds the thread's own value; the exchanges are shuffles of
// width T and ballots over the full warp, read back as the group's T bits.
template <int T>
struct WarpGroup {
  static constexpr int LANES = T, W = BN_NW / T;
  template <class V>
  struct Lv {
    V v;
    __device__ __forceinline__ V& operator[](int) { return v; }
    __device__ __forceinline__ const V& operator[](int) const { return v; }
  };
  int lane;        // the thread's lane in its group
  unsigned first;  // the ballot bit of the group's lane 0
  __device__ __forceinline__ WarpGroup() : lane(threadIdx.x % T), first(threadIdx.x % 32 / T * T) {}
  template <class F>
  __device__ __forceinline__ void each(F f) const {
    f(lane);
  }
  __device__ __forceinline__ Lv<uint32_t> bcast(const Lv<uint32_t>& x, int src) const {
    return {__shfl_sync(0xFFFFFFFFu, x.v, src, T)};
  }
  __device__ __forceinline__ Lv<uint32_t> rotate_down(const Lv<uint32_t>& x) const {
    return {__shfl_sync(0xFFFFFFFFu, x.v, lane + 1, T)};  // lane T - 1 reads lane 0
  }
  __device__ __forceinline__ Lv<uint32_t> rotate_up(const Lv<uint32_t>& x) const {
    return {__shfl_sync(0xFFFFFFFFu, x.v, lane + T - 1, T)};  // lane 0 reads lane T - 1
  }
  __device__ __forceinline__ uint32_t ballot(const Lv<uint32_t>& p) const {
    return (__ballot_sync(0xFFFFFFFFu, p.v != 0) >> first) & ((1u << T) - 1);
  }
};
#endif
