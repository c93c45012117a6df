// Host-side codec of bn_tpu_torch: batched canonical-bytes <-> Montgomery limb
// conversion with full validation, plus the 512/256 division of the Fq2 wire
// format.  The port's own copy of the JAX package's csrc/bn_host.cpp, bound
// with ctypes by bn_tpu_torch/utils/native.py and built with g++ by
// bn_tpu_torch/ops/build.py.  No device code: wire I/O is a host boundary
// (src/arith.rs:90-159 interpret/encode, src/fields/fp.rs:15-74 Montgomery
// boundary in the reference crate), and multi-megabyte batches must not crawl
// through Python ints.
//
// Layout contracts:
//   bytes:  32-byte big-endian canonical integers (64-byte for U512/Fq2)
//   limbs:  uint32[16] little-endian 16-bit limbs, Montgomery form (R = 2^256)
//
// All arithmetic is 4x64-bit with unsigned __int128 products; CIOS Montgomery
// multiply (HAC 14.32), identical in math to the reference's mul_reduce
// (src/arith.rs:481-503).  tests/test_torch_api.py holds every entry against
// the pure-Python codec of serialization.py and the constants of params.py.

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;

namespace {

struct U256 {
  uint64_t w[4];
};

inline bool geq(const U256 &a, const U256 &b) {
  for (int i = 3; i >= 0; --i) {
    if (a.w[i] < b.w[i]) return false;
    if (a.w[i] > b.w[i]) return true;
  }
  return true;
}

inline void sub(U256 &a, const U256 &b) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.w[i] - b.w[i] - borrow;
    a.w[i] = (uint64_t)d;
    borrow = (d >> 64) & 1;
  }
}

// CIOS Montgomery multiply: a <- a*b*R^-1 mod m
inline void mont_mul(U256 &a, const U256 &b, const U256 &m, uint64_t inv) {
  uint64_t t[8] = {0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)a.w[i] * b.w[j] + t[i + j] + carry;
      t[i + j] = (uint64_t)s;
      carry = s >> 64;
    }
    t[i + 4] += (uint64_t)carry;
  }
  for (int i = 0; i < 4; ++i) {
    uint64_t k = t[i] * inv;
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)k * m.w[j] + t[i + j] + carry;
      t[i + j] = (uint64_t)s;
      carry = s >> 64;
    }
    for (int j = i + 4; j < 8 && carry; ++j) {
      u128 s = (u128)t[j] + carry;
      t[j] = (uint64_t)s;
      carry = s >> 64;
    }
  }
  U256 r;
  std::memcpy(r.w, t + 4, sizeof(r.w));
  if (geq(r, m)) sub(r, m);
  a = r;
}

inline void be_bytes_to_u256(const uint8_t *buf, U256 &out) {
  for (int i = 0; i < 4; ++i) {
    uint64_t v = 0;
    const uint8_t *p = buf + (3 - i) * 8;
    for (int j = 0; j < 8; ++j) v = (v << 8) | p[j];
    out.w[i] = v;
  }
}

inline void u256_to_be_bytes(const U256 &a, uint8_t *buf) {
  for (int i = 0; i < 4; ++i) {
    uint64_t v = a.w[i];
    uint8_t *p = buf + (3 - i) * 8;
    for (int j = 7; j >= 0; --j) {
      p[j] = (uint8_t)v;
      v >>= 8;
    }
  }
}

inline void u256_to_limbs16(const U256 &a, uint32_t *out) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      out[i * 4 + j] = (uint32_t)((a.w[i] >> (16 * j)) & 0xffff);
}

inline void limbs16_to_u256(const uint32_t *in, U256 &a) {
  for (int i = 0; i < 4; ++i) {
    uint64_t v = 0;
    for (int j = 3; j >= 0; --j) v = (v << 16) | (in[i * 4 + j] & 0xffff);
    a.w[i] = v;
  }
}

// 512/256 binary long division (cf. U512::divrem, src/arith.rs:65-88):
// returns quotient (may exceed 256 bits -> reported via ok flag) + remainder.
inline void divrem_512(const uint8_t *be64, const U256 &m, U256 &q_out,
                       U256 &r_out, bool &q_fits) {
  U256 r = {{0, 0, 0, 0}};
  uint64_t q[8] = {0};
  for (int bit = 511; bit >= 0; --bit) {
    // r <<= 1
    uint64_t carry = 0;
    for (int i = 0; i < 4; ++i) {
      uint64_t nc = r.w[i] >> 63;
      r.w[i] = (r.w[i] << 1) | carry;
      carry = nc;
    }
    int byte_idx = 63 - bit / 8;
    int bit_in = bit % 8;
    r.w[0] |= (be64[byte_idx] >> bit_in) & 1;
    if (geq(r, m)) {
      sub(r, m);
      q[bit / 64] |= (uint64_t)1 << (bit % 64);
    }
  }
  q_fits = (q[4] | q[5] | q[6] | q[7]) == 0;
  std::memcpy(q_out.w, q, sizeof(q_out.w));
  r_out = r;
}

struct FieldCtx {
  U256 m;
  U256 r2;
  uint64_t inv;
};

FieldCtx fq_ctx() {
  return {{{0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL, 0xb85045b68181585dULL,
            0x30644e72e131a029ULL}},
          {{0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL, 0x47ab1eff0a417ff6ULL,
            0x06d89f71cab8351fULL}},
          0x87d20782e4866389ULL};
}

FieldCtx fr_ctx() {
  return {{{0x43e1f593f0000001ULL, 0x2833e84879b97091ULL, 0xb85045b68181585dULL,
            0x30644e72e131a029ULL}},
          {{0x1bb8e645ae216da7ULL, 0x53fe3ab1e35c59e3ULL, 0x8c49833d53bb8085ULL,
            0x0216d0b17f4e44a5ULL}},
          0xc2e1f593efffffffULL};
}

inline FieldCtx ctx_for(int field) { return field == 0 ? fq_ctx() : fr_ctx(); }

}  // namespace

extern "C" {

// Decode n 32-byte big-endian canonical values into Montgomery uint32[16]
// limb rows.  Returns -1 on success or the index of the first out-of-range
// value.  field: 0 = Fq, 1 = Fr.
long bn_fp_decode_batch(const uint8_t *bufs, long n, int field,
                        uint32_t *out_limbs) {
  FieldCtx c = ctx_for(field);
  for (long i = 0; i < n; ++i) {
    U256 a;
    be_bytes_to_u256(bufs + 32 * i, a);
    if (geq(a, c.m)) return i;
    mont_mul(a, c.r2, c.m, c.inv);  // to Montgomery form
    u256_to_limbs16(a, out_limbs + 16 * i);
  }
  return -1;
}

// Encode n Montgomery uint32[16] limb rows into 32-byte big-endian canonical
// values (converts out of Montgomery form by multiplying with literal 1,
// cf. From<Fp> for U256, src/fields/fp.rs:15-22).
void bn_fp_encode_batch(const uint32_t *limbs, long n, int field,
                        uint8_t *out_bufs) {
  FieldCtx c = ctx_for(field);
  U256 one = {{1, 0, 0, 0}};
  for (long i = 0; i < n; ++i) {
    U256 a;
    limbs16_to_u256(limbs + 16 * i, a);
    mont_mul(a, one, c.m, c.inv);
    u256_to_be_bytes(a, out_bufs + 32 * i);
  }
}

// Decode n 64-byte big-endian U512 values as Fq2 = (c0, c1) with value
// c1*q + c0 (reference: src/fields/fq2.rs:40-53).  Output rows are
// uint32[32]: c0 limbs then c1 limbs, Montgomery form.  Returns -1 or the
// index of the first value >= q^2.
long bn_fq2_decode_batch(const uint8_t *bufs, long n, uint32_t *out_limbs) {
  FieldCtx c = fq_ctx();
  for (long i = 0; i < n; ++i) {
    U256 q_, r_;
    bool fits;
    divrem_512(bufs + 64 * i, c.m, q_, r_, fits);
    if (!fits || geq(q_, c.m)) return i;  // c1 must be < q
    mont_mul(r_, c.r2, c.m, c.inv);
    mont_mul(q_, c.r2, c.m, c.inv);
    u256_to_limbs16(r_, out_limbs + 32 * i);       // c0
    u256_to_limbs16(q_, out_limbs + 32 * i + 16);  // c1
  }
  return -1;
}

// Encode n Fq2 limb rows (uint32[32]: c0 then c1, Montgomery) into 64-byte
// big-endian U512 values c1*q + c0.
void bn_fq2_encode_batch(const uint32_t *limbs, long n, uint8_t *out_bufs) {
  FieldCtx c = fq_ctx();
  U256 one = {{1, 0, 0, 0}};
  for (long i = 0; i < n; ++i) {
    U256 c0, c1;
    limbs16_to_u256(limbs + 32 * i, c0);
    limbs16_to_u256(limbs + 32 * i + 16, c1);
    mont_mul(c0, one, c.m, c.inv);
    mont_mul(c1, one, c.m, c.inv);
    // 512-bit value = c1 * q + c0, big-endian
    uint64_t acc[8] = {0};
    for (int a = 0; a < 4; ++a) {
      u128 carry = 0;
      for (int b = 0; b < 4; ++b) {
        u128 s = (u128)c1.w[a] * c.m.w[b] + acc[a + b] + carry;
        acc[a + b] = (uint64_t)s;
        carry = s >> 64;
      }
      acc[a + 4] += (uint64_t)carry;
    }
    u128 carry = 0;
    for (int a = 0; a < 8; ++a) {
      u128 s = (u128)acc[a] + (a < 4 ? c0.w[a] : 0) + carry;
      acc[a] = (uint64_t)s;
      carry = s >> 64;
    }
    uint8_t *p = out_bufs + 64 * i;
    for (int a = 0; a < 8; ++a) {
      uint64_t v = acc[7 - a];
      for (int j = 0; j < 8; ++j) {
        p[a * 8 + j] = (uint8_t)(v >> (56 - 8 * j));
      }
    }
  }
}

// Batch 64-byte big-endian -> mod-m reduction into Montgomery limbs
// (the interpret() primitive, reference: src/fields/fp.rs:72-74).
void bn_fp_interpret_batch(const uint8_t *bufs, long n, int field,
                           uint32_t *out_limbs) {
  FieldCtx c = ctx_for(field);
  for (long i = 0; i < n; ++i) {
    U256 q_, r_;
    bool fits;
    divrem_512(bufs + 64 * i, c.m, q_, r_, fits);
    mont_mul(r_, c.r2, c.m, c.inv);
    u256_to_limbs16(r_, out_limbs + 16 * i);
  }
  return;
}

int bn_host_abi_version() { return 1; }
}
