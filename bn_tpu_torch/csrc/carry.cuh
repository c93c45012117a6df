// Carry-chain primitives on 32-bit words: the instructions the field
// arithmetic of fq.cuh is written in.
//
// On the card each primitive is one PTX instruction that writes or reads the
// carry flag of the condition code:
//   add_cc  add.cc.u32    a + b, carry out          sub_cc  sub.cc.u32    a - b, borrow out
//   addc_cc addc.cc.u32   a + b + cf, carry out     subc_cc subc.cc.u32   a - b - cf, borrow out
//   addc    addc.u32      a + b + cf                subc    subc.u32      a - b - cf
//   mad_lo_cc  mad.lo.cc.u32   lo(a b) + c, carry out
//   madc_lo_cc madc.lo.cc.u32  lo(a b) + c + cf, carry out
//   mad_hi_cc  mad.hi.cc.u32   hi(a b) + c, carry out
//   madc_hi_cc madc.hi.cc.u32  hi(a b) + c + cf, carry out
//   madc_hi    madc.hi.u32     hi(a b) + c + cf
// For the subtractions the flag is a borrow (1 when the result wrapped).  An
// instruction without .cc leaves the flag as it was.  Where __CUDA_ARCH__ is
// undefined (g++, and nvcc's host pass) each is plain C++ on an explicit flag,
// Carry::cf, with the same semantics: its twin, which
// tests/test_torch_csrc_host.py holds against Python's integers.
//
// A chain is written once, as calls on one Carry object:
//   Carry c;
//   r0 = add_cc(c, a0, b0);
//   r1 = addc_cc(c, a1, b1);  ...
// On the card Carry is empty and the flag is the hardware's; on the host it
// is the field cf.  So the g++ build runs the very chains the card runs, and
// chip_smoke.py's edge pairs (carries and borrows through whole words, for
// both moduli) hold the two equal on the card.
//
// Why a chain may be split over one asm statement per instruction with nvcc
// (the PTX ISA does not promise that the flag survives between statements):
//  - every primitive is `asm volatile`, so NVVM keeps the statements of a
//    chain in program order, never drops or merges one, and emits them in
//    that order into the PTX;
//  - NVVM writes the flag itself only when it lowers integer arithmetic wider
//    than 64 bits, which these headers do not use, so whatever it schedules
//    between two statements of a chain leaves the flag alone;
//  - ptxas reads the flag as a register of the PTX program (it becomes a
//    predicate register in SASS) and keeps its dependencies when it schedules;
//  - no chain spans a call or a branch: each is straight-line code inside
//    inlined functions, and the out-of-line product (fq_mont_mul_call) holds
//    its chains whole.
// NVIDIA's CGBN library writes its multiple-precision arithmetic the same way.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define BN_DEV __device__ __forceinline__
// The Montgomery product is the one function kept out of line in the tower
// kernels (see tower.cuh): an Fq12 product inlines 54 of them otherwise.
#define BN_DEV_NOINLINE __device__ __noinline__
// What the C entries' host code shares with the kernels.
#define BN_CONSTEXPR __host__ __device__ constexpr
#else
#define BN_DEV inline
#define BN_DEV_NOINLINE inline
#define BN_CONSTEXPR constexpr
#endif

#ifdef __CUDA_ARCH__

struct Carry {};

#define BN_CC2(name, op)                                                  \
  BN_DEV uint32_t name(Carry&, uint32_t a, uint32_t b) {                   \
    uint32_t d;                                                            \
    asm volatile(op " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));            \
    return d;                                                              \
  }
#define BN_CC3(name, op)                                                  \
  BN_DEV uint32_t name(Carry&, uint32_t a, uint32_t b, uint32_t c) {       \
    uint32_t d;                                                            \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c)); \
    return d;                                                              \
  }
BN_CC2(add_cc, "add.cc.u32")
BN_CC2(addc_cc, "addc.cc.u32")
BN_CC2(addc, "addc.u32")
BN_CC2(sub_cc, "sub.cc.u32")
BN_CC2(subc_cc, "subc.cc.u32")
BN_CC2(subc, "subc.u32")
BN_CC3(mad_lo_cc, "mad.lo.cc.u32")
BN_CC3(madc_lo_cc, "madc.lo.cc.u32")
BN_CC3(mad_hi_cc, "mad.hi.cc.u32")
BN_CC3(madc_hi_cc, "madc.hi.cc.u32")
BN_CC3(madc_hi, "madc.hi.u32")
#undef BN_CC2
#undef BN_CC3

// The high word of a b; no flag.
BN_DEV uint32_t mul_hi(uint32_t a, uint32_t b) { return __umulhi(a, b); }

#else  // the host's twins

struct Carry {
  uint32_t cf = 0;
};

BN_DEV uint32_t mul_hi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }

BN_DEV uint32_t add_cc(Carry& c, uint32_t a, uint32_t b) {
  const uint64_t s = (uint64_t)a + b;
  c.cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
BN_DEV uint32_t addc_cc(Carry& c, uint32_t a, uint32_t b) {
  const uint64_t s = (uint64_t)a + b + c.cf;
  c.cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
BN_DEV uint32_t addc(Carry& c, uint32_t a, uint32_t b) { return a + b + c.cf; }
BN_DEV uint32_t sub_cc(Carry& c, uint32_t a, uint32_t b) {
  c.cf = a < b;
  return a - b;
}
BN_DEV uint32_t subc_cc(Carry& c, uint32_t a, uint32_t b) {
  const uint64_t d = (uint64_t)a - b - c.cf;
  c.cf = (uint32_t)(d >> 63);
  return (uint32_t)d;
}
BN_DEV uint32_t subc(Carry& c, uint32_t a, uint32_t b) { return a - b - c.cf; }
BN_DEV uint32_t mad_lo_cc(Carry& c, uint32_t a, uint32_t b, uint32_t d) { return add_cc(c, a * b, d); }
BN_DEV uint32_t madc_lo_cc(Carry& c, uint32_t a, uint32_t b, uint32_t d) { return addc_cc(c, a * b, d); }
BN_DEV uint32_t mad_hi_cc(Carry& c, uint32_t a, uint32_t b, uint32_t d) { return add_cc(c, mul_hi(a, b), d); }
BN_DEV uint32_t madc_hi_cc(Carry& c, uint32_t a, uint32_t b, uint32_t d) { return addc_cc(c, mul_hi(a, b), d); }
BN_DEV uint32_t madc_hi(Carry& c, uint32_t a, uint32_t b, uint32_t d) { return addc(c, mul_hi(a, b), d); }

#endif  // __CUDA_ARCH__
