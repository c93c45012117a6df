"""BN254 (alt_bn128) curve constants and limb-tensor packing.

All constants are defined as exact Python integers and converted to the limb
representation (L x 16-bit limbs, batch axis last).  The Montgomery radix is
R = 2^256, matching the reference crate's 4x64-limb Montgomery form
(reference: src/fields/fp.rs:161-177), so Montgomery-form values here are
bit-identical to the reference's and its golden vectors apply directly.

Layout convention: a batch of field elements is a tensor of shape (L, B) —
limb axis before batch, batch innermost (neighbouring threads of a warp read
neighbouring batch elements of one limb).  Tower fields stack structure axes
in front: Fq2 = (2, L, B), Fq6 = (3, 2, L, B), Fq12 = (2, 3, 2, L, B).
The numpy helpers below pack uint32; tensors of the package hold the same
values as torch.int32 (see convert.py).
"""

from __future__ import annotations

import functools

import numpy as np

# ---------------------------------------------------------------------------
# Limb representation
# ---------------------------------------------------------------------------

LIMB_BITS = 16
NLIMBS = 16  # 16 x 16 = 256 bits
LIMB_MASK = (1 << LIMB_BITS) - 1
NLIMBS_512 = 32

# ---------------------------------------------------------------------------
# Primes and curve parameters (reference: src/fields/fp.rs:161-177, decimal
# check at src/fields/mod.rs:68-71)
# ---------------------------------------------------------------------------

# Base field modulus q
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
# Scalar field modulus r
R_SCALAR = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BN parameter z (reference: src/fields/fq12.rs:97-101)
Z_BN = 4965661367192848881
# Optimal-ate Miller loop count 6z+2 (reference: src/groups/mod.rs:452-454)
ATE_LOOP_COUNT = 6 * Z_BN + 2
assert ATE_LOOP_COUNT == 29793968203157093288

# Montgomery radix (same as the reference's 4x64-bit limb form)
R_MONT = 1 << 256

# Curve: y^2 = x^3 + 3 over Fq; G1 generator (1, 2)
B_COEFF = 3
G1_GEN = (1, 2)

# Fq2 = Fq[u]/(u^2 + 1): the quadratic non-residue used to build Fq2 is -1
# (reference: src/fields/fq2.rs:9-14)
FQ_NON_RESIDUE = Q - 1

# Fq6 = Fq2[v]/(v^3 - xi), xi = 9 + u (reference: src/fields/fq2.rs:16-22)
XI = (9, 1)  # (c0, c1) in Fq2

# G2 generator over Fq2 (canonical alt_bn128 values; the reference hardcodes
# the Montgomery limbs at src/groups/mod.rs:378-390 — asserted equal in tests)
G2_GEN_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

# ---------------------------------------------------------------------------
# Host-side modular helpers (exact Python ints)
# ---------------------------------------------------------------------------


def inv_mod(a: int, m: int) -> int:
    return pow(a, -1, m)


# Montgomery constants for each field, mirroring the reference's derivation
# (reference: src/fields/fp.rs:161-177); computed rather than transcribed, and
# asserted against the reference's published limbs in tests/test_params.py.
def mont_constants(modulus: int):
    r1 = R_MONT % modulus
    r2 = (R_MONT * R_MONT) % modulus
    r3 = (r2 * r1) % modulus
    # -modulus^-1 mod 2^LIMB_BITS for CIOS per-limb reduction
    inv = (-inv_mod(modulus, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
    # -modulus^-1 mod 2^64 (reference's u64-word inv, for cross-checking)
    inv64 = (-inv_mod(modulus, 1 << 64)) % (1 << 64)
    return r1, r2, r3, inv, inv64


FQ_R1, FQ_R2, FQ_R3, FQ_INV, FQ_INV64 = mont_constants(Q)
FR_R1, FR_R2, FR_R3, FR_INV, FR_INV64 = mont_constants(R_SCALAR)

# The CUDA kernels run the Montgomery reduction on eight 32-bit words, so they
# need -modulus^-1 mod 2^32: the low word of the 2^64 inverse (R stays 2^256,
# hence the product is the same integer as the 16-bit-word recurrence gives).
WORD_BITS = 32
NWORDS = 8
FQ_INV32 = FQ_INV64 & 0xFFFFFFFF
FR_INV32 = FR_INV64 & 0xFFFFFFFF
assert (Q * FQ_INV32 + 1) % (1 << 32) == 0
assert (R_SCALAR * FR_INV32 + 1) % (1 << 32) == 0


def int_to_words(x: int) -> list:
    """Little-endian 32-bit words of a 256-bit integer (kernel arguments)."""
    assert 0 <= x < (1 << 256)
    return [(x >> (WORD_BITS * i)) & 0xFFFFFFFF for i in range(NWORDS)]

# two_inv in Fq (reference: src/groups/mod.rs:446-449)
TWO_INV = inv_mod(2, Q)

# b' = b / xi for the D-type twist E'/Fq2 (reference: src/groups/mod.rs:392-397)
# Computed in tests; stored here as exact ints via Fq2 arithmetic in oracle.

# ---------------------------------------------------------------------------
# int <-> limb conversion (numpy, host side)
# ---------------------------------------------------------------------------


def int_to_limbs(x: int, nlimbs: int = NLIMBS) -> np.ndarray:
    """Little-endian LIMB_BITS-bit limbs of x, as uint32."""
    assert 0 <= x < (1 << (LIMB_BITS * nlimbs)), "value out of range"
    out = np.empty((nlimbs,), dtype=np.uint32)
    for i in range(nlimbs):
        out[i] = (x >> (LIMB_BITS * i)) & LIMB_MASK
    return out


def limbs_to_int(limbs) -> int:
    limbs = np.asarray(limbs)
    assert limbs.ndim == 1
    x = 0
    for i in range(limbs.shape[0] - 1, -1, -1):
        x = (x << LIMB_BITS) | int(limbs[i])
    return x


def ints_to_limbs(xs, nlimbs: int = NLIMBS) -> np.ndarray:
    """Pack a sequence of ints into a (nlimbs, B) uint32 tensor (batch last)."""
    xs = list(xs)
    out = np.empty((nlimbs, len(xs)), dtype=np.uint32)
    for b, x in enumerate(xs):
        out[:, b] = int_to_limbs(x, nlimbs)
    return out


def limbs_to_ints(limbs) -> list:
    """Unpack a (nlimbs, B) uint32 tensor into a list of ints."""
    limbs = np.asarray(limbs)
    assert limbs.ndim == 2
    return [limbs_to_int(limbs[:, b]) for b in range(limbs.shape[1])]


def u64x4_to_int(limbs64) -> int:
    """Interpret the reference's 4x64-bit little-endian limb arrays."""
    x = 0
    for i, l in enumerate(limbs64):
        x |= int(l) << (64 * i)
    return x


# ---------------------------------------------------------------------------
# Montgomery form conversion (host side)
# ---------------------------------------------------------------------------


def to_mont(x: int, modulus: int) -> int:
    return (x * R_MONT) % modulus


def from_mont(x: int, modulus: int) -> int:
    return (x * inv_mod(R_MONT, modulus)) % modulus


# ---------------------------------------------------------------------------
# Static bit schedules (host side; all loop schedules are compile-time)
# ---------------------------------------------------------------------------


def bits_msb_first(x: int) -> list:
    """Bits of x from MSB to LSB, without leading zeros."""
    return [int(c) for c in bin(x)[2:]]


@functools.lru_cache(maxsize=None)
def miller_schedule():
    """The static ladder schedule for the optimal-ate Miller loop.

    Mirrors the bit iteration of the reference (src/groups/mod.rs:485-520,
    557-588): the leading bit is skipped; each subsequent bit contributes a
    doubling step, plus an addition step if the bit is set, then two final
    addition steps for the Frobenius-twisted points q1 and -q2.

    Returns (step_is_add, n_coeffs): step_is_add is a tuple of 0/1 flags, one
    per line-coefficient slot, where slot k is an addition step iff flag=1;
    doubling steps are preceded by an f-squaring in the Miller loop.
    """
    bits = bits_msb_first(ATE_LOOP_COUNT)[1:]  # skip leading bit
    flags = []
    for b in bits:
        flags.append(0)  # doubling step
        if b:
            flags.append(1)  # addition step
    flags.extend([1, 1])  # final q1 / q2 addition steps
    assert len(flags) == 102, len(flags)  # reference invariant (mod.rs:761)
    return tuple(flags)
