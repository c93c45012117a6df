"""Exact host-side oracle for BN254 pairing semantics, in pure Python ints.

This module is the bit-exact semantic model the tensor code and the CUDA
kernels are differentially tested against.  It follows the same mathematical choices as the
reference crate (tower construction, Jacobian formulas, mul_by_024 sparse
multiply, Granger–Scott cyclotomic squaring, Fuentes-style final-exp hard
part) because those pin the golden test vectors — see SURVEY.md §7.

Field element conventions:
  Fq / Fr : int in [0, modulus)
  Fq2     : tuple (c0, c1) of Fq
  Fq6     : tuple (c0, c1, c2) of Fq2
  Fq12    : tuple (c0, c1) of Fq6
  points  : Jacobian tuples (x, y, z); affine tuples (x, y)

References into the reference crate's sources (src/...) are given per
function for parity checking.
"""

from __future__ import annotations

import functools

from .params import (
    ATE_LOOP_COUNT,
    B_COEFF,
    FQ_NON_RESIDUE,
    G1_GEN,
    G2_GEN_X,
    G2_GEN_Y,
    Q,
    R_SCALAR,
    TWO_INV,
    XI,
    Z_BN,
    bits_msb_first,
    inv_mod,
)

# ---------------------------------------------------------------------------
# Fq
# ---------------------------------------------------------------------------


def fq_add(a, b):
    return (a + b) % Q


def fq_sub(a, b):
    return (a - b) % Q


def fq_mul(a, b):
    return (a * b) % Q


def fq_neg(a):
    return (-a) % Q


def fq_inv(a):
    return inv_mod(a, Q)


def fq_sqrt(a):
    """Square root in Fq or None (q = 3 mod 4, so a^((q+1)/4) works)."""
    a %= Q
    r = pow(a, (Q + 1) // 4, Q)
    return r if r * r % Q == a else None


# ---------------------------------------------------------------------------
# Fq2 = Fq[u]/(u^2 + 1)   (reference: src/fields/fq2.rs)
# ---------------------------------------------------------------------------

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def fq2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u) with u^2 = -1
    aa = a[0] * b[0]
    bb = a[1] * b[1]
    return ((aa - bb) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)


def fq2_scale(a, k):
    return ((a[0] * k) % Q, (a[1] * k) % Q)


def fq2_sq(a):
    return fq2_mul(a, a)


def fq2_inv(a):
    # reference: src/fields/fq2.rs:125-136 (Algorithm 8)
    t = inv_mod((a[0] * a[0] + a[1] * a[1]) % Q, Q)
    return ((a[0] * t) % Q, (-a[1] * t) % Q)


def fq2_conj(a):
    return (a[0], (-a[1]) % Q)


def fq2_frob(a, power):
    # reference: src/fields/fq2.rs:74-83
    return a if power % 2 == 0 else fq2_conj(a)


def fq2_mul_by_xi(a):
    # multiply by xi = 9 + u (reference: fq2_nonresidue, src/fields/fq2.rs:16-22)
    return fq2_mul(a, XI)


def fq2_pow(a, e):
    res = FQ2_ONE
    for bit in bits_msb_first(e) if e else [0]:
        res = fq2_sq(res)
        if bit:
            res = fq2_mul(res, a)
    return res


def fq2_is_zero(a):
    return a[0] == 0 and a[1] == 0


def fq2_sqrt(a):
    """Square root in Fq2 = Fq[u]/(u^2+1) via the complex method, or None.

    For a = a0 + a1*u: norm(a) = a0^2 + a1^2 must be a square in Fq; with
    s = sqrt(norm), y0^2 = (a0 + s)/2 (or (a0 - s)/2), y1 = a1 / (2 y0)."""
    a0, a1 = a[0] % Q, a[1] % Q
    if a1 == 0:
        r = fq_sqrt(a0)
        if r is not None:
            return (r, 0)
        r = fq_sqrt((-a0) % Q)  # a0 = -(r^2) => (r*u)^2 = a0
        return None if r is None else (0, r)
    s = fq_sqrt((a0 * a0 + a1 * a1) % Q)
    if s is None:
        return None
    inv2 = (Q + 1) // 2
    t = (a0 + s) * inv2 % Q
    y0 = fq_sqrt(t)
    if y0 is None:
        y0 = fq_sqrt((a0 - s) * inv2 % Q)
        if y0 is None:
            return None
    y1 = a1 * inv_mod(2 * y0 % Q, Q) % Q
    y = (y0, y1)
    return y if fq2_sq(y) == (a0, a1) else None


# ---------------------------------------------------------------------------
# Frobenius coefficient tables, derived from first principles.
# The reference hardcodes these as Montgomery limbs (src/fields/fq6.rs:5-40,
# src/fields/fq12.rs:7-24, src/groups/mod.rs:456-470); tests assert equality.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def frob_coeffs():
    """gamma tables: FQ6_C1[n] = xi^((q^n-1)/3), FQ6_C2[n] = xi^(2(q^n-1)/3),
    FQ12_C1[n] = xi^((q^n-1)/6) for n in 0..3."""
    fq6_c1, fq6_c2, fq12_c1 = [], [], []
    for n in range(4):
        e = pow(Q, n) - 1
        assert e % 6 == 0
        g12 = fq2_pow(XI, e // 6)
        g6 = fq2_pow(XI, e // 3)
        g6b = fq2_pow(XI, 2 * e // 3)
        fq12_c1.append(g12)
        fq6_c1.append(g6)
        fq6_c2.append(g6b)
    return tuple(fq6_c1), tuple(fq6_c2), tuple(fq12_c1)


@functools.lru_cache(maxsize=None)
def twist_frob_coeffs():
    """Coefficients for the G2 'untwist-Frobenius-twist' endomorphism
    (reference: twist_mul_by_q_x/y, src/groups/mod.rs:456-470)."""
    x_coeff = fq2_pow(XI, (Q - 1) // 3)
    y_coeff = fq2_pow(XI, (Q - 1) // 2)
    return x_coeff, y_coeff


@functools.lru_cache(maxsize=None)
def twist_b():
    """b' = b / xi (reference: G2Params::coeff_b, src/groups/mod.rs:392-397)."""
    return fq2_scale(fq2_inv(XI), B_COEFF)


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v]/(v^3 - xi)   (reference: src/fields/fq6.rs)
# ---------------------------------------------------------------------------

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def fq6_mul_by_nonresidue(a):
    # v * (c0 + c1 v + c2 v^2) = xi c2 + c0 v + c1 v^2
    # (reference: src/fields/fq6.rs:59-65)
    return (fq2_mul_by_xi(a[2]), a[0], a[1])


def fq6_mul(a, b):
    # Karatsuba (reference: src/fields/fq6.rs:144-158)
    a_a = fq2_mul(a[0], b[0])
    b_b = fq2_mul(a[1], b[1])
    c_c = fq2_mul(a[2], b[2])
    c0 = fq2_add(
        fq2_mul_by_xi(
            fq2_sub(
                fq2_sub(fq2_mul(fq2_add(a[1], a[2]), fq2_add(b[1], b[2])), b_b),
                c_c,
            )
        ),
        a_a,
    )
    c1 = fq2_add(
        fq2_sub(
            fq2_sub(fq2_mul(fq2_add(a[0], a[1]), fq2_add(b[0], b[1])), a_a), b_b
        ),
        fq2_mul_by_xi(c_c),
    )
    c2 = fq2_sub(
        fq2_add(
            fq2_sub(fq2_mul(fq2_add(a[0], a[2]), fq2_add(b[0], b[2])), a_a), b_b
        ),
        c_c,
    )
    return (c0, c1, c2)


def fq6_scale(a, k):
    return tuple(fq2_mul(x, k) for x in a)


def fq6_sq(a):
    # CH-SQR2 (reference: src/fields/fq6.rs:113-127)
    s0 = fq2_sq(a[0])
    ab = fq2_mul(a[0], a[1])
    s1 = fq2_add(ab, ab)
    s2 = fq2_sq(fq2_add(fq2_sub(a[0], a[1]), a[2]))
    bc = fq2_mul(a[1], a[2])
    s3 = fq2_add(bc, bc)
    s4 = fq2_sq(a[2])
    return (
        fq2_add(s0, fq2_mul_by_xi(s3)),
        fq2_add(s1, fq2_mul_by_xi(s4)),
        fq2_sub(fq2_sub(fq2_add(fq2_add(s1, s2), s3), s0), s4),
    )


def fq6_inv(a):
    # reference: src/fields/fq6.rs:129-141
    c0 = fq2_sub(fq2_sq(a[0]), fq2_mul(a[1], fq2_mul_by_xi(a[2])))
    c1 = fq2_sub(fq2_mul_by_xi(fq2_sq(a[2])), fq2_mul(a[0], a[1]))
    c2 = fq2_sub(fq2_sq(a[1]), fq2_mul(a[0], a[2]))
    norm = fq2_add(
        fq2_mul_by_xi(fq2_add(fq2_mul(a[2], c1), fq2_mul(a[1], c2))),
        fq2_mul(a[0], c0),
    )
    t = fq2_inv(norm)
    return (fq2_mul(t, c0), fq2_mul(t, c1), fq2_mul(t, c2))


def fq6_frob(a, power):
    # power is always in 0..3 (reference: src/fields/fq6.rs:5-40)
    c1t, c2t, _ = frob_coeffs()
    return (
        fq2_frob(a[0], power),
        fq2_mul(fq2_frob(a[1], power), c1t[power]),
        fq2_mul(fq2_frob(a[2], power), c2t[power]),
    )


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w]/(w^2 - v)   (reference: src/fields/fq12.rs)
# ---------------------------------------------------------------------------

FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_sub(a, b):
    return (fq6_sub(a[0], b[0]), fq6_sub(a[1], b[1]))


def fq12_neg(a):
    return (fq6_neg(a[0]), fq6_neg(a[1]))


def fq12_mul(a, b):
    aa = fq6_mul(a[0], b[0])
    bb = fq6_mul(a[1], b[1])
    return (
        fq6_add(fq6_mul_by_nonresidue(bb), aa),
        fq6_sub(
            fq6_sub(fq6_mul(fq6_add(a[0], a[1]), fq6_add(b[0], b[1])), aa), bb
        ),
    )


def fq12_sq(a):
    ab = fq6_mul(a[0], a[1])
    return (
        fq6_sub(
            fq6_sub(
                fq6_mul(
                    fq6_add(fq6_mul_by_nonresidue(a[1]), a[0]),
                    fq6_add(a[0], a[1]),
                ),
                ab,
            ),
            fq6_mul_by_nonresidue(ab),
        ),
        fq6_add(ab, ab),
    )


def fq12_inv(a):
    t = fq6_inv(fq6_sub(fq6_sq(a[0]), fq6_mul_by_nonresidue(fq6_sq(a[1]))))
    return (fq6_mul(a[0], t), fq6_neg(fq6_mul(a[1], t)))


def fq12_conj(a):
    """unitary inverse (reference: src/fields/fq12.rs:103-105)"""
    return (a[0], fq6_neg(a[1]))


def fq12_frob(a, power):
    _, _, c1t = frob_coeffs()
    return (
        fq6_frob(a[0], power),
        fq6_scale(fq6_frob(a[1], power), c1t[power % 12]),
    )


def fq12_is_one(a):
    return a == FQ12_ONE


def fq12_pow(a, e):
    res = FQ12_ONE
    if e == 0:
        return res
    for bit in bits_msb_first(e):
        res = fq12_sq(res)
        if bit:
            res = fq12_mul(res, a)
    return res


def fq12_mul_by_024(a, ell_0, ell_vw, ell_vv):
    # Sparse multiply by (ell_0 + ell_vv w^2? ...) in the 024 layout
    # (reference: src/fields/fq12.rs:107-176)
    z0, z1, z2 = a[0]
    z3, z4, z5 = a[1]
    x0, x2, x4 = ell_0, ell_vv, ell_vw

    d0 = fq2_mul(z0, x0)
    d2 = fq2_mul(z2, x2)
    d4 = fq2_mul(z4, x4)
    t2 = fq2_add(z0, z4)
    t1 = fq2_add(z0, z2)
    s0 = fq2_add(fq2_add(z1, z3), z5)

    s1 = fq2_mul(z1, x2)
    t3 = fq2_add(s1, d4)
    t4 = fq2_add(fq2_mul_by_xi(t3), d0)
    nz0 = t4

    t3 = fq2_mul(z5, x4)
    s1 = fq2_add(s1, t3)
    t3 = fq2_add(t3, d2)
    t4 = fq2_mul_by_xi(t3)
    t3 = fq2_mul(z1, x0)
    s1 = fq2_add(s1, t3)
    t4 = fq2_add(t4, t3)
    nz1 = t4

    t0 = fq2_add(x0, x2)
    t3 = fq2_sub(fq2_sub(fq2_mul(t1, t0), d0), d2)
    t4 = fq2_mul(z3, x4)
    s1 = fq2_add(s1, t4)
    t3 = fq2_add(t3, t4)

    t0 = fq2_add(z2, z4)
    nz2 = t3

    t1 = fq2_add(x2, x4)
    t3 = fq2_sub(fq2_sub(fq2_mul(t0, t1), d2), d4)
    t4 = fq2_mul_by_xi(t3)
    t3 = fq2_mul(z3, x0)
    s1 = fq2_add(s1, t3)
    t4 = fq2_add(t4, t3)
    nz3 = t4

    t3 = fq2_mul(z5, x2)
    s1 = fq2_add(s1, t3)
    t4 = fq2_mul_by_xi(t3)
    t0 = fq2_add(x0, x4)
    t3 = fq2_sub(fq2_sub(fq2_mul(t2, t0), d0), d4)
    t4 = fq2_add(t4, t3)
    nz4 = t4

    t0 = fq2_add(fq2_add(x0, x2), x4)
    t3 = fq2_sub(fq2_mul(s0, t0), s1)
    nz5 = t3

    return ((nz0, nz1, nz2), (nz3, nz4, nz5))


def fq12_cyclotomic_sq(a):
    # Granger–Scott (reference: src/fields/fq12.rs:178-227)
    z0, z4, z3 = a[0]
    z2, z1, z5 = a[1]

    def gs(u, v):
        tmp = fq2_mul(u, v)
        t_a = fq2_sub(
            fq2_sub(
                fq2_mul(fq2_add(u, v), fq2_add(fq2_mul_by_xi(v), u)), tmp
            ),
            fq2_mul_by_xi(tmp),
        )
        t_b = fq2_add(tmp, tmp)
        return t_a, t_b

    t0, t1 = gs(z0, z1)
    t2, t3 = gs(z2, z3)
    t4, t5 = gs(z4, z5)

    def triple_a(t, z):  # 3t - 2z for the "minus" rows
        r = fq2_sub(t, z)
        r = fq2_add(r, r)
        return fq2_add(r, t)

    def triple_b(t, z):  # 3t + 2z for the "plus" rows
        r = fq2_add(t, z)
        r = fq2_add(r, r)
        return fq2_add(r, t)

    nz0 = triple_a(t0, z0)
    nz1 = triple_b(t1, z1)
    tmp = fq2_mul_by_xi(t5)
    nz2 = triple_b(tmp, z2)
    nz3 = triple_a(t4, z3)
    nz4 = triple_a(t2, z4)
    nz5 = triple_b(t3, z5)

    return ((nz0, nz4, nz3), (nz2, nz1, nz5))


def fq12_cyclotomic_pow(a, e):
    # reference: src/fields/fq12.rs:229-246
    res = FQ12_ONE
    found_one = False
    for bit in bits_msb_first(e):
        if found_one:
            res = fq12_cyclotomic_sq(res)
        if bit:
            found_one = True
            res = fq12_mul(a, res)
    return res


def fq12_exp_by_neg_z(a):
    # reference: src/fields/fq12.rs:97-101
    return fq12_conj(fq12_cyclotomic_pow(a, Z_BN))


def final_exponentiation(f):
    # easy part (reference: src/fields/fq12.rs:41-52)
    b = fq12_inv(f)
    a = fq12_conj(f)
    c = fq12_mul(a, b)
    d = fq12_frob(c, 2)
    e0 = fq12_mul(d, c)

    # hard part, Fuentes et al. chain (reference: src/fields/fq12.rs:54-84)
    s = e0
    a = fq12_exp_by_neg_z(s)
    b = fq12_cyclotomic_sq(a)
    c = fq12_cyclotomic_sq(b)
    d = fq12_mul(c, b)
    e = fq12_exp_by_neg_z(d)
    f2 = fq12_cyclotomic_sq(e)
    g = fq12_exp_by_neg_z(f2)
    h = fq12_conj(d)
    i = fq12_conj(g)
    j = fq12_mul(i, e)
    k = fq12_mul(j, h)
    l = fq12_mul(k, b)
    m = fq12_mul(k, e)
    n = fq12_mul(s, m)
    o = fq12_frob(l, 1)
    p = fq12_mul(o, n)
    q = fq12_frob(k, 2)
    r = fq12_mul(q, p)
    s2 = fq12_conj(s)
    t = fq12_mul(s2, l)
    u = fq12_frob(t, 3)
    v = fq12_mul(u, r)
    return v


# ---------------------------------------------------------------------------
# Curve groups (reference: src/groups/mod.rs)
# Generic over the base field via small op tables.
# ---------------------------------------------------------------------------


class FieldOps:
    def __init__(self, add, sub, mul, neg, sq, inv, zero, one, is_zero, scale):
        self.add, self.sub, self.mul, self.neg = add, sub, mul, neg
        self.sq, self.inv, self.zero, self.one = sq, inv, zero, one
        self.is_zero, self.scale = is_zero, scale


FQ_OPS = FieldOps(
    fq_add, fq_sub, fq_mul, fq_neg, lambda a: (a * a) % Q, fq_inv, 0, 1,
    lambda a: a == 0, lambda a, k: (a * k) % Q,
)
FQ2_OPS = FieldOps(
    fq2_add, fq2_sub, fq2_mul, fq2_neg, fq2_sq, fq2_inv, FQ2_ZERO, FQ2_ONE,
    fq2_is_zero, lambda a, k: fq2_scale(a, k),
)


def g_zero(F):
    # point at infinity convention (0, 1, 0) (reference: src/groups/mod.rs:208-214)
    return (F.zero, F.one, F.zero)


def g_is_zero(F, p):
    return F.is_zero(p[2])


def g_double(F, p):
    # dbl-2009-l (reference: src/groups/mod.rs:228-247)
    x, y, z = p
    a = F.sq(x)
    b = F.sq(y)
    c = F.sq(b)
    d = F.sub(F.sub(F.sq(F.add(x, b)), a), c)
    d = F.add(d, d)
    e = F.add(F.add(a, a), a)
    f = F.sq(e)
    x3 = F.sub(f, F.add(d, d))
    eight_c = F.add(c, c)
    eight_c = F.add(eight_c, eight_c)
    eight_c = F.add(eight_c, eight_c)
    y1z1 = F.mul(y, z)
    return (x3, F.sub(F.mul(e, F.sub(d, x3)), eight_c), F.add(y1z1, y1z1))


def g_add(F, p, q):
    # 2007-bl Jacobian add with the reference's degenerate-case semantics
    # (reference: src/groups/mod.rs:272-312)
    if g_is_zero(F, p):
        return q
    if g_is_zero(F, q):
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1s = F.sq(z1)
    z2s = F.sq(z2)
    u1 = F.mul(x1, z2s)
    u2 = F.mul(x2, z1s)
    z1c = F.mul(z1, z1s)
    z2c = F.mul(z2, z2s)
    s1 = F.mul(y1, z2c)
    s2 = F.mul(y2, z1c)
    if u1 == u2 and s1 == s2:
        return g_double(F, p)
    h = F.sub(u2, u1)
    ss = F.sub(s2, s1)
    i = F.sq(F.add(h, h))
    j = F.mul(h, i)
    r = F.add(ss, ss)
    v = F.mul(u1, i)
    s1j = F.mul(s1, j)
    x3 = F.sub(F.sub(F.sq(r), j), F.add(v, v))
    y3 = F.sub(F.mul(r, F.sub(v, x3)), F.add(s1j, s1j))
    z3 = F.mul(F.sub(F.sub(F.sq(F.add(z1, z2)), z1s), z2s), h)
    return (x3, y3, z3)


def g_neg(F, p):
    if g_is_zero(F, p):
        return p
    return (p[0], F.neg(p[1]), p[2])


def g_mul(F, p, k):
    # double-and-add (reference: src/groups/mod.rs:250-270)
    res = g_zero(F)
    k = k % R_SCALAR
    if k == 0:
        return res
    found_one = False
    for bit in bits_msb_first(k):
        if found_one:
            res = g_double(F, res)
        if bit:
            found_one = True
            res = g_add(F, res, p)
    return res


def g_to_affine(F, p):
    if g_is_zero(F, p):
        return None
    zinv = F.inv(p[2])
    zinv2 = F.sq(zinv)
    return (F.mul(p[0], zinv2), F.mul(p[1], F.mul(zinv2, zinv)))


def g_from_affine(F, a):
    return (a[0], a[1], F.one)


def g_eq(F, p, q):
    if g_is_zero(F, p):
        return g_is_zero(F, q)
    if g_is_zero(F, q):
        return False
    z1s, z2s = F.sq(p[2]), F.sq(q[2])
    if F.mul(p[0], z2s) != F.mul(q[0], z1s):
        return False
    return F.mul(p[1], F.mul(q[2], z2s)) == F.mul(q[1], F.mul(p[2], z1s))


G1_ONE = (G1_GEN[0], G1_GEN[1], 1)
G2_ONE = (G2_GEN_X, G2_GEN_Y, FQ2_ONE)


def g1_mul(p, k):
    return g_mul(FQ_OPS, p, k)


def g2_mul(p, k):
    return g_mul(FQ2_OPS, p, k)


def g1_on_curve(a):
    x, y = a
    return (y * y - (x * x * x + B_COEFF)) % Q == 0


def g2_on_curve(a):
    x, y = a
    return fq2_sq(y) == fq2_add(fq2_mul(fq2_sq(x), x), twist_b())


def g2_in_subgroup(a):
    """Full-order subgroup check, as the reference does on G2 decode:
    p * Fr(-1) + p == 0 (reference: src/groups/mod.rs:186-195).  NB the
    scalar must be r-1 then one more add — g_mul reduces k mod r, so a
    direct g_mul(p, r) would be multiplication by zero (a vacuous check)."""
    p = g_from_affine(FQ2_OPS, a)
    r_minus_one_p = g2_mul(p, R_SCALAR - 1)
    return g_is_zero(FQ2_OPS, g_add(FQ2_OPS, r_minus_one_p, p))


# ---------------------------------------------------------------------------
# Optimal ate pairing (reference: src/groups/mod.rs:441-771)
# ---------------------------------------------------------------------------


def _mul_by_q(a):
    """Untwist-Frobenius-twist endomorphism on affine G2
    (reference: src/groups/mod.rs:550-555)."""
    xc, yc = twist_frob_coeffs()
    return (fq2_mul(xc, fq2_conj(a[0])), fq2_mul(yc, fq2_conj(a[1])))


def _doubling_step(r):
    # reference: src/groups/mod.rs:612-634
    x, y, z = r
    a = fq2_scale(fq2_mul(x, y), TWO_INV)
    b = fq2_sq(y)
    c = fq2_sq(z)
    d = fq2_add(fq2_add(c, c), c)
    e = fq2_mul(twist_b(), d)
    f = fq2_add(fq2_add(e, e), e)
    g = fq2_scale(fq2_add(b, f), TWO_INV)
    h = fq2_sub(fq2_sq(fq2_add(y, z)), fq2_add(b, c))
    i = fq2_sub(e, b)
    j = fq2_sq(x)
    e_sq = fq2_sq(e)
    nx = fq2_mul(a, fq2_sub(b, f))
    ny = fq2_sub(fq2_sq(g), fq2_add(fq2_add(e_sq, e_sq), e_sq))
    nz = fq2_mul(b, h)
    ell_0 = fq2_mul_by_xi(i)
    ell_vw = fq2_neg(h)
    ell_vv = fq2_add(fq2_add(j, j), j)
    return (nx, ny, nz), (ell_0, ell_vw, ell_vv)


def _mixed_addition_step(r, base):
    # reference: src/groups/mod.rs:591-610
    x, y, z = r
    d = fq2_sub(x, fq2_mul(z, base[0]))
    e = fq2_sub(y, fq2_mul(z, base[1]))
    f = fq2_sq(d)
    g = fq2_sq(e)
    h = fq2_mul(d, f)
    i = fq2_mul(x, f)
    j = fq2_sub(fq2_add(fq2_mul(z, g), h), fq2_add(i, i))
    nx = fq2_mul(d, j)
    ny = fq2_sub(fq2_mul(e, fq2_sub(i, j)), fq2_mul(h, y))
    nz = fq2_mul(z, h)
    ell_0 = fq2_mul_by_xi(
        fq2_sub(fq2_mul(e, base[0]), fq2_mul(d, base[1]))
    )
    ell_vv = fq2_neg(e)
    ell_vw = d
    return (nx, ny, nz), (ell_0, ell_vw, ell_vv)


def precompute_g2(q_affine):
    """G2 precompute: 102 line coefficients (reference: src/groups/mod.rs:557-588)."""
    r = g_from_affine(FQ2_OPS, q_affine)
    coeffs = []
    for bit in bits_msb_first(ATE_LOOP_COUNT)[1:]:
        r, c = _doubling_step(r)
        coeffs.append(c)
        if bit:
            r, c = _mixed_addition_step(r, q_affine)
            coeffs.append(c)
    q1 = _mul_by_q(q_affine)
    q2_ = _mul_by_q(q1)
    q2 = (q2_[0], fq2_neg(q2_[1]))  # q2 = -(q1.mul_by_q())
    r, c = _mixed_addition_step(r, q1)
    coeffs.append(c)
    r, c = _mixed_addition_step(r, q2)
    coeffs.append(c)
    assert len(coeffs) == 102
    return coeffs


def miller_loop(coeffs, p_affine):
    """Replay line coefficients against a G1 point
    (reference: src/groups/mod.rs:485-520)."""
    px, py = p_affine
    f = FQ12_ONE
    idx = 0
    for bit in bits_msb_first(ATE_LOOP_COUNT)[1:]:
        c = coeffs[idx]
        idx += 1
        f = fq12_mul_by_024(
            fq12_sq(f), c[0], fq2_scale(c[1], py), fq2_scale(c[2], px)
        )
        if bit:
            c = coeffs[idx]
            idx += 1
            f = fq12_mul_by_024(f, c[0], fq2_scale(c[1], py), fq2_scale(c[2], px))
    for _ in range(2):
        c = coeffs[idx]
        idx += 1
        f = fq12_mul_by_024(f, c[0], fq2_scale(c[1], py), fq2_scale(c[2], px))
    return f


def pairing(p, q):
    """Full reduced pairing on Jacobian inputs
    (reference: src/groups/mod.rs:764-771)."""
    pa = g_to_affine(FQ_OPS, p)
    qa = g_to_affine(FQ2_OPS, q)
    if pa is None or qa is None:
        return FQ12_ONE
    coeffs = precompute_g2(qa)
    f = miller_loop(coeffs, pa)
    return final_exponentiation(f)
