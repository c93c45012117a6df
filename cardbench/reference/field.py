"""The plain reference of the BN254 reduced optimal-ate pairing, in Python's
integers, with a counter of base-field products.

A frozen copy of the semantics the benchmarked package implements (tower
Fq2 = Fq[u]/(u^2 + 1), Fq6 = Fq2[v]/(v^3 - xi) with xi = 9 + u, Fq12 =
Fq6[w]/(w^2 - v); the G2 line-coefficient precompute, the Miller loop over
6z + 2 with the two Frobenius-twisted additions, and the final exponentiation
with the Fuentes et al. hard part, as in the `bn` crate's src/groups/mod.rs
and src/fields/fq12.rs).  It imports nothing of the package it judges.

`Ref` counts every product of two base-field elements (`fq_mul`): an Fq2
product is three (Karatsuba), an Fq2 square two, a product by xi or by a small
integer none (it is sums), a halving none.  An inversion is Python's
extended-Euclid `pow(x, -1, q)` and counts no product.  `work.json` keeps
these counts per stage of one pairing; `count_work()` recomputes them.
"""

from __future__ import annotations

import functools

# BN254 (alt_bn128)
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
Z = 4965661367192848881
ATE_LOOP_COUNT = 6 * Z + 2
G1_GEN = (1, 2)
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)

FQ2_ZERO, FQ2_ONE = (0, 0), (1, 0)
FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)

STAGES = ("to_affine", "precompute", "miller_loop", "final_exp")


def _bits(x: int) -> list:
    return [int(c) for c in bin(x)[2:]]


def _half(a: int) -> int:
    return (a if a % 2 == 0 else a + Q) // 2


# arithmetic on constants (Frobenius tables, the twist's b): not counted
def _c2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)


def _c2_pow(a, e):
    res = FQ2_ONE
    for bit in _bits(e):
        res = _c2_mul(res, res)
        if bit:
            res = _c2_mul(res, a)
    return res


@functools.lru_cache(maxsize=None)
def constants():
    """xi^((q^n - 1)/3), xi^(2(q^n - 1)/3), xi^((q^n - 1)/6) for n = 0..3,
    the twist-Frobenius coefficients of x and y, and b' = 3 / xi."""
    xi = (9, 1)
    c6a, c6b, c12 = [], [], []
    for n in range(4):
        e = Q**n - 1
        c6a.append(_c2_pow(xi, e // 3))
        c6b.append(_c2_pow(xi, 2 * e // 3))
        c12.append(_c2_pow(xi, e // 6))
    norm_inv = pow(9 * 9 + 1, -1, Q)
    xi_inv = (9 * norm_inv % Q, -norm_inv % Q)
    twist_b = (3 * xi_inv[0] % Q, 3 * xi_inv[1] % Q)
    return tuple(c6a), tuple(c6b), tuple(c12), (_c2_pow(xi, (Q - 1) // 3), _c2_pow(xi, (Q - 1) // 2)), twist_b


class Ref:
    """Field, group and pairing arithmetic; `products` counts base-field
    products since it was last set to 0."""

    def __init__(self):
        self.products = 0

    # -- Fq -------------------------------------------------------------------
    def fq_mul(self, a, b):
        self.products += 1
        return a * b % Q

    # -- Fq2 ------------------------------------------------------------------
    @staticmethod
    def f2_add(a, b):
        return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)

    @staticmethod
    def f2_sub(a, b):
        return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)

    @staticmethod
    def f2_neg(a):
        return (-a[0] % Q, -a[1] % Q)

    @staticmethod
    def f2_xi(a):
        return ((9 * a[0] - a[1]) % Q, (a[0] + 9 * a[1]) % Q)

    @staticmethod
    def f2_conj(a):
        return (a[0], -a[1] % Q)

    def f2_mul(self, a, b):
        aa = self.fq_mul(a[0], b[0])
        bb = self.fq_mul(a[1], b[1])
        t = self.fq_mul(a[0] + a[1], b[0] + b[1])
        return ((aa - bb) % Q, (t - aa - bb) % Q)

    def f2_sq(self, a):
        t = self.fq_mul(a[0] + a[1], a[0] - a[1])
        m = self.fq_mul(a[0], a[1])
        return (t, 2 * m % Q)

    def f2_scale(self, a, k):
        return (self.fq_mul(a[0], k), self.fq_mul(a[1], k))

    def f2_inv(self, a):
        t = pow((self.fq_mul(a[0], a[0]) + self.fq_mul(a[1], a[1])) % Q, -1, Q)
        return (self.fq_mul(a[0], t), -self.fq_mul(a[1], t) % Q)

    # -- Fq6 ------------------------------------------------------------------
    def f6_add(self, a, b):
        return tuple(self.f2_add(x, y) for x, y in zip(a, b))

    def f6_sub(self, a, b):
        return tuple(self.f2_sub(x, y) for x, y in zip(a, b))

    def f6_neg(self, a):
        return tuple(self.f2_neg(x) for x in a)

    def f6_nonres(self, a):
        return (self.f2_xi(a[2]), a[0], a[1])

    def f6_mul(self, a, b):
        add, sub, mul, xi = self.f2_add, self.f2_sub, self.f2_mul, self.f2_xi
        aa, bb, cc = mul(a[0], b[0]), mul(a[1], b[1]), mul(a[2], b[2])
        c0 = add(xi(sub(sub(mul(add(a[1], a[2]), add(b[1], b[2])), bb), cc)), aa)
        c1 = add(sub(sub(mul(add(a[0], a[1]), add(b[0], b[1])), aa), bb), xi(cc))
        c2 = sub(add(sub(mul(add(a[0], a[2]), add(b[0], b[2])), aa), bb), cc)
        return (c0, c1, c2)

    def f6_sq(self, a):
        add, sub, xi = self.f2_add, self.f2_sub, self.f2_xi
        s0 = self.f2_sq(a[0])
        ab = self.f2_mul(a[0], a[1])
        s1 = add(ab, ab)
        s2 = self.f2_sq(add(sub(a[0], a[1]), a[2]))
        bc = self.f2_mul(a[1], a[2])
        s3 = add(bc, bc)
        s4 = self.f2_sq(a[2])
        return (add(s0, xi(s3)), add(s1, xi(s4)), sub(sub(add(add(s1, s2), s3), s0), s4))

    def f6_inv(self, a):
        add, sub, mul, sq, xi = self.f2_add, self.f2_sub, self.f2_mul, self.f2_sq, self.f2_xi
        c0 = sub(sq(a[0]), mul(a[1], xi(a[2])))
        c1 = sub(xi(sq(a[2])), mul(a[0], a[1]))
        c2 = sub(sq(a[1]), mul(a[0], a[2]))
        norm = add(xi(add(mul(a[2], c1), mul(a[1], c2))), mul(a[0], c0))
        t = self.f2_inv(norm)
        return (mul(t, c0), mul(t, c1), mul(t, c2))

    def f6_frob(self, a, n):
        c6a, c6b, _, _, _ = constants()
        fr = self.f2_conj if n % 2 else (lambda x: x)
        return (fr(a[0]), self.f2_mul(fr(a[1]), c6a[n]), self.f2_mul(fr(a[2]), c6b[n]))

    # -- Fq12 -----------------------------------------------------------------
    def f12_mul(self, a, b):
        aa = self.f6_mul(a[0], b[0])
        bb = self.f6_mul(a[1], b[1])
        t = self.f6_mul(self.f6_add(a[0], a[1]), self.f6_add(b[0], b[1]))
        return (self.f6_add(self.f6_nonres(bb), aa), self.f6_sub(self.f6_sub(t, aa), bb))

    def f12_sq(self, a):
        ab = self.f6_mul(a[0], a[1])
        t = self.f6_mul(self.f6_add(self.f6_nonres(a[1]), a[0]), self.f6_add(a[0], a[1]))
        return (self.f6_sub(self.f6_sub(t, ab), self.f6_nonres(ab)), self.f6_add(ab, ab))

    def f12_inv(self, a):
        t = self.f6_inv(self.f6_sub(self.f6_sq(a[0]), self.f6_nonres(self.f6_sq(a[1]))))
        return (self.f6_mul(a[0], t), self.f6_neg(self.f6_mul(a[1], t)))

    def f12_conj(self, a):
        return (a[0], self.f6_neg(a[1]))

    def f12_frob(self, a, n):
        _, _, c12, _, _ = constants()
        return (self.f6_frob(a[0], n), tuple(self.f2_mul(x, c12[n]) for x in self.f6_frob(a[1], n)))

    def f12_pow(self, a, e):
        res = FQ12_ONE
        for bit in _bits(e) if e else []:
            res = self.f12_sq(res)
            if bit:
                res = self.f12_mul(res, a)
        return res

    def f12_mul_by_024(self, a, ell_0, ell_vw, ell_vv):
        add, sub, mul, xi = self.f2_add, self.f2_sub, self.f2_mul, self.f2_xi
        (z0, z1, z2), (z3, z4, z5) = a
        x0, x2, x4 = ell_0, ell_vv, ell_vw
        d0, d2, d4 = mul(z0, x0), mul(z2, x2), mul(z4, x4)
        t2, t1 = add(z0, z4), add(z0, z2)
        s0 = add(add(z1, z3), z5)
        s1 = mul(z1, x2)
        nz0 = add(xi(add(s1, d4)), d0)
        t3 = mul(z5, x4)
        s1 = add(s1, t3)
        t4 = xi(add(t3, d2))
        t3 = mul(z1, x0)
        s1 = add(s1, t3)
        nz1 = add(t4, t3)
        t3 = sub(sub(mul(t1, add(x0, x2)), d0), d2)
        t4 = mul(z3, x4)
        s1 = add(s1, t4)
        nz2 = add(t3, t4)
        t4 = xi(sub(sub(mul(add(z2, z4), add(x2, x4)), d2), d4))
        t3 = mul(z3, x0)
        s1 = add(s1, t3)
        nz3 = add(t4, t3)
        t3 = mul(z5, x2)
        s1 = add(s1, t3)
        nz4 = add(xi(t3), sub(sub(mul(t2, add(x0, x4)), d0), d4))
        nz5 = sub(mul(s0, add(add(x0, x2), x4)), s1)
        return ((nz0, nz1, nz2), (nz3, nz4, nz5))

    def f12_cyclo_sq(self, a):
        add, sub, mul, xi = self.f2_add, self.f2_sub, self.f2_mul, self.f2_xi
        (z0, z4, z3), (z2, z1, z5) = a

        def gs(u, v):
            tmp = mul(u, v)
            return sub(sub(mul(add(u, v), add(xi(v), u)), tmp), xi(tmp)), add(tmp, tmp)

        t0, t1 = gs(z0, z1)
        t2, t3 = gs(z2, z3)
        t4, t5 = gs(z4, z5)

        def minus(t, z):  # 3t - 2z
            r = sub(t, z)
            return add(add(r, r), t)

        def plus(t, z):  # 3t + 2z
            r = add(t, z)
            return add(add(r, r), t)

        return ((minus(t0, z0), minus(t2, z4), minus(t4, z3)), (plus(xi(t5), z2), plus(t1, z1), plus(t3, z5)))

    def f12_exp_by_neg_z(self, a):
        res, found = FQ12_ONE, False
        for bit in _bits(Z):
            if found:
                res = self.f12_cyclo_sq(res)
            if bit:
                found = True
                res = self.f12_mul(a, res)
        return self.f12_conj(res)

    def final_exp(self, f):
        mul, conj, frob, cyc = self.f12_mul, self.f12_conj, self.f12_frob, self.f12_cyclo_sq
        c = mul(conj(f), self.f12_inv(f))
        s = mul(frob(c, 2), c)
        a = self.f12_exp_by_neg_z(s)
        b = cyc(a)
        d = mul(cyc(b), b)
        e = self.f12_exp_by_neg_z(d)
        g = self.f12_exp_by_neg_z(cyc(e))
        k = mul(mul(conj(g), e), conj(d))
        l_ = mul(k, b)
        p = mul(frob(l_, 1), mul(s, mul(k, e)))
        r = mul(frob(k, 2), p)
        return mul(frob(mul(conj(s), l_), 3), r)

    # -- groups (Jacobian; affine as (x, y)) -----------------------------------
    def g1_to_affine(self, p):
        zi = pow(p[2], -1, Q)
        zi2 = self.fq_mul(zi, zi)
        return (self.fq_mul(p[0], zi2), self.fq_mul(p[1], self.fq_mul(zi2, zi)))

    def g2_to_affine(self, p):
        zi = self.f2_inv(p[2])
        zi2 = self.f2_sq(zi)
        return (self.f2_mul(p[0], zi2), self.f2_mul(p[1], self.f2_mul(zi2, zi)))

    def _doubling_step(self, r):
        add, sub, mul, sq = self.f2_add, self.f2_sub, self.f2_mul, self.f2_sq
        x, y, z = r
        a = mul(x, y)
        a = (_half(a[0]), _half(a[1]))
        b, c = sq(y), sq(z)
        e = mul(constants()[4], add(add(c, c), c))
        f = add(add(e, e), e)
        g = add(b, f)
        g = (_half(g[0]), _half(g[1]))
        h = sub(sq(add(y, z)), add(b, c))
        j = sq(x)
        e_sq = sq(e)
        nr = (mul(a, sub(b, f)), sub(sq(g), add(add(e_sq, e_sq), e_sq)), mul(b, h))
        return nr, (self.f2_xi(sub(e, b)), self.f2_neg(h), add(add(j, j), j))

    def _addition_step(self, r, base):
        add, sub, mul, sq = self.f2_add, self.f2_sub, self.f2_mul, self.f2_sq
        x, y, z = r
        d = sub(x, mul(z, base[0]))
        e = sub(y, mul(z, base[1]))
        f, g = sq(d), sq(e)
        h, i = mul(d, f), mul(x, f)
        j = sub(add(mul(z, g), h), add(i, i))
        nr = (mul(d, j), sub(mul(e, sub(i, j)), mul(h, y)), mul(z, h))
        return nr, (self.f2_xi(sub(mul(e, base[0]), mul(d, base[1]))), d, self.f2_neg(e))

    def _mul_by_q(self, a):
        xc, yc = constants()[3]
        return (self.f2_mul(xc, self.f2_conj(a[0])), self.f2_mul(yc, self.f2_conj(a[1])))

    def precompute(self, qa):
        """102 line coefficients (ell_0, ell_vw, ell_vv) of the ladder over qa."""
        r, coeffs = (qa[0], qa[1], FQ2_ONE), []
        for bit in _bits(ATE_LOOP_COUNT)[1:]:
            r, c = self._doubling_step(r)
            coeffs.append(c)
            if bit:
                r, c = self._addition_step(r, qa)
                coeffs.append(c)
        q1 = self._mul_by_q(qa)
        q2 = self._mul_by_q(q1)
        for base in (q1, (q2[0], self.f2_neg(q2[1]))):
            r, c = self._addition_step(r, base)
            coeffs.append(c)
        return coeffs

    def miller_loop(self, coeffs, pa):
        px, py = pa
        f, steps = FQ12_ONE, iter(coeffs)

        def line(f, c):
            return self.f12_mul_by_024(f, c[0], self.f2_scale(c[1], py), self.f2_scale(c[2], px))

        for bit in _bits(ATE_LOOP_COUNT)[1:]:
            f = line(self.f12_sq(f), next(steps))
            if bit:
                f = line(f, next(steps))
        for c in steps:
            f = line(f, c)
        return f

    def pairing(self, p, q, per_stage=None):
        """e(p, q) of Jacobian points that are not infinity; with a dict
        `per_stage`, adds each stage's products to it."""
        def stage(name, fn, *args):
            before = self.products
            out = fn(*args)
            if per_stage is not None:
                per_stage[name] = per_stage.get(name, 0) + self.products - before
            return out

        pa = stage("to_affine", self.g1_to_affine, p)
        qa = stage("to_affine", self.g2_to_affine, q)
        coeffs = stage("precompute", self.precompute, qa)
        f = stage("miller_loop", self.miller_loop, coeffs, pa)
        return stage("final_exp", self.final_exp, f)

    # -- groups over Fq or Fq2, for the host's input tables -------------------
    def fq_ops(self):
        return (lambda a, b: (a + b) % Q, lambda a, b: (a - b) % Q, self.fq_mul, 1)

    def fq2_ops(self):
        return (self.f2_add, self.f2_sub, self.f2_mul, FQ2_ONE)

    @staticmethod
    def g_add(F, p, q):
        """Jacobian sum of two points that are neither infinity, equal nor
        opposite (add-2007-bl)."""
        add, sub, mul, _ = F
        z1s, z2s = mul(p[2], p[2]), mul(q[2], q[2])
        u1, u2 = mul(p[0], z2s), mul(q[0], z1s)
        s1, s2 = mul(p[1], mul(q[2], z2s)), mul(q[1], mul(p[2], z1s))
        h, rr = sub(u2, u1), sub(s2, s1)
        rr = add(rr, rr)
        i = add(h, h)
        i = mul(i, i)
        j, v = mul(h, i), mul(u1, i)
        x3 = sub(sub(mul(rr, rr), j), add(v, v))
        s1j = mul(s1, j)
        y3 = sub(mul(rr, sub(v, x3)), add(s1j, s1j))
        zz = add(p[2], q[2])
        z3 = mul(sub(sub(mul(zz, zz), z1s), z2s), h)
        return (x3, y3, z3)

    @staticmethod
    def g_double(F, p):
        """2p of a point that is not infinity (dbl-2009-l)."""
        add, sub, mul, _ = F
        x, y, z = p
        a, b = mul(x, x), mul(y, y)
        c = mul(b, b)
        xb = add(x, b)
        d = sub(sub(mul(xb, xb), a), c)
        d = add(d, d)
        e = add(add(a, a), a)
        x3 = sub(mul(e, e), add(d, d))
        c8 = add(c, c)
        c8 = add(c8, c8)
        c8 = add(c8, c8)
        yz = mul(y, z)
        return (x3, sub(mul(e, sub(d, x3)), c8), add(yz, yz))

    def g_mul(self, F, p, k: int):
        """k p for 0 < k < r, p a Jacobian point of order r."""
        res = None
        for bit in _bits(k):
            if res is not None:
                res = self.g_double(F, res)
            if bit:
                res = p if res is None else self.g_add(F, res, p)
        return res


def count_work() -> dict:
    """Base-field products of each stage of one pairing, as `Ref` counts them
    (the same for every pair of points that are not infinity)."""
    ref = Ref()
    per_stage = {}
    p = (G1_GEN[0], G1_GEN[1], 1)
    q = (G2_GEN[0], G2_GEN[1], FQ2_ONE)
    ref.pairing(p, q, per_stage)
    return {s: per_stage[s] for s in STAGES}


def fq12_ints(a) -> list:
    """The 12 coefficients of an Fq12 in the limb tensors' order
    (c0/c1, then the Fq6 coefficient, then the Fq2 coefficient)."""
    return [x for f6 in a for f2 in f6 for x in f2]
