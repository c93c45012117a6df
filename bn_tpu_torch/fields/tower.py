"""The Fq2 / Fq6 / Fq12 extension tower over batched limb tensors.

Counterpart of the JAX package's fields/tower.py.  Tensor layout (structure
axes lead, batch axis last):
    Fq   : (..., L, B)
    Fq2  : (..., 2, L, B)      Fq2  = Fq[u]/(u^2+1)
    Fq6  : (..., 3, 2, L, B)   Fq6  = Fq2[v]/(v^3-xi), xi = 9+u
    Fq12 : (..., 2, 3, 2, L, B) Fq12 = Fq6[w]/(w^2-v)

fq2_mul, fq2_sq, fq2_mul_by_xi, fq12_mul, fq12_sq, fq12_mul_by_024,
fq12_mul_by_024_prescaled, fq12_cyclotomic_sq and a run of cyclotomic
squarings are one kernel each on the card (ops/mont_cuda.py,
ops/tower_cuda.py).  The rest (Fq6 products, inversions, Frobenius) stack
their independent Fq2 products along a new leading axis and send them
through one fq2_mul call, and do their sums, differences, negations,
conjugations and products by xi a level at a time: one `mod_signed_sum`
launch a level (its Fq2 form where xi is among the terms), which
writes its results into the stacked operand or the packed element that reads
them.  Formulas mirror the reference crate (src/fields/fq2.rs, fq6.rs,
fq12.rs), which pin the golden vectors; addition and negation work on whole
tower tensors at once.
"""

from __future__ import annotations

import functools
import types

import numpy as np
import torch

from .. import oracle as O
from .. import params as P
from ..ops import backend
from ..ops import limbs as lb
from ..ops import mont_cuda as mc
from ..ops import tower_cuda as tc
from . import fp

FQ = fp.FQ
XI = mc.XI  # a xi term of an Fq2 level of signed sums

# ---------------------------------------------------------------------------
# packing / component access
# ---------------------------------------------------------------------------


def c2(a, i):
    return a[..., i, :, :]


def pack2(x0, x1):
    return torch.stack((x0, x1), dim=-3)


def c6(a, i):
    return a[..., i, :, :, :]


def pack6(x0, x1, x2):
    return torch.stack((x0, x1, x2), dim=-4)


def c12(a, i):
    return a[..., i, :, :, :, :]


def pack12(x0, x1):
    return torch.stack((x0, x1), dim=-5)


# generic (tower-shape-agnostic) linear ops
def add(a, b):
    return fp.add(FQ, a, b)


def sub(a, b):
    return fp.sub(FQ, a, b)


def neg(a):
    return fp.neg(FQ, a)


def double(a):
    return fp.add(FQ, a, a)


# ---------------------------------------------------------------------------
# constants (Montgomery form, broadcastable, cached per device)
# ---------------------------------------------------------------------------


def _fq_const(v: int) -> np.ndarray:
    return P.int_to_limbs(P.to_mont(v % P.Q, P.Q)).reshape(P.NLIMBS, 1)


def _fq2_const(t) -> np.ndarray:
    return np.stack([_fq_const(t[0]), _fq_const(t[1])])  # (2, L, 1)


@functools.lru_cache(maxsize=None)
def _frob_consts():
    """Montgomery-form Frobenius gamma tables, derived in oracle.frob_coeffs:
    (2, L, 1) numpy constants for fq2_mul_const."""
    fq6_c1, fq6_c2, fq12_c1 = O.frob_coeffs()
    return (
        tuple(_fq2_const(t) for t in fq6_c1),
        tuple(_fq2_const(t) for t in fq6_c2),
        tuple(_fq2_const(t) for t in fq12_c1),
    )


def zeros2(batch_shape, device=None):
    return fp.zeros(FQ, tuple(batch_shape[:-1]) + (2, batch_shape[-1]), device)


def ones2(batch_shape, device=None):
    return pack2(fp.ones(FQ, batch_shape, device), fp.zeros(FQ, batch_shape, device))


def ones6(batch_shape, device=None):
    return pack6(ones2(batch_shape, device), zeros2(batch_shape, device), zeros2(batch_shape, device))


def ones12(batch_shape, device=None):
    z6 = fp.zeros(FQ, tuple(batch_shape[:-1]) + (3, 2, batch_shape[-1]), device)
    return pack12(ones6(batch_shape, device), z6)


def zeros12(batch_shape, device=None):
    return fp.zeros(FQ, tuple(batch_shape[:-1]) + (2, 3, 2, batch_shape[-1]), device)


# ---------------------------------------------------------------------------
# Fq2   (reference: src/fields/fq2.rs)
# ---------------------------------------------------------------------------


def fq2_mul(a, b):
    """Karatsuba, 3 Fq products (src/fields/fq2.rs:139-155); one kernel."""
    return mc.fq2_mul(a, b, P.Q)


def fq2_sq(a):
    """Complex squaring (src/fields/fq2.rs:112-123); one kernel."""
    return mc.fq2_sq(a, P.Q)


def fq2_scale_fq(a, k):
    """Multiply both components by an Fq element k (one stacked mul)."""
    kb = k[..., None, :, :] if k.dim() < a.dim() else k
    return fp.mul(FQ, a, kb)


def fq2_mul_by_xi(a):
    """Multiply by xi = 9 + u without a product; one kernel."""
    return mc.fq2_xi(a, P.Q)


# (x0, -x1): a conjugation, and the sign of a half of an Fq12
CONJ = (((0, 1),), ((1, -1),))


def fq2_mul_const(a, const_np):
    """Multiply by a static Fq2 constant, a Montgomery-form (2, L, 1) numpy
    array: the constant is moved to a's device once (ops/limbs.py's cache),
    then one fq2_mul."""
    return fq2_mul(a, lb.const(const_np, a.device).view(2, P.NLIMBS, 1))


def _negate_second(x0, x1, axis: int):
    """(x0, -x1) packed along `axis` of a new tensor: one signed-sum launch."""
    out = x0.new_empty(x0.shape[: x0.dim() + axis + 1] + (2,) + x0.shape[x0.dim() + axis + 1 :])
    mc.mod_signed_sum(CONJ, (x0, x1), P.Q, out=out.movedim(axis, 0))
    return out


def fq2_conj(a):
    """The conjugate of every Fq2 coefficient of a: of an Fq2, an Fq6 or an
    Fq12 alike, in one launch."""
    return _negate_second(a.select(-3, 0), a.select(-3, 1), -3)


def fq2_frob(a, power: int):
    """x -> x^(q^power) on every Fq2 coefficient of a."""
    return a if power % 2 == 0 else fq2_conj(a)


def fq2_inv(a):
    """Algorithm 8 (src/fields/fq2.rs:125-136); one Fermat chain."""
    sq = fp.mul(FQ, a, a)  # a0^2, a1^2
    t = fp.inv(FQ, fp.add(FQ, c2(sq, 0), c2(sq, 1)))
    p = fp.mul(FQ, a, t[..., None, :, :])  # a0 t, a1 t
    return _negate_second(c2(p, 0), c2(p, 1), -3)


# ---------------------------------------------------------------------------
# Fq6   (reference: src/fields/fq6.rs)
# ---------------------------------------------------------------------------

# the field the shared formulas of ops/tower_cuda.py (Fq6 product, precompute
# steps) run on here: the dispatching wrappers
_F = types.SimpleNamespace(
    add=add, sub=sub, neg=neg, mul=lambda a, b: fp.mul(FQ, a, b), fq2_mul=fq2_mul, fq2_xi=fq2_mul_by_xi,
    signed_sum=lambda terms, sources, out=None, fq2=False: mc.mod_signed_sum(terms, sources, P.Q, out, fq2),
)


def fq6_mul_by_nonresidue(a):
    """v * a (src/fields/fq6.rs:59-65)."""
    return tc.fq6_nr(_F, a)


def fq6_mul(a, b):
    """Karatsuba: 6 Fq2 products, one stacked fq2_mul (src/fields/fq6.rs:144-158)."""
    return tc.fq6_mul(_F, a, b)


# fq6_sq's levels of signed sums.  The first reads a0 a1 a2 and writes both
# stacked operands of the five products (a0 a0, a0 a1, d d, a1 a2, a2 a2 with
# d = a0 - a1 + a2); the second reads the products s0 ab s2 bc s4 and writes
# r0 = s0 + xi s3, r1 = s1 + xi s4 (s1 = ab + ab, s3 = bc + bc) and
# s1 + s3; the third adds s2 - s0 - s4 to that: r2 = s1 + s2 + s3 - s0 - s4
# has seven terms, and a level takes four an output.
_FQ6_SQ_D = ((0, 1), (1, -1), (2, 1))  # d = a0 - a1 + a2
FQ6_SQ_OPERANDS = (((0, 1),), ((0, 1),), _FQ6_SQ_D, ((1, 1),), ((2, 1),), ((0, 1),), ((1, 1),), _FQ6_SQ_D, ((2, 1),), ((2, 1),))
FQ6_SQ_RESULTS = (((0, 1), (3, 1, XI), (3, 1, XI)), ((1, 1), (1, 1), (4, 1, XI)), ((1, 1), (1, 1), (3, 1), (3, 1)))
FQ6_SQ_LAST = (((0, 1), (1, 1), (2, -1), (3, -1)),)


def fq6_sq(a):
    """CH-SQR2 (src/fields/fq6.rs:113-127): 5 Fq2 products, one stacked
    fq2_mul, between three levels of signed sums."""
    operands = mc.mod_signed_sum(FQ6_SQ_OPERANDS, [c6(a, i) for i in range(3)], P.Q)
    p = fq2_mul(operands[:5], operands[5:])  # s0 ab s2 bc s4
    out = p.new_empty(p.shape[1:-3] + (3,) + p.shape[-3:])
    r = out.movedim(-4, 0)
    s13 = torch.empty_like(p[0])
    mc.mod_signed_sum(FQ6_SQ_RESULTS, p.unbind(0), P.Q, out=(r[0], r[1], s13), fq2=True)
    mc.mod_signed_sum(FQ6_SQ_LAST, (s13, p[2], p[0], p[4]), P.Q, out=r[2:], fq2=True)
    return out


def fq6_scale_fq2(a, k):
    """Multiply all three Fq2 components of a by the Fq2 element k: one
    stacked fq2_mul."""
    return fq2_mul(a, k.unsqueeze(-4))


def fq6_neg(a):
    return neg(a)


# fq6_inv's three levels of signed sums, Fq2 levels.  The first reads a0 a1
# a2 and writes both stacked operands of the six products (copies, and xi a2);
# the second reads the products s_a0 a1xa2 s_a2 a0a1 s_a1 a0a2 and writes
# (k0, k2, k1), the partners of (a0, a1, a2), then (k0, k1, k2); the third
# reads a0 k0, a1 k2, a2 k1 and writes the norm.
FQ6_INV_OPERANDS = tuple(((i, 1),) for i in (0, 1, 2, 0, 1, 0, 0)) + (((2, 1, XI),),) + tuple(((i, 1),) for i in (2, 1, 1, 2))
_K0, _K1, _K2 = ((0, 1), (1, -1)), ((2, 1, XI), (3, -1)), ((4, 1), (5, -1))
FQ6_INV_NORM_FACTORS = (_K0, _K2, _K1, _K0, _K1, _K2)
FQ6_INV_NORM = (((2, 1, XI), (1, 1, XI), (0, 1)),)


def fq6_inv(a):
    """Norm-based inversion (src/fields/fq6.rs:129-141): k0 = a0^2 - xi a1 a2,
    k1 = xi a2^2 - a0 a1, k2 = a1^2 - a0 a2, norm = xi (a2 k1 + a1 k2) + a0 k0,
    a^-1 = (k0, k1, k2) / norm."""
    operands = mc.mod_signed_sum(FQ6_INV_OPERANDS, [c6(a, i) for i in range(3)], P.Q, fq2=True)
    prods = fq2_mul(operands[:6], operands[6:])
    ks = mc.mod_signed_sum(FQ6_INV_NORM_FACTORS, prods.unbind(0), P.Q, fq2=True)
    p = fq2_mul(a.movedim(-4, 0), ks[:3])  # a0 k0, a1 k2, a2 k1
    (norm,) = mc.mod_signed_sum(FQ6_INV_NORM, p.unbind(0), P.Q, fq2=True)
    t = fq2_inv(norm)
    return fq2_mul(t[None], ks[3:]).movedim(0, -4).contiguous()


def _fq6_frob_coeffs(x, power: int):
    """The Frobenius map's constant products on an Fq6 whose Fq2
    coefficients are already raised to q^power."""
    c1t, c2t, _ = _frob_consts()
    return pack6(c6(x, 0), fq2_mul_const(c6(x, 1), c1t[power % 6]), fq2_mul_const(c6(x, 2), c2t[power % 6]))


def fq6_frob(a, power: int):
    """(src/fields/fq6.rs:75-81)"""
    return _fq6_frob_coeffs(fq2_frob(a, power), power)


# ---------------------------------------------------------------------------
# Fq12   (reference: src/fields/fq12.rs)
# ---------------------------------------------------------------------------


def fq12_mul(a, b):
    """Karatsuba, 54 Fq products (src/fields/fq12.rs:295-307); one kernel."""
    return tc.fq12_mul(a, b, P.Q)


def fq12_sq(a):
    """36 Fq products (src/fields/fq12.rs:275-282); one kernel."""
    return tc.fq12_sq(a, P.Q)


# p0 - v p1 for Fq6 elements p0, p1, v p1 = (xi p1_2, p1_0, p1_1), an Fq2
# level from the sources p0_0 p0_1 p0_2 p1_0 p1_1 p1_2
FQ6_SUB_NONRESIDUE = (((0, 1), (5, -1, XI)), ((1, 1), (3, -1)), ((2, 1), (4, -1)))


def fq12_inv(a):
    """(src/fields/fq12.rs:284-292): t = (a0^2 - v a1^2)^-1, a^-1 = (a0 t, -a1 t)."""
    both = a.movedim(-5, 0)  # (a0, a1) stacked, a view
    p = fq6_mul(both, both)
    d = p.new_empty(p.shape[1:])
    srcs = [c6(p[k], i) for k in range(2) for i in range(3)]
    mc.mod_signed_sum(FQ6_SUB_NONRESIDUE, srcs, P.Q, out=d.movedim(-4, 0), fq2=True)
    p = fq6_mul(both, fq6_inv(d)[None])
    return _negate_second(p[0], p[1], -5)


def fq12_conj(a):
    """Unitary inverse (src/fields/fq12.rs:103-105); one launch."""
    return _negate_second(c12(a, 0), c12(a, 1), -5)


def fq12_frob(a, power: int):
    """(src/fields/fq12.rs:90-95).  For an odd power every Fq2 coefficient
    is conjugated first, in one launch over the whole element."""
    _, _, c12t = _frob_consts()
    x = fq2_frob(a, power)
    x0 = _fq6_frob_coeffs(c12(x, 0), power)
    # scale all three Fq2 components of x1 by the gamma constant
    x1 = fq2_mul_const(_fq6_frob_coeffs(c12(x, 1), power), c12t[power % 12])
    return pack12(x0, x1)


def fq12_mul_by_024(a, ell_0, ell_vw, ell_vv):
    """Sparse line multiply (src/fields/fq12.rs:107-176) by the line
    (ell_0, ell_vw, ell_vv), each (..., 2, L, B): the three are stacked into
    one (..., 3, 2, L, B) struct; one kernel."""
    coeff = torch.stack(mc.broadcast(ell_0, ell_vw, ell_vv), dim=-4)
    return tc.fq12_mul024(a, coeff, P.Q)


def fq12_mul_by_024_prescaled(a, ell_0, scaled):
    """Sparse line multiply (src/fields/fq12.rs:107-176) taking the G1-scaled
    pair as one (2, 2, L, B) tensor (scaled[0] = ell_vw*y, scaled[1] =
    ell_vv*x); one kernel."""
    return tc.fq12_mul024_pre(a, ell_0, scaled, P.Q)


def fq12_cyclotomic_sq(a):
    """Granger-Scott (src/fields/fq12.rs:178-227); one kernel."""
    return tc.fq12_cyclo_sq(a, P.Q)


@functools.lru_cache(maxsize=None)
def _z_naf():
    """Non-adjacent form of the BN parameter z, MSB first: 63 digits,
    24 nonzero (vs 28 set bits in binary) — each -1 costs only a free
    conjugate for cyclotomic-subgroup elements."""
    n = P.Z_BN
    naf = []
    while n:
        if n & 1:
            d = 2 - (n % 4)
            naf.append(d)
            n -= d
        else:
            naf.append(0)
        n >>= 1
    return tuple(reversed(naf))


def _cyclo_sq_run(res, n: int):
    """n successive cyclotomic squarings: one `fq12_cyclo_sq_chain` kernel for
    a run of two or more with the `cyclo_chain` switch of ops/backend.py on
    (the default), else one `fq12_cyclo_sq` call each."""
    if backend.cyclo_chain and n >= 2:
        return tc.fq12_cyclo_sq_chain(res, n, P.Q)
    for _ in range(n):
        res = fq12_cyclotomic_sq(res)
    return res


def fq12_cyclotomic_pow_z(a):
    """a^z for the BN parameter z, for a in the cyclotomic subgroup (as the
    final exponentiation's hard part gives it): a NAF ladder whose -1 digits
    multiply by a^-1 = conj(a), which holds in that subgroup only.  Equal
    there to the reference's binary ladder (src/fields/fq12.rs:229-246), which
    squares with the cyclotomic squaring and so is bound to the same domain."""
    naf = _z_naf()
    a_conj = fq12_conj(a)
    assert naf[0] == 1
    res = a
    pending = 0
    for d in naf[1:]:
        pending += 1
        if d:
            res = _cyclo_sq_run(res, pending)
            pending = 0
            res = fq12_mul(res, a if d == 1 else a_conj)
    if pending:
        res = _cyclo_sq_run(res, pending)
    return res


def fq12_exp_by_neg_z(a):
    """a^-z for a in the cyclotomic subgroup (src/fields/fq12.rs:97-101):
    the conjugate of fq12_cyclotomic_pow_z."""
    return fq12_conj(fq12_cyclotomic_pow_z(a))


def final_exponentiation(f):
    """Easy chunk + Fuentes-et-al. hard chunk, straight line
    (src/fields/fq12.rs:41-88): every Fq12 operation below is one kernel."""
    binv = fq12_inv(f)
    # easy chunk (fq12.rs:41-52)
    a = fq12_conj(f)
    c = fq12_mul(a, binv)
    d = fq12_frob(c, 2)
    s = fq12_mul(d, c)
    # hard chunk: the reference's a..v chain (fq12.rs:54-84).  All inputs
    # to exp_by_neg_z here are cyclotomic (s = (f^(q^6-1))^(q^2+1) and its
    # cyclotomic closures), so the NAF ladder's conj-as-inverse is valid.
    a2 = fq12_exp_by_neg_z(s)
    b2 = fq12_cyclotomic_sq(a2)
    c2_ = fq12_cyclotomic_sq(b2)
    d2 = fq12_mul(c2_, b2)
    e2 = fq12_exp_by_neg_z(d2)
    f2 = fq12_cyclotomic_sq(e2)
    g2 = fq12_exp_by_neg_z(f2)
    h2 = fq12_conj(d2)
    i2 = fq12_conj(g2)
    j2 = fq12_mul(i2, e2)
    k2 = fq12_mul(j2, h2)
    l2 = fq12_mul(k2, b2)
    m2 = fq12_mul(k2, e2)
    n2 = fq12_mul(s, m2)
    o2 = fq12_frob(l2, 1)
    p2 = fq12_mul(o2, n2)
    q2 = fq12_frob(k2, 2)
    r2 = fq12_mul(q2, p2)
    s2_ = fq12_conj(s)
    t2 = fq12_mul(s2_, l2)
    u2 = fq12_frob(t2, 3)
    return fq12_mul(u2, r2)


def fq12_pow_fr(a, scalar_bits):
    """a^e for 256 exponent bits (..., 256, B), MSB first, on a's device: a
    branchless square-and-multiply ladder, one `fq12_sq` and one `fq12_mul`
    kernel a bit (replaces the reference's FieldElement::pow,
    src/fields/mod.rs:35-46)."""
    res = ones12(a.shape[:-5] + a.shape[-1:], a.device)
    for bit in torch.movedim(scalar_bits, -2, 0):
        res = fq12_sq(res)
        res = torch.where((bit != 0)[..., None, None, None, None, :], fq12_mul(res, a), res)
    return res


# ---------------------------------------------------------------------------
# host <-> device conversion for tower elements
# ---------------------------------------------------------------------------


def fq2_to_device(vals, device=None):
    """vals: list of oracle Fq2 tuples -> (2, L, B)."""
    return torch.stack(
        [
            fp.to_device(FQ, [v[0] for v in vals], device),
            fp.to_device(FQ, [v[1] for v in vals], device),
        ]
    )


def _np(arr):
    return arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)


def fq2_from_device(arr):
    arr = _np(arr)
    c0s = fp.from_device(FQ, arr[..., 0, :, :].reshape(P.NLIMBS, -1))
    c1s = fp.from_device(FQ, arr[..., 1, :, :].reshape(P.NLIMBS, -1))
    return list(zip(c0s, c1s))


def fq6_to_device(vals, device=None):
    return torch.stack([fq2_to_device([v[i] for v in vals], device) for i in range(3)])


def fq12_to_device(vals, device=None):
    return torch.stack([fq6_to_device([v[i] for v in vals], device) for i in range(2)])


def fq12_from_device(arr):
    arr = _np(arr)
    out = []
    for b in range(arr.shape[-1]):
        el = tuple(
            tuple(
                (
                    P.from_mont(P.limbs_to_int(arr[i, j, 0, :, b]), P.Q),
                    P.from_mont(P.limbs_to_int(arr[i, j, 1, :, b]), P.Q),
                )
                for j in range(3)
            )
            for i in range(2)
        )
        out.append(el)
    return out
