"""Whole Fq12 operations: CUDA kernels with their plain versions.

Counterpart of the JAX package's ops/tower_pallas.py.  Four functions —
fq12_mul, fq12_sq, fq12_mul024_pre, fq12_cyclo_sq — each with a wrapper that
sends a CPU tensor to the plain version and a CUDA tensor to its kernel
(csrc/kernel_fq12_*.cu), and `<name>_plain`, the same function in plain
PyTorch.  An Fq12 tensor is (..., 2, 3, 2, 16, B) int32.

The plain versions follow the JAX package's tensor-level formulas: the
independent Fq2 products of a tower operation are stacked along a new leading
axis and go through one Montgomery product.
"""

from __future__ import annotations

import functools

import torch

from . import limbs as lb
from .mont_cuda import (
    _m_limbs,
    _on_card,
    broadcast,
    fq2_mul_plain,
    fq2_xi_plain,
    launch,
)

_FQ12 = (2, 3, 2)


def _c6(a, i):
    return a[..., i, :, :, :]


def _pack6(x0, x1, x2):
    return torch.stack((x0, x1, x2), dim=-4)


def _c12(a, i):
    return a[..., i, :, :, :, :]


def _pack12(x0, x1):
    return torch.stack((x0, x1), dim=-5)


class PlainField:
    """The field operations a tower formula is written on, bound to the plain
    limb engine for one modulus.  fields/tower.py binds the same formulas to
    the dispatching wrappers."""

    def __init__(self, modulus: int):
        m = _m_limbs(modulus)
        self.add = lambda a, b: lb.mod_add(a, b, m)
        self.sub = lambda a, b: lb.mod_sub(a, b, m)
        self.fq2_mul = lambda a, b: fq2_mul_plain(a, b, modulus)
        self.fq2_xi = lambda a: fq2_xi_plain(a, modulus)


_plain_field = functools.lru_cache(maxsize=None)(PlainField)


def fq6_nr(F, a):
    """v * a: rotate components and xi-multiply the wrapped one."""
    return _pack6(F.fq2_xi(_c6(a, 2)), _c6(a, 0), _c6(a, 1))


def fq6_mul(F, a, b):
    """Karatsuba: 6 Fq2 products in one stacked call."""
    a0, a1, a2 = (_c6(a, i) for i in range(3))
    b0, b1, b2 = (_c6(b, i) for i in range(3))
    lhs = torch.stack([a0, a1, a2, F.add(a1, a2), F.add(a0, a1), F.add(a0, a2)])
    rhs = torch.stack([b0, b1, b2, F.add(b1, b2), F.add(b0, b1), F.add(b0, b2)])
    aa, bb, cc, t12, t01, t02 = F.fq2_mul(lhs, rhs)
    r0 = F.add(F.fq2_xi(F.sub(F.sub(t12, bb), cc)), aa)
    r1 = F.add(F.sub(F.sub(t01, aa), bb), F.fq2_xi(cc))
    r2 = F.sub(F.add(F.sub(t02, aa), bb), cc)
    return _pack6(r0, r1, r2)


# ---------------------------------------------------------------------------
# fq12_mul
# ---------------------------------------------------------------------------


def fq12_mul_plain(a, b, modulus: int):
    """Karatsuba: 3 Fq6 products = 54 base-field products."""
    F = _plain_field(modulus)
    a0, a1, b0, b1 = _c12(a, 0), _c12(a, 1), _c12(b, 0), _c12(b, 1)
    aa, bb, cc = fq6_mul(F, torch.stack([a0, a1, F.add(a0, a1)]), torch.stack([b0, b1, F.add(b0, b1)]))
    return _pack12(F.add(fq6_nr(F, bb), aa), F.sub(F.sub(cc, aa), bb))


def fq12_mul(a, b, modulus: int):
    a, b = broadcast(a, b)
    if not _on_card(a, b):
        return fq12_mul_plain(a, b, modulus)
    return launch("fq12_mul", (a, b), (_FQ12, _FQ12), modulus)


# ---------------------------------------------------------------------------
# fq12_sq
# ---------------------------------------------------------------------------


def fq12_sq_plain(a, modulus: int):
    """2 Fq6 products = 36 base-field products."""
    F = _plain_field(modulus)
    a0, a1 = _c12(a, 0), _c12(a, 1)
    ab, t = fq6_mul(
        F,
        torch.stack([a0, F.add(fq6_nr(F, a1), a0)]),
        torch.stack([a1, F.add(a0, a1)]),
    )
    return _pack12(F.sub(F.sub(t, ab), fq6_nr(F, ab)), F.add(ab, ab))


def fq12_sq(a, modulus: int):
    if not _on_card(a):
        return fq12_sq_plain(a, modulus)
    return launch("fq12_sq", (a,), (_FQ12,), modulus)


# ---------------------------------------------------------------------------
# fq12_mul024_pre
# ---------------------------------------------------------------------------


def fq12_mul024_pre_plain(a, ell_0, scaled, modulus: int):
    """Sparse line multiply, 13 Fq2 products = 39 base-field products.
    scaled[..., 0, :, :, :] = ell_vw * g1.y, scaled[..., 1, :, :, :] = ell_vv * g1.x."""
    F = _plain_field(modulus)
    add, sub, xi = F.add, F.sub, F.fq2_xi
    z0, z1, z2 = (_c6(_c12(a, 0), i) for i in range(3))
    z3, z4, z5 = (_c6(_c12(a, 1), i) for i in range(3))
    x0, x4, x2 = ell_0, scaled[..., 0, :, :, :], scaled[..., 1, :, :, :]

    t2a = add(z0, z4)
    t1a = add(z0, z2)
    s0 = add(add(z1, z3), z5)
    x02 = add(x0, x2)
    x24 = add(x2, x4)
    x04 = add(x0, x4)
    x024 = add(x02, x4)
    z24 = add(z2, z4)

    lhs = torch.stack([z0, z2, z4, z1, z5, z1, t1a, z3, z24, z3, z5, t2a, s0])
    rhs = torch.stack([x0, x2, x4, x2, x4, x0, x02, x4, x24, x0, x2, x04, x024])
    (d0, d2, d4, z1x2, z5x4, z1x0, t1t0, z3x4, z24x24, z3x0, z5x2, t2t0, s0t0) = F.fq2_mul(lhs, rhs)

    nz0 = add(xi(add(z1x2, d4)), d0)
    nz1 = add(xi(add(z5x4, d2)), z1x0)
    nz2 = add(sub(sub(t1t0, d0), d2), z3x4)
    nz3 = add(xi(sub(sub(z24x24, d2), d4)), z3x0)
    nz4 = add(xi(z5x2), sub(sub(t2t0, d0), d4))
    s1 = add(add(add(add(add(z1x2, z5x4), z1x0), z3x4), z3x0), z5x2)
    nz5 = sub(s0t0, s1)
    return _pack12(_pack6(nz0, nz1, nz2), _pack6(nz3, nz4, nz5))


def fq12_mul024_pre(a, ell_0, scaled, modulus: int):
    """a: (..., 2, 3, 2, 16, B); ell_0: (..., 2, 16, B); scaled: (..., 2, 2, 16, B)."""
    lead = torch.broadcast_shapes(a.shape[:-5], ell_0.shape[:-3], scaled.shape[:-4])
    a = a.expand(lead + a.shape[-5:])
    ell_0 = ell_0.expand(lead + ell_0.shape[-3:])
    scaled = scaled.expand(lead + scaled.shape[-4:])
    if not _on_card(a, ell_0, scaled):
        return fq12_mul024_pre_plain(a, ell_0, scaled, modulus)
    return launch("fq12_mul024_pre", (a, ell_0, scaled), (_FQ12, (2,), (2, 2)), modulus)


# ---------------------------------------------------------------------------
# fq12_cyclo_sq
# ---------------------------------------------------------------------------


def fq12_cyclo_sq_plain(a, modulus: int):
    """Granger-Scott squaring in the cyclotomic subgroup: 6 Fq2 products."""
    F = _plain_field(modulus)
    add, sub, xi = F.add, F.sub, F.fq2_xi
    z0, z4, z3 = (_c6(_c12(a, 0), i) for i in range(3))
    z2, z1, z5 = (_c6(_c12(a, 1), i) for i in range(3))

    us = torch.stack([z0, z2, z4])
    vs = torch.stack([z1, z3, z5])
    tmp, big = F.fq2_mul(torch.stack([us, add(us, vs)]), torch.stack([vs, add(xi(vs), us)]))
    t_a = sub(sub(big, tmp), xi(tmp))
    t_b = add(tmp, tmp)
    t0, t2, t4 = t_a
    t1, t3, t5 = t_b

    def m3_sub(t, z):  # 3t - 2z
        r = sub(t, z)
        return add(add(r, r), t)

    def m3_add(t, z):  # 3t + 2z
        r = add(t, z)
        return add(add(r, r), t)

    return _pack12(
        _pack6(m3_sub(t0, z0), m3_sub(t2, z4), m3_sub(t4, z3)),
        _pack6(m3_add(xi(t5), z2), m3_add(t1, z1), m3_add(t3, z5)),
    )


def fq12_cyclo_sq(a, modulus: int):
    if not _on_card(a):
        return fq12_cyclo_sq_plain(a, modulus)
    return launch("fq12_cyclo_sq", (a,), (_FQ12,), modulus)
