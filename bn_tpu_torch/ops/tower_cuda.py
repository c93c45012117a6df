"""Whole Fq12 operations and whole precompute steps: CUDA kernels with their
plain versions.

Counterpart of the JAX package's ops/tower_pallas.py.  Nine functions —
fq12_mul, fq12_sq, fq12_mul024, fq12_mul024_pre, fq12_cyclo_sq,
fq12_cyclo_sq_chain, miller_step, double_step, madd_step — each with a
wrapper that sends a CPU tensor to the plain version and a CUDA tensor to its
kernel (csrc/kernel_fq12_*.cu, csrc/kernel_miller_step.cu,
csrc/kernels_g2_step.cu), and `<name>_plain`, the same function in plain
PyTorch.  An Fq12 tensor is (..., 2, 3, 2, 16, B) int32; a point of the
precompute ladder and a step's line coefficients are (..., 3, 2, 16, B), an
affine base point (..., 2, 2, 16, B).

The plain versions follow the JAX package's tensor-level formulas: the
independent Fq2 products of a tower operation are stacked along a new leading
axis and go through one Montgomery product.  Formulas that several functions
share (the Fq12 square, the sparse line multiply, the Miller step, the two
precompute steps) are written once on a field namespace F.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import oracle as O
from .. import params as P
from . import limbs as lb
from .mont_cuda import (
    XI,
    _check_destination,
    _m_limbs,
    _on_card,
    broadcast,
    fq2_mul_plain,
    fq2_xi_plain,
    launch,
    mod_signed_sum_plain,
)

_FQ12 = (2, 3, 2)
_COEFF = (3, 2)  # a step's line coefficients (ell_0, ell_vw, ell_vv)


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
        self.neg = lambda a: lb.mod_neg(a, m)
        self.mul = lambda a, b: lb.mont_mul(a, b, m)
        # operands brought to one shape first, as the wrapper does: the plain
        # product stacks along a new leading axis, which a constant of fewer
        # axes would otherwise be aligned against
        self.fq2_mul = lambda a, b: fq2_mul_plain(*broadcast(a, b), modulus)
        self.fq2_xi = lambda a: fq2_xi_plain(a, modulus)
        self.signed_sum = lambda terms, sources, out=None, fq2=False: mod_signed_sum_plain(
            terms, sources, modulus, out, fq2)


_plain_field = functools.lru_cache(maxsize=None)(PlainField)


def fq6_nr(F, a):
    """v * a: rotate components and xi-multiply the wrapped one."""
    return _pack6(F.fq2_xi(_c6(a, 2)), _c6(a, 0), _c6(a, 1))


# fq6_mul's two levels of signed sums (F.signed_sum, one launch each on the
# card).  The operands' level reads a0 a1 a2 b0 b1 b2 and writes both stacked
# operands of the six Fq2 products; the results' level, an Fq2 level, reads
# the products aa bb cc t12 t01 t02 and writes r0 r1 r2 into the packed
# result, xi's products among its terms.
FQ6_MUL_OPERANDS = (
    ((0, 1),), ((1, 1),), ((2, 1),), ((1, 1), (2, 1)), ((0, 1), (1, 1)), ((0, 1), (2, 1)),
    ((3, 1),), ((4, 1),), ((5, 1),), ((4, 1), (5, 1)), ((3, 1), (4, 1)), ((3, 1), (5, 1)),
)
FQ6_MUL_RESULTS = (
    ((3, 1, XI), (1, -1, XI), (2, -1, XI), (0, 1)),  # r0 = xi t12 - xi bb - xi cc + aa
    ((4, 1), (0, -1), (1, -1), (2, 1, XI)),  # r1 = t01 - aa - bb + xi cc
    ((5, 1), (0, -1), (1, 1), (2, -1)),  # r2 = t02 - aa + bb - cc
)


def fq6_mul(F, a, b):
    """Karatsuba (src/fields/fq6.rs:144-158): 6 Fq2 products in one stacked
    call, between two levels of signed sums."""
    srcs = [_c6(a, i) for i in range(3)] + [_c6(b, i) for i in range(3)]
    operands = F.signed_sum(FQ6_MUL_OPERANDS, srcs)
    prods = F.fq2_mul(operands[:6], operands[6:])  # aa bb cc t12 t01 t02
    shape = prods.shape[1:]
    out = prods.new_empty(shape[:-3] + (3,) + shape[-3:])
    F.signed_sum(FQ6_MUL_RESULTS, prods, out=out.movedim(-4, 0), fq2=True)
    return out


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


def fq12_square(F, a):
    """2 Fq6 products = 36 base-field products."""
    a0, a1 = _c12(a, 0), _c12(a, 1)
    ab, t = fq6_mul(
        F,
        torch.stack([a0, F.add(fq6_nr(F, a1), a0)]),
        torch.stack([a1, F.add(a0, a1)]),
    )
    return _pack12(F.sub(F.sub(t, ab), fq6_nr(F, ab)), F.add(ab, ab))


def fq12_sq_plain(a, modulus: int):
    return fq12_square(_plain_field(modulus), a)


def fq12_sq(a, modulus: int):
    if not _on_card(a):
        return fq12_sq_plain(a, modulus)
    return launch("fq12_sq", (a,), (_FQ12,), modulus)


# ---------------------------------------------------------------------------
# fq12_mul024, fq12_mul024_pre: the sparse line multiply
# ---------------------------------------------------------------------------


def sparse_mul_024(F, a, x0, x2, x4):
    """a * ((x0 + x2 v) + x4 v w), 13 Fq2 products = 39 base-field products
    (src/fields/fq12.rs:107-176).  A line's x2 is ell_vv and x4 is ell_vw,
    each scaled by the G1 point or not."""
    add, sub, xi = F.add, F.sub, F.fq2_xi
    z0, z1, z2 = (_c6(_c12(a, 0), i) for i in range(3))
    z3, z4, z5 = (_c6(_c12(a, 1), i) for i in range(3))

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


def fq12_mul024_plain(a, coeff, modulus: int):
    """coeff[..., k, :, :, :] = (ell_0, ell_vw, ell_vv)[k], unscaled."""
    return sparse_mul_024(_plain_field(modulus), a, _c6(coeff, 0), _c6(coeff, 2), _c6(coeff, 1))


def fq12_mul024(a, coeff, modulus: int):
    """a: (..., 2, 3, 2, 16, B); coeff: (..., 3, 2, 16, B), the line as the
    precompute emits it.  One launch."""
    lead = torch.broadcast_shapes(a.shape[:-5], coeff.shape[:-4])
    a = a.expand(lead + a.shape[-5:])
    coeff = coeff.expand(lead + coeff.shape[-4:])
    if not _on_card(a, coeff):
        return fq12_mul024_plain(a, coeff, modulus)
    return launch("fq12_mul024", (a, coeff), (_FQ12, _COEFF), modulus)


def fq12_mul024_pre_plain(a, ell_0, scaled, modulus: int):
    """scaled[..., 0, :, :, :] = ell_vw * g1.y, scaled[..., 1, :, :, :] = ell_vv * g1.x."""
    return sparse_mul_024(_plain_field(modulus), a, ell_0, _c6(scaled, 1), _c6(scaled, 0))


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


# ---------------------------------------------------------------------------
# fq12_cyclo_sq_chain
# ---------------------------------------------------------------------------


def fq12_cyclo_sq_chain_plain(a, n: int, modulus: int):
    for _ in range(n):
        a = fq12_cyclo_sq_plain(a, modulus)
    return a


def fq12_cyclo_sq_chain(a, n: int, modulus: int):
    """a^(2^n) by n >= 1 cyclotomic squarings; one launch whatever n."""
    if n < 1:
        raise ValueError(f"fq12_cyclo_sq_chain: n must be at least 1, got {n}")
    if not _on_card(a):
        return fq12_cyclo_sq_chain_plain(a, n, modulus)
    return launch("fq12_cyclo_sq_chain", (a,), (_FQ12,), modulus, extra=(n,))


# ---------------------------------------------------------------------------
# double_step, madd_step: the steps of the G2 line-coefficient precompute
# ---------------------------------------------------------------------------

_G2 = (3, 2)
_BASE = (2, 2)


@functools.lru_cache(maxsize=None)
def _step_const_monts():
    """1/2 and the two coefficients of the twist's b, as Montgomery-form ints
    derived from params and the oracle."""
    return tuple(P.to_mont(v % P.Q, P.Q) for v in (P.TWO_INV, *O.twist_b()))


@functools.lru_cache(maxsize=None)
def step_consts(device_str: str):
    """(1/2 as (16, 1), the twist's b as (2, 16, 1)) limb tensors on a device."""
    two_inv, b0, b1 = (lb.const(P.int_to_limbs(v), torch.device(device_str)) for v in _step_const_monts())
    return two_inv, torch.stack([b0, b1])


@functools.lru_cache(maxsize=None)
def _step_const_args():
    """double_step's own argument: the twist's b as the 32-bit words the
    kernel takes by value (it halves where the formula multiplies by 1/2)."""
    b0, b1 = (P.int_to_words(v) for v in _step_const_monts()[1:])
    return ((ctypes.c_uint32 * (2 * P.NWORDS))(*b0, *b1),)


def _mul3(F, a):
    return F.add(F.add(a, a), a)


def g2_double_step(F, r, two_inv, twist_b):
    """The doubling step (src/groups/mod.rs:612-634) on the field namespace F:
    r = (x, y, z) Fq2 tensors -> ((x', y', z'), coefficients (3, ..., 2, 16, B)).
    Independent Fq2 products are stacked into one F.fq2_mul call."""
    x, y, z = r
    yz = F.add(y, z)
    xy, b, c, j, yz_sq = F.fq2_mul(torch.stack([x, y, z, x, yz]), torch.stack([y, y, z, x, yz]))
    e = F.fq2_mul(_mul3(F, c), twist_b)
    f = _mul3(F, e)
    a, g = F.mul(torch.stack([xy, F.add(b, f)]), two_inv)
    h = F.sub(yz_sq, F.add(b, c))
    g_sq, e_sq, nx, nz = F.fq2_mul(torch.stack([g, e, a, b]), torch.stack([g, e, F.sub(b, f), h]))
    ny = F.sub(g_sq, _mul3(F, e_sq))
    ell_0 = F.fq2_xi(F.sub(e, b))
    return (nx, ny, nz), torch.stack([ell_0, F.neg(h), _mul3(F, j)])


def g2_madd_step(F, r, base):
    """The mixed-addition step (src/groups/mod.rs:591-610) on the field
    namespace F, with the affine base point (bx, by).  Its ell_vw / ell_vv are
    (d, -e) where the doubling step's are (-h, 3j)."""
    x, y, z = r
    bx, by = base
    zbx, zby = F.fq2_mul(torch.stack([z, z]), torch.stack([bx, by]))
    d = F.sub(x, zbx)
    e = F.sub(y, zby)
    de = torch.stack([d, e])
    f, g = F.fq2_mul(de, de)
    h, i, zg = F.fq2_mul(torch.stack([d, x, z]), torch.stack([f, f, g]))
    j = F.sub(F.add(zg, h), F.add(i, i))
    nx, ny_a, hy, nz, ebx, dby = F.fq2_mul(
        torch.stack([d, e, h, z, e, d]), torch.stack([j, F.sub(i, j), y, h, bx, by])
    )
    ell_0 = F.fq2_xi(F.sub(ebx, dby))
    return (nx, F.sub(ny_a, hy), nz), torch.stack([ell_0, d, F.neg(e)])


def _emit(name, r_new, coeffs, r_out, coeffs_out, r):
    """Hand a plain step's results out in the kernels' layout, through the
    caller's destinations where it named them."""
    results = []
    for val, dst in ((torch.stack(r_new, dim=-4), r_out), (torch.movedim(coeffs, 0, -4), coeffs_out)):
        if dst is None:
            results.append(val.contiguous())
        else:
            results.append(_check_destination(name, dst, val.shape, (r,)).copy_(val))
    return tuple(results)


def double_step_plain(r, r_out=None, coeffs_out=None):
    two_inv, twist_b = step_consts(str(r.device))
    r_new, coeffs = g2_double_step(_plain_field(P.Q), tuple(_c6(r, i) for i in range(3)), two_inv, twist_b)
    return _emit("double_step", r_new, coeffs, r_out, coeffs_out, r)


def double_step(r, r_out=None, coeffs_out=None):
    """One doubling step of the precompute ladder over Fq2: r (..., 3, 2, 16, B)
    -> (2r, (ell_0, ell_vw, ell_vv)), both (..., 3, 2, 16, B).  `r_out` and
    `coeffs_out` name where to write them (neither may be `r`); without them
    the results are new tensors.  One launch."""
    if not _on_card(r):
        return double_step_plain(r, r_out, coeffs_out)
    return launch("double_step", (r,), (_G2,), P.Q, extra=_step_const_args(),
                  out_structs=(_G2, _G2), outs=(r_out, coeffs_out))


def madd_step_plain(r, base, r_out=None, coeffs_out=None):
    r_new, coeffs = g2_madd_step(
        _plain_field(P.Q), tuple(_c6(r, i) for i in range(3)), (_c6(base, 0), _c6(base, 1))
    )
    return _emit("madd_step", r_new, coeffs, r_out, coeffs_out, r)


def madd_step(r, base, r_out=None, coeffs_out=None):
    """One mixed-addition step of the precompute ladder: r (..., 3, 2, 16, B)
    plus the affine base (..., 2, 2, 16, B) -> (r + base, coefficients).
    Destinations as for double_step.  One launch."""
    if not _on_card(r, base):
        return madd_step_plain(r, base, r_out, coeffs_out)
    return launch("madd_step", (r, base), (_G2, _BASE), P.Q, out_structs=(_G2, _G2), outs=(r_out, coeffs_out))


# ---------------------------------------------------------------------------
# miller_step: one step of the Miller loop
# ---------------------------------------------------------------------------


def miller_step_on(F, f, coeff, px, py, square: bool):
    """One step of the Miller loop (src/groups/mod.rs:494-509) on the field
    namespace F: f^2 on a doubling step (`square`), then the line evaluated at
    the affine G1 point, ell_vw scaled by py and ell_vv by px, multiplied in
    sparsely.  79 base-field products with the square, 43 without."""
    if square:
        f = fq12_square(F, f)
    vw, vv = F.mul(*broadcast(torch.stack([_c6(coeff, 1), _c6(coeff, 2)]), torch.stack([py, px])[..., None, :, :]))
    return sparse_mul_024(F, f, _c6(coeff, 0), vv, vw)


def miller_step_plain(f, coeff, px, py, square: bool, out=None):
    val = miller_step_on(_plain_field(P.Q), f, coeff, px, py, square)
    if out is None:
        return val
    return _check_destination("miller_step", out, val.shape, (f, coeff, px, py)).copy_(val)


def miller_step(f, coeff, px, py, square: bool, out=None):
    """f (..., 2, 3, 2, 16, B), the step's line coefficients coeff
    (..., 3, 2, 16, B) as the precompute emits them (unscaled), the affine G1
    point px, py (..., 16, B) -> f^2 * line (square=True, a doubling step) or
    f * line.  `out` names where to write the result (not an operand); without
    it the result is a new tensor.  One launch."""
    lead = torch.broadcast_shapes(f.shape[:-5], coeff.shape[:-4], px.shape[:-2], py.shape[:-2])
    f = f.expand(lead + f.shape[-5:])
    coeff = coeff.expand(lead + coeff.shape[-4:])
    px, py = (t.expand(lead + t.shape[-2:]) for t in (px, py))
    if not _on_card(f, coeff, px, py):
        return miller_step_plain(f, coeff, px, py, square, out)
    return launch("miller_step", (f, coeff, px, py), (_FQ12, _COEFF, (), ()), P.Q, extra=(int(square),),
                  out_structs=(_FQ12,), outs=(out,), instance="square" if square else "no_square")[0]
