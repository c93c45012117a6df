"""G1/G2 Jacobian curve groups over batched limb tensors, fully branchless.

Counterpart of the JAX package's curve.py.  The reference's generic `G<P>`
(src/groups/mod.rs:27-46) instantiates one set of Jacobian formulas over Fq
(G1) and Fq2 (G2); here duck-typed base-field *views* (FqView / Fq2View)
expose a uniform tensor op API, and points are (x, y, z) tuples of base
tensors with batch axis last.

Every data-dependent branch of the reference — infinity passthrough, the
add-equals-double case (src/groups/mod.rs:276-295), the scalar ladder's
found_one skip (src/groups/mod.rs:250-270) — is a mask and a select.  The
infinity convention (0, 1, 0) matches test_y_at_point_at_infinity
(src/groups/mod.rs:825-832).  add and double are one kernel each on the card
(ops/curve_cuda.py) unless the `curve_kernels` switch of ops/backend.py is
off; then the same two formulas run per field operation on the views below,
each operation one kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from . import oracle as O
from . import params as P
from .fields import fp, tower
from .ops import backend
from .ops import curve_cuda as cc
from .ops import limbs as lb

# ---------------------------------------------------------------------------
# base-field views
# ---------------------------------------------------------------------------


class FqView:
    """Fq tensor ops: shapes (..., L, B), masks (..., B)."""

    struct_ndim = 0  # structure axes between batch dims and (L, B)

    @staticmethod
    def add(a, b):
        return fp.add(fp.FQ, a, b)

    @staticmethod
    def sub(a, b):
        return fp.sub(fp.FQ, a, b)

    @staticmethod
    def neg(a):
        return fp.neg(fp.FQ, a)

    @staticmethod
    def mul(a, b):
        return fp.mul(fp.FQ, a, b)

    @staticmethod
    def mul_many(pairs):
        return fp.mul_many(fp.FQ, pairs)

    @staticmethod
    def sq(a):
        return fp.sqr(fp.FQ, a)

    @staticmethod
    def inv(a):
        return fp.inv(fp.FQ, a)

    is_zero = staticmethod(lb.is_zero)
    eq = staticmethod(lb.eq)

    @staticmethod
    def zeros(batch_shape, device=None):
        return fp.zeros(fp.FQ, batch_shape, device)

    @staticmethod
    def ones(batch_shape, device=None):
        return fp.ones(fp.FQ, batch_shape, device)

    select = staticmethod(lb.select)

    @staticmethod
    def to_device(vals, device=None):
        return fp.to_device(fp.FQ, vals, device)

    @staticmethod
    def from_device(arr):
        return fp.from_device(fp.FQ, arr)


class Fq2View:
    """Fq2 tensor ops: shapes (..., 2, L, B), masks (..., B)."""

    struct_ndim = 1

    add = staticmethod(tower.add)
    sub = staticmethod(tower.sub)
    neg = staticmethod(tower.neg)
    mul = staticmethod(tower.fq2_mul)
    sq = staticmethod(tower.fq2_sq)
    inv = staticmethod(tower.fq2_inv)
    zeros = staticmethod(tower.zeros2)
    ones = staticmethod(tower.ones2)
    to_device = staticmethod(tower.fq2_to_device)
    from_device = staticmethod(tower.fq2_from_device)

    @staticmethod
    def mul_many(pairs):
        res = tower.fq2_mul(torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs]))
        return list(res)

    is_zero = staticmethod(cc.fq2_is_zero)
    eq = staticmethod(cc.fq2_eq)
    select = staticmethod(cc.fq2_select)


# ---------------------------------------------------------------------------
# curve specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CurveSpec:
    name: str
    field: Any
    b_np: np.ndarray  # broadcastable Montgomery constant (host)
    gen_affine: tuple  # host-side oracle affine point

    def b_const(self, device) -> torch.Tensor:
        """The curve coefficient b on `device` (cached per device)."""
        return _b_const(self.name, str(device))


@functools.lru_cache(maxsize=None)
def _b_const(name: str, device_str: str):
    spec = g1_spec() if name == "G1" else g2_spec()
    return torch.from_numpy(spec.b_np.astype(np.int32)).to(torch.device(device_str))


@functools.lru_cache(maxsize=None)
def g1_spec() -> CurveSpec:
    return CurveSpec("G1", FqView, tower._fq_const(P.B_COEFF), O.G1_ONE[:2])


@functools.lru_cache(maxsize=None)
def g2_spec() -> CurveSpec:
    return CurveSpec("G2", Fq2View, tower._fq2_const(O.twist_b()), (O.G2_GEN_X, O.G2_GEN_Y))


# ---------------------------------------------------------------------------
# group law (branchless)
# ---------------------------------------------------------------------------


def _batch_shape(spec: CurveSpec, x):
    return tuple(x.shape[: x.dim() - 2 - spec.field.struct_ndim]) + (x.shape[-1],)


def zero(spec: CurveSpec, batch_shape, device=None):
    """Point at infinity (0, 1, 0) (src/groups/mod.rs:208-214)."""
    F = spec.field
    return (F.zeros(batch_shape, device), F.ones(batch_shape, device), F.zeros(batch_shape, device))


def one(spec: CurveSpec, batch_shape, device=None):
    """The generator, broadcast over the batch."""
    F = spec.field
    x = F.to_device([spec.gen_affine[0]], device).expand(*([-1] * (F.struct_ndim + 1)), batch_shape[-1])
    y = F.to_device([spec.gen_affine[1]], device).expand(*([-1] * (F.struct_ndim + 1)), batch_shape[-1])
    return (x.contiguous(), y.contiguous(), F.ones(batch_shape, device))


def is_zero(spec: CurveSpec, p):
    return spec.field.is_zero(p[2])


def double(spec: CurveSpec, p):
    """dbl-2009-l (src/groups/mod.rs:228-247), safe at infinity: one
    `point_double` kernel, or the formula per field operation."""
    if backend.curve_kernels:
        return cc.point_double(spec.name, p)
    return cc.jac_double(spec.field, p)


def add(spec: CurveSpec, p, q):
    """2007-bl Jacobian add with branchless degenerate handling
    (src/groups/mod.rs:272-312): one `point_add` kernel, or the formula per
    field operation."""
    if backend.curve_kernels:
        return cc.point_add(spec.name, p, q)
    return cc.jac_add(spec.field, p, q)


def neg(spec: CurveSpec, p):
    """(src/groups/mod.rs:314-328); negating infinity keeps y = 1."""
    F = spec.field
    inf = is_zero(spec, p)
    return (p[0], F.select(inf, p[1], F.neg(p[1])), p[2])


def eq(spec: CurveSpec, p, q):
    """Cross-multiplied Jacobian equality (src/groups/mod.rs:83-109)."""
    F = spec.field
    z1s, z2s = F.mul_many([(p[2], p[2]), (q[2], q[2])])
    z1c, z2c = F.mul_many([(p[2], z1s), (q[2], z2s)])
    a, b, c, d = F.mul_many([(p[0], z2s), (q[0], z1s), (p[1], z2c), (q[1], z1c)])
    both_inf = is_zero(spec, p) & is_zero(spec, q)
    one_inf = is_zero(spec, p) ^ is_zero(spec, q)
    same = F.eq(a, b) & F.eq(c, d)
    return both_inf | (same & ~one_inf)


def scalar_bits(fr_mont):
    """MSB-first bits (256, ..., B) of Montgomery-form Fr scalars.

    Converts out of Montgomery form by multiplying with literal 1 (the same
    trick as the reference's From<Fp> for U256, src/fields/fp.rs:15-22)."""
    one_lit = lb.const(P.int_to_limbs(1), fr_mont.device)
    canon = fp.mul(fp.FR, fr_mont, one_lit)
    shifts = torch.arange(P.LIMB_BITS, dtype=torch.int32, device=fr_mont.device)
    # (..., L, 16, B): bit j of limb i
    bits = (canon[..., :, None, :] >> shifts[:, None]) & 1
    # LSB-first flatten then reverse to MSB-first; limb axis is -3
    flat = bits.reshape(bits.shape[:-3] + (P.NLIMBS * P.LIMB_BITS,) + bits.shape[-1:])
    return torch.movedim(torch.flip(flat, dims=(-2,)), -2, 0)


def mul(spec: CurveSpec, p, fr_mont):
    """Branchless double-and-add scalar multiplication
    (src/groups/mod.rs:250-270): 256 ladder steps; the reference's found_one
    skip is unnecessary since doubling infinity is a no-op."""
    F = spec.field
    bits = scalar_bits(fr_mont)
    res = zero(spec, _batch_shape(spec, p[0]), device=p[0].device)
    for bit in bits:
        res = double(spec, res)
        radd = add(spec, res, p)
        mask = bit != 0
        res = tuple(F.select(mask, ra, r) for ra, r in zip(radd, res))
    return res


def to_affine(spec: CurveSpec, p):
    """Normalise to affine via one Fermat inversion; infinity maps to (0, 0)
    (callers mask on is_zero; the reference returns None,
    src/groups/mod.rs:112-131)."""
    F = spec.field
    zinv = F.inv(p[2])
    zinv2 = F.sq(zinv)
    zinv3 = F.mul(zinv2, zinv)
    x, y = F.mul_many([(p[0], zinv2), (p[1], zinv3)])
    return (x, y)


def from_affine(spec: CurveSpec, a, inf_mask=None):
    """Affine -> Jacobian with z = 1 (z = 0 where inf_mask)."""
    F = spec.field
    batch_shape = _batch_shape(spec, a[0])
    z = F.ones(batch_shape, a[0].device)
    if inf_mask is not None:
        z = F.select(inf_mask, F.zeros(batch_shape, a[0].device), z)
    return (a[0], a[1], z)


def on_curve_affine(spec: CurveSpec, a):
    """y^2 == x^3 + b (src/groups/mod.rs:184)."""
    F = spec.field
    x, y = a
    y2, x2 = F.mul_many([(y, y), (x, x)])
    x3 = F.mul(x2, x)
    return F.eq(y2, F.add(x3, spec.b_const(x3.device)))


# host conversion -----------------------------------------------------------


def to_device(spec: CurveSpec, points, device=None):
    """Host oracle Jacobian points -> tensors on `device` (default: the card)."""
    conv = spec.field.to_device
    return tuple(conv([pt[k] for pt in points], device) for k in range(3))


def from_device(spec: CurveSpec, p):
    """Tensors -> host oracle Jacobian points."""
    conv = spec.field.from_device
    return list(zip(conv(p[0]), conv(p[1]), conv(p[2])))
