"""Prime fields Fq and Fr in Montgomery form over batched limb tensors.

Counterpart of the JAX package's fields/fp.py.  A field-element batch is a
(..., L, B) int32 tensor in Montgomery form (R = 2^256), bit-identical to the
reference crate's internal representation.  Every operation goes through the
wrappers of ops/mont_cuda.py: kernels for tensors on the card, the plain
versions for tensors on the CPU.

Inversion is Fermat exponentiation a^(m-2) on a fixed window-4 schedule:
branchless and fully parallel across the batch; one kernel on the card unless
ops/backend.py says otherwise.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import params as P
from ..convert import default_device
from ..ops import backend
from ..ops import limbs as lb
from ..ops import mont_cuda as mc


@dataclasses.dataclass(frozen=True)
class FpSpec:
    """Static per-field constants (host side); tensors are cached per device."""

    name: str
    modulus: int
    inv: int  # -modulus^-1 mod 2^16
    r1: int  # R mod m (Montgomery one)
    r2: int  # R^2 mod m
    r3: int  # R^3 mod m

    @functools.cached_property
    def m_limbs(self) -> np.ndarray:
        return P.int_to_limbs(self.modulus)

    def one_const(self, device) -> torch.Tensor:
        """Montgomery one (= R mod m) as an (L, 1) tensor on `device`."""
        return lb.const(P.int_to_limbs(self.r1), device)


FQ = FpSpec("Fq", P.Q, P.FQ_INV, P.FQ_R1, P.FQ_R2, P.FQ_R3)
FR = FpSpec("Fr", P.R_SCALAR, P.FR_INV, P.FR_R1, P.FR_R2, P.FR_R3)


# ---------------------------------------------------------------------------
# device ops (Montgomery domain)
# ---------------------------------------------------------------------------


def add(spec: FpSpec, a, b):
    return mc.mod_add(a, b, spec.modulus)


def sub(spec: FpSpec, a, b):
    return mc.mod_sub(a, b, spec.modulus)


def neg(spec: FpSpec, a):
    return mc.mod_neg(a, spec.modulus)


def double(spec: FpSpec, a):
    return add(spec, a, a)


def mul(spec: FpSpec, a, b):
    return mc.mont_mul(a, b, spec.modulus)


def sqr(spec: FpSpec, a):
    return mul(spec, a, a)


def mul_many(spec: FpSpec, pairs):
    """Many independent products of identical shape in ONE mont_mul call:
    operands are stacked along a new leading axis."""
    if len(pairs) == 1:
        return [mul(spec, *pairs[0])]
    c = mul(spec, torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs]))
    return list(c)


def zeros(spec: FpSpec, batch_shape, device=None) -> torch.Tensor:
    shape = tuple(batch_shape[:-1]) + (P.NLIMBS, batch_shape[-1])
    return torch.zeros(shape, dtype=torch.int32, device=default_device(device))


def ones(spec: FpSpec, batch_shape, device=None) -> torch.Tensor:
    shape = tuple(batch_shape[:-1]) + (P.NLIMBS, batch_shape[-1])
    return spec.one_const(default_device(device)).expand(shape).clone()


def mul_small(spec: FpSpec, a, k: int):
    """k * a for a small positive integer k by double-and-add on mod_add
    (the 3x / 8x / 9x constants of the curve and tower formulas)."""
    if k < 1:
        raise ValueError(f"mul_small: k must be a positive integer, got {k}")
    res = a
    for bit in P.bits_msb_first(k)[1:]:
        res = double(spec, res)
        if bit:
            res = add(spec, res, a)
    return res


# ---------------------------------------------------------------------------
# fixed-exponent powering and Fermat inversion
# ---------------------------------------------------------------------------


def pow_fixed(spec: FpSpec, a, e: int):
    """a^e (Montgomery domain) for a fixed exponent e, by the window-4 ladder
    of ops/mont_cuda.py.  With the `pow_fixed` switch of ops/backend.py on
    (the default) an exponent of more than three digits goes to the one
    `pow_fixed` kernel; otherwise the ladder is a Python loop of `mont_mul`
    calls, about five launches a digit.  Same limbs either way."""
    if e == 0:
        return ones(spec, a.shape[:-2] + a.shape[-1:], device=a.device)
    if backend.pow_fixed and e.bit_length() > 3 * mc.WINDOW:
        return mc.pow_fixed(a, e, spec.modulus)
    one = spec.one_const(a.device).expand_as(a)
    return mc.window_pow(lambda x, y: mul(spec, x, y), one, a, e)


def inv(spec: FpSpec, a):
    """Multiplicative inverse by Fermat: a^(m-2).  Maps 0 -> 0."""
    return pow_fixed(spec, a, spec.modulus - 2)


# ---------------------------------------------------------------------------
# host <-> device conversion
# ---------------------------------------------------------------------------


def to_device(spec: FpSpec, values, device=None) -> torch.Tensor:
    """Pack canonical ints into Montgomery-form (L, B) limbs on `device`."""
    monts = [P.to_mont(v % spec.modulus, spec.modulus) for v in values]
    return torch.from_numpy(P.ints_to_limbs(monts).astype(np.int32)).to(default_device(device))


def from_device(spec: FpSpec, arr) -> list:
    """Unpack Montgomery-form (L, B) limbs into canonical ints."""
    arr = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    return [P.from_mont(v, spec.modulus) for v in P.limbs_to_ints(arr)]
