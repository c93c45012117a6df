"""Prime fields Fq and Fr in Montgomery form over batched limb tensors.

Counterpart of the JAX package's fields/fp.py.  A field-element batch is a
(..., L, B) int32 tensor in Montgomery form (R = 2^256), bit-identical to the
reference crate's internal representation.  Every operation goes through the
wrappers of ops/mont_cuda.py: kernels for tensors on the card, the plain
versions for tensors on the CPU.

Inversion is Fermat exponentiation a^(m-2) on a fixed window-4 schedule:
branchless and fully parallel across the batch.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import params as P
from ..convert import default_device
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
    """Multiply by a small positive integer via double-and-add on mod ops
    (the 3x / 8x / 9x constants of the curve and tower formulas)."""
    assert k >= 1
    res = a
    for bit in P.bits_msb_first(k)[1:]:
        res = double(spec, res)
        if bit:
            res = add(spec, res, a)
    return res


# ---------------------------------------------------------------------------
# fixed-exponent powering and Fermat inversion
# ---------------------------------------------------------------------------

_WINDOW = 4


@functools.lru_cache(maxsize=None)
def _digit_schedule(e: int):
    """Big-endian base-16 digits of e, leading zeros stripped."""
    assert e > 0
    nd = (e.bit_length() + _WINDOW - 1) // _WINDOW
    return tuple((e >> (i * _WINDOW)) & (2**_WINDOW - 1) for i in range(nd - 1, -1, -1))


def pow_fixed(spec: FpSpec, a, e: int):
    """a^e (Montgomery domain) for a fixed exponent e.

    Windowed square-and-multiply: res = res^16 * table[d].  The Montgomery
    one is a true multiplicative identity under mont_mul, so the d = 0 slot
    needs no special case.  The schedule is static, hence a Python loop."""
    one = ones(spec, a.shape[:-2] + a.shape[-1:], device=a.device)
    if e == 0:
        return one
    table = [one]
    for _ in range(2**_WINDOW - 1):
        table.append(mul(spec, table[-1], a))
    digits = _digit_schedule(e)
    res = table[digits[0]]
    for d in digits[1:]:
        for _ in range(_WINDOW):
            res = sqr(spec, res)
        res = mul(spec, res, table[d])
    return res


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
