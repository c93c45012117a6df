"""Public API: Fr, G1, G2, Gt, pairing — the reference crate's surface
(src/lib.rs), batch-first.

Counterpart of the JAX package's api.py.  Every object wraps limb tensors
with the batch axis last; singleton use is just batch 1.  Operators are plain
calls into fields/, curve.py and ate.py: on the card each is a handful of
kernel launches (a scalar multiplication 256 `point_double` and 256
`point_add`).  Constructors take `device` and default to the card; an
operator's result lies where its operands lie.

Host-side ingestion (from_str / interpret / serialization) uses exact Python
ints, mirroring where the reference converts at the Montgomery boundary
(src/fields/fp.rs:15-74); Fr bytes go through the C++ codec
(utils/native.py).
"""

from __future__ import annotations

import random as _random

import numpy as np
import torch

from . import ate as _pairing_mod
from . import curve
from . import params as P
from . import serialization as _ser
from .convert import default_device
from .fields import fp, tower
from .utils import native


def _rng(seed_or_rng):
    if isinstance(seed_or_rng, _random.Random):
        return seed_or_rng
    return _random.Random(seed_or_rng)


def _fr_pow(a, e_mont):
    """a^e in Fr for Montgomery-form exponents: a branchless
    square-and-multiply ladder over the 256 bits of e."""
    res = fp.ones(fp.FR, a.shape[:-2] + a.shape[-1:], a.device)
    for bit in curve.scalar_bits(e_mont):
        res = fp.sqr(fp.FR, res)
        res = torch.where((bit != 0)[..., None, :], fp.mul(fp.FR, res, a), res)
    return res


class Fr:
    """Scalar field element batch (src/lib.rs:15-54)."""

    def __init__(self, dev):
        self.dev = dev

    @property
    def batch(self):
        return self.dev.shape[-1]

    # constructors ---------------------------------------------------------
    @classmethod
    def zero(cls, n=1, device=None):
        return cls(fp.zeros(fp.FR, (n,), device))

    @classmethod
    def one(cls, n=1, device=None):
        return cls(fp.ones(fp.FR, (n,), device))

    @classmethod
    def random(cls, rng, n=1, device=None):
        """Uniform mod r via 512-bit reduction (U256::random,
        src/arith.rs:194-198); `rng` is a seed or a random.Random."""
        r = _rng(rng)
        return cls.from_ints([r.getrandbits(512) % P.R_SCALAR for _ in range(n)], device)

    @classmethod
    def from_ints(cls, vals, device=None):
        return cls(fp.to_device(fp.FR, vals, device))

    @classmethod
    def from_str(cls, s: str, n=1, device=None):
        """Decimal parse (src/fields/fp.rs:39-59); None on junk."""
        if not s or any(c not in "0123456789" for c in s):
            return None
        return cls.from_ints([int(s) % P.R_SCALAR] * n, device)

    @classmethod
    def interpret(cls, buf: bytes, device=None):
        """64 big-endian bytes -> mod-r reduction (fp.rs:72-74)."""
        assert len(buf) == 64
        return cls.from_ints([int.from_bytes(buf, "big") % P.R_SCALAR], device)

    # ops ------------------------------------------------------------------
    def __add__(self, o):
        return Fr(fp.add(fp.FR, self.dev, o.dev))

    def __sub__(self, o):
        return Fr(fp.sub(fp.FR, self.dev, o.dev))

    def __mul__(self, o):
        return Fr(fp.mul(fp.FR, self.dev, o.dev))

    def __neg__(self):
        return Fr(fp.neg(fp.FR, self.dev))

    def inverse(self):
        """None-free batched inverse: zeros map to zero (the reference
        returns None per element, src/lib.rs:25)."""
        return Fr(fp.inv(fp.FR, self.dev))

    def pow(self, e: "Fr"):
        return Fr(_fr_pow(self.dev, e.dev))

    def is_zero(self):
        return torch.all(self.dev == 0, dim=-2).cpu().numpy()

    def __eq__(self, o):
        return isinstance(o, Fr) and torch.equal(self.dev, o.dev)

    # host I/O -------------------------------------------------------------
    def to_ints(self):
        return fp.from_device(fp.FR, self.dev)

    def to_bytes(self):
        flat = native.fp_encode_batch(self.dev.cpu().numpy().T, native.FIELD_FR)
        return [flat[i * 32 : (i + 1) * 32] for i in range(self.batch)]

    @classmethod
    def from_bytes(cls, bufs, device=None):
        for b in bufs:
            if len(b) != 32:
                raise _ser.DecodeError("Fr encoding must be 32 bytes")
        try:
            rows = native.fp_decode_batch(b"".join(bufs), native.FIELD_FR)
        except ValueError as exc:
            raise _ser.DecodeError(str(exc)) from None
        limbs = np.ascontiguousarray(rows.T.astype(np.int32))
        return cls(torch.from_numpy(limbs).to(default_device(device)))


class _GroupBase:
    _spec_fn = None

    def __init__(self, dev):
        self.dev = dev  # (x, y, z) tuple of limb tensors

    @property
    def batch(self):
        return self.dev[0].shape[-1]

    @classmethod
    def zero(cls, n=1, device=None):
        return cls(curve.zero(cls._spec_fn(), (n,), device))

    @classmethod
    def one(cls, n=1, device=None):
        return cls(curve.one(cls._spec_fn(), (n,), device))

    @classmethod
    def random(cls, rng, n=1, device=None):
        """one() * Fr::random (src/groups/mod.rs:220-222)."""
        return cls.one(n, device) * Fr.random(rng, n, device)

    def __add__(self, o):
        return type(self)(curve.add(self._spec_fn(), self.dev, o.dev))

    def __sub__(self, o):
        return self + (-o)

    def __neg__(self):
        return type(self)(curve.neg(self._spec_fn(), self.dev))

    def __mul__(self, k: Fr):
        return type(self)(curve.mul(self._spec_fn(), self.dev, k.dev))

    def double(self):
        return type(self)(curve.double(self._spec_fn(), self.dev))

    def is_zero(self):
        return curve.is_zero(self._spec_fn(), self.dev).cpu().numpy()

    def eq(self, o):
        return curve.eq(self._spec_fn(), self.dev, o.dev).cpu().numpy()

    def __eq__(self, o):
        return isinstance(o, type(self)) and bool(self.eq(o).all())

    def normalize(self):
        """Affine-normalize (z -> 1; infinity stays (0, 1, 0)), like the
        reference's Group::normalize (src/lib.rs:88-95)."""
        spec = self._spec_fn()
        F = spec.field
        aff = curve.to_affine(spec, self.dev)
        inf = curve.is_zero(spec, self.dev)
        p = curve.from_affine(spec, aff, inf_mask=inf)
        batch_shape = tuple(inf.shape)
        device = aff[0].device
        y = F.select(inf, F.ones(batch_shape, device), p[1])
        x = F.select(inf, F.zeros(batch_shape, device), p[0])
        return type(self)((x, y, p[2]))

    # host I/O -------------------------------------------------------------
    def to_oracle(self):
        return curve.from_device(self._spec_fn(), self.dev)

    @classmethod
    def from_oracle(cls, points, device=None):
        return cls(curve.to_device(cls._spec_fn(), points, device))


class G1(_GroupBase):
    _spec_fn = staticmethod(curve.g1_spec)

    def to_bytes(self):
        return [_ser.encode_g1(p) for p in self.to_oracle()]

    @classmethod
    def from_bytes(cls, bufs, device=None):
        return cls.from_oracle([_ser.decode_g1(b) for b in bufs], device)


class G2(_GroupBase):
    _spec_fn = staticmethod(curve.g2_spec)

    def to_bytes(self):
        return [_ser.encode_g2(p) for p in self.to_oracle()]

    @classmethod
    def from_bytes(cls, bufs, device=None):
        """Decode with one batched subgroup check on `device` for all finite
        points; DecodeError names the first point outside the subgroup."""
        return cls.from_oracle(_ser.decode_g2_batch(bufs, device), device)


class Gt:
    """Target group element batch (src/lib.rs:165-179 — one/pow/inverse/mul
    only; deliberately no serialization, zero, or random)."""

    def __init__(self, dev):
        self.dev = dev

    @property
    def batch(self):
        return self.dev.shape[-1]

    @classmethod
    def one(cls, n=1, device=None):
        return cls(tower.ones12((n,), device))

    def __mul__(self, o):
        return Gt(tower.fq12_mul(self.dev, o.dev))

    def pow(self, e: Fr):
        return Gt(tower.fq12_pow_fr(self.dev, torch.movedim(curve.scalar_bits(e.dev), 0, -2)))

    def inverse(self):
        return Gt(tower.fq12_inv(self.dev))

    def __eq__(self, o):
        return isinstance(o, Gt) and torch.equal(self.dev, o.dev)

    def to_oracle(self):
        return tower.fq12_from_device(self.dev)


def pairing(p: G1, q: G2) -> Gt:
    """Batched reduced optimal-ate pairing (src/lib.rs:181-183)."""
    return Gt(_pairing_mod.pairing_batch(p.dev, q.dev))


def pairing_batch(p_dev, q_dev):
    """Functional entry on raw limb tensors."""
    return _pairing_mod.pairing_batch(p_dev, q_dev)
