"""Canonical wire format with full validation, matching the reference crate.

Format (that of the reference crate):
  Fr   : 32 bytes big-endian canonical integer; reject >= r
         (src/fields/fp.rs:24-36, src/arith.rs:128-159)
  Fq   : 32 bytes big-endian canonical; reject >= q
  Fq2  : 64 bytes big-endian of the single integer c1*q + c0 (a U512);
         reject >= q^2 (src/fields/fq2.rs:31-53)
  G1/G2: 1 tag byte — 0 => infinity, 4 => uncompressed affine — followed by
         x then y; decode re-validates on-curve and (G2 only) full r-order
         subgroup membership (src/groups/mod.rs:143-205, 399)
  Gt   : intentionally NOT serializable (reference derives no codec for Gt,
         src/lib.rs:165-179)

Counterpart of the JAX package's serialization.py, byte for byte.
Serialization is a host-side I/O boundary (Python ints / numpy); device limb
tensors convert through fields/fp.py and fields/tower.py.  The batch codec of
field elements is C++ (csrc/bn_host.cpp, utils/native.py).  The one step that
runs on the device is the r-order subgroup check of a G2 decode: one batched
256-step ladder for all finite points of a call, on the card unless the
caller names another device.
"""

from __future__ import annotations

import torch

from . import curve
from . import oracle as O
from . import params as P
from .fields import fp


class DecodeError(ValueError):
    pass


# ---------------------------------------------------------------------------
# scalars / base field elements
# ---------------------------------------------------------------------------


def encode_fr(v: int) -> bytes:
    return (v % P.R_SCALAR).to_bytes(32, "big")


def decode_fr(b: bytes) -> int:
    if len(b) != 32:
        raise DecodeError("Fr encoding must be 32 bytes")
    v = int.from_bytes(b, "big")
    if v >= P.R_SCALAR:
        raise DecodeError("integer is not less than modulus")
    return v


def encode_fq(v: int) -> bytes:
    return (v % P.Q).to_bytes(32, "big")


def decode_fq(b: bytes) -> int:
    if len(b) != 32:
        raise DecodeError("Fq encoding must be 32 bytes")
    v = int.from_bytes(b, "big")
    if v >= P.Q:
        raise DecodeError("integer is not less than modulus")
    return v


def encode_fq2(v) -> bytes:
    """Pack (c0, c1) as the 64-byte big-endian integer c1*q + c0
    (src/fields/fq2.rs:31-38 via U512::from)."""
    c0, c1 = v
    return ((c1 % P.Q) * P.Q + (c0 % P.Q)).to_bytes(64, "big")


def decode_fq2(b: bytes):
    if len(b) != 64:
        raise DecodeError("Fq2 encoding must be 64 bytes")
    v = int.from_bytes(b, "big")
    if v >= P.Q * P.Q:
        raise DecodeError("integer not less than modulus squared")
    c1, c0 = divmod(v, P.Q)
    return (c0, c1)


# ---------------------------------------------------------------------------
# group elements (host oracle Jacobian tuples)
# ---------------------------------------------------------------------------


def encode_g1(p) -> bytes:
    if O.g_is_zero(O.FQ_OPS, p):
        return bytes([0])
    a = O.g_to_affine(O.FQ_OPS, p)
    return bytes([4]) + encode_fq(a[0]) + encode_fq(a[1])


def decode_g1(b: bytes):
    if len(b) < 1:
        raise DecodeError("empty G1 encoding")
    tag = b[0]
    if tag == 0:
        if len(b) != 1:
            raise DecodeError("trailing bytes after infinity tag")
        return O.g_zero(O.FQ_OPS)
    if tag != 4:
        raise DecodeError("invalid leading byte for uncompressed group element")
    if len(b) != 65:
        raise DecodeError("G1 encoding must be 65 bytes")
    x = decode_fq(b[1:33])
    y = decode_fq(b[33:65])
    if not O.g1_on_curve((x, y)):
        raise DecodeError("point is not on the curve")
    return O.g_from_affine(O.FQ_OPS, (x, y))


def encode_g2(p) -> bytes:
    if O.g_is_zero(O.FQ2_OPS, p):
        return bytes([0])
    a = O.g_to_affine(O.FQ2_OPS, p)
    return bytes([4]) + encode_fq2(a[0]) + encode_fq2(a[1])


def _decode_g2_structural(b: bytes):
    """Parse + range/on-curve validation only (host, cheap).  Returns the
    oracle Jacobian point and, for finite points, its affine coords for the
    batched subgroup check."""
    if len(b) < 1:
        raise DecodeError("empty G2 encoding")
    tag = b[0]
    if tag == 0:
        if len(b) != 1:
            raise DecodeError("trailing bytes after infinity tag")
        return O.g_zero(O.FQ2_OPS), None
    if tag != 4:
        raise DecodeError("invalid leading byte for uncompressed group element")
    if len(b) != 129:
        raise DecodeError("G2 encoding must be 129 bytes")
    x = decode_fq2(b[1:65])
    y = decode_fq2(b[65:129])
    if not O.g2_on_curve((x, y)):
        raise DecodeError("point is not on the curve")
    return O.g_from_affine(O.FQ2_OPS, (x, y)), (x, y)


def g2_subgroup_mask_device(affines, device=None):
    """Batched full-order subgroup check on the device: (r-1)*P + P == 0 per
    lane (check_order, src/groups/mod.rs:186-195 — the scalar is r-1 plus one
    more add because device scalars live mod r).  One 256-step batched ladder
    instead of ~256 Python Jacobian ops per point.  Returns a bool tensor on
    the CPU, one entry per affine point."""
    spec = curve.g2_spec()
    p = curve.to_device(spec, [O.g_from_affine(O.FQ2_OPS, a) for a in affines], device)
    k = fp.to_device(fp.FR, [P.R_SCALAR - 1], device).expand(P.NLIMBS, len(affines)).contiguous()
    rp = curve.mul(spec, p, k)
    return curve.is_zero(spec, curve.add(spec, rp, p)).cpu()


def decode_g2_batch(bufs, device=None):
    """Decode many G2 encodings with ONE device-batched subgroup check.

    Structural validation (length/tag/range/on-curve) stays host-side per
    point; the expensive r-order check runs as a single batched device
    ladder over all finite points."""
    pts, checks = [], []
    for i, b in enumerate(bufs):
        pt, affine = _decode_g2_structural(b)
        pts.append(pt)
        if affine is not None:
            checks.append((i, affine))
    if checks:
        mask = g2_subgroup_mask_device([a for _, a in checks], device)
        bad = torch.nonzero(~mask).flatten()
        if len(bad):
            raise DecodeError(f"point is not in the subgroup (batch index {checks[int(bad[0])][0]})")
    return pts


def decode_g2(b: bytes, device=None):
    # G2 enforces the full-order subgroup check on decode
    # (check_order, src/groups/mod.rs:186-195, 399)
    return decode_g2_batch([b], device)[0]
