"""Plain PyTorch arithmetic on BN254 base-field elements held as limb tensors,
for making the benchmark's inputs on the card and for judging its outputs.

The layout is the one the benchmarked package takes and returns: an Fq batch
is (..., 16, N), sixteen 16-bit limbs of x R mod q (R = 2^256, Montgomery
form), limb axis before the batch axis; Fq2 = (..., 2, 16, N), Fq6 =
(..., 3, 2, 16, N), Fq12 = (..., 2, 3, 2, 16, N).  Here the limbs are int64,
so sums of products never overflow; values are kept canonical (< q) after
every operation.  Nothing here is a kernel: every function is a short
sequence of elementwise torch operations, and it imports nothing of the
package it judges.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .field import Q

NLIMBS = 16
MASK = 0xFFFF
R_MONT = 1 << 256
INV16 = (-pow(Q, -1, 1 << 16)) % (1 << 16)  # -q^-1 mod 2^16


def ints_to_limbs(values, mont: bool = True) -> np.ndarray:
    """Integers (taken mod q) -> a (16, n) int64 array of limbs, of x R mod q
    with `mont`, else of x itself (which must be below 2^256)."""
    vals = [(v * R_MONT) % Q if mont else v for v in values]
    raw = b"".join(v.to_bytes(32, "little") for v in vals)
    return np.frombuffer(raw, dtype="<u2").reshape(len(vals), NLIMBS).T.astype(np.int64)


def limbs_to_ints(arr, mont: bool = True) -> list:
    """A (16, n) array or tensor of limbs -> n integers (out of Montgomery
    form with `mont`).  Limbs must lie in [0, 2^16)."""
    arr = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    raw = np.ascontiguousarray(arr.T.astype("<u2")).tobytes()
    vals = [int.from_bytes(raw[32 * k : 32 * k + 32], "little") for k in range(arr.shape[1])]
    r_inv = pow(R_MONT, -1, Q)
    return [v * r_inv % Q for v in vals] if mont else vals


@functools.lru_cache(maxsize=None)
def _const(value: int, mont: bool, device_str: str) -> torch.Tensor:
    return torch.from_numpy(ints_to_limbs([value], mont)).to(torch.device(device_str))


def const(value: int, device, mont: bool = True) -> torch.Tensor:
    """A (16, 1) int64 limb tensor of one value on `device`."""
    return _const(value, mont, str(device))


def _carry(t: torch.Tensor) -> torch.Tensor:
    """Propagate carries (and borrows: the shift is arithmetic) up the limb
    axis; every limb but the top one ends in [0, 2^16).  In place."""
    for k in range(t.shape[-2] - 1):
        t[..., k + 1, :] += t[..., k, :] >> 16
        t[..., k, :] &= MASK
    return t


def _sub_q_if_above(r: torch.Tensor) -> torch.Tensor:
    """r - q where r >= q, else r, for normalized r < 2q."""
    d = _carry(r - const(Q, r.device, mont=False))
    return torch.where(d[..., -1:, :] >= 0, d, r)


def add(a, b):
    return _sub_q_if_above(_carry(a + b))


def sub(a, b):
    d = _carry(a - b)
    return torch.where(d[..., -1:, :] < 0, _carry(d + const(Q, d.device, mont=False)), d)


def mont_mul(a, b):
    """a b R^-1 mod q of canonical operands (broadcast against each other)."""
    a, b = torch.broadcast_tensors(a, b)
    qlimbs = const(Q, a.device, mont=False)
    t = a.new_zeros(a.shape[:-2] + (2 * NLIMBS + 1, a.shape[-1]))
    for i in range(NLIMBS):
        t[..., i : i + NLIMBS, :] += a[..., i : i + 1, :] * b
    for i in range(NLIMBS):
        m = (t[..., i, :] * INV16) & MASK
        t[..., i : i + NLIMBS, :] += m.unsqueeze(-2) * qlimbs
        t[..., i + 1, :] += t[..., i, :] >> 16
    r = _carry(t[..., NLIMBS:, :].clone())
    return _sub_q_if_above(r[..., :NLIMBS, :])


def is_canonical(a) -> torch.Tensor:
    """Per element of an (..., 16, N) tensor: every limb in [0, 2^16) and the
    value below q.  Shape (..., N)."""
    in_range = ((a >= 0) & (a <= MASK)).all(dim=-2)
    below_q = _carry(a - const(Q, a.device, mont=False))[..., -1, :] < 0
    return in_range & below_q


# --- Fq2, Fq6, Fq12 (the tower of the benchmarked package) ---------------------

def _c(a, k: int, depth: int):
    """Coefficient k of a tower element whose structure axis is `depth` axes
    in front of the limb axis."""
    return a.select(-2 - depth, k)


def fq2_mul(a, b):
    a0, a1, b0, b1 = _c(a, 0, 1), _c(a, 1, 1), _c(b, 0, 1), _c(b, 1, 1)
    a0, a1, b0, b1 = torch.broadcast_tensors(a0, a1, b0, b1)
    p = mont_mul(torch.stack([a0, a1, add(a0, a1)]), torch.stack([b0, b1, add(b0, b1)]))
    return torch.stack([sub(p[0], p[1]), sub(sub(p[2], p[0]), p[1])], dim=-3)


def fq2_mul_by_xi(a):
    """(9 + u) a = (9 a0 - a1) + (a0 + 9 a1) u."""
    nine = mont_mul(a, const(9, a.device))
    return torch.stack([sub(_c(nine, 0, 1), _c(a, 1, 1)), add(_c(a, 0, 1), _c(nine, 1, 1))], dim=-3)


def _stack2(xs):
    return torch.stack(torch.broadcast_tensors(*xs))


def fq6_mul(a, b):
    a0, a1, a2 = (_c(a, k, 2) for k in range(3))
    b0, b1, b2 = (_c(b, k, 2) for k in range(3))
    lhs = _stack2([a0, a1, a2, add(a1, a2), add(a0, a1), add(a0, a2)])
    rhs = _stack2([b0, b1, b2, add(b1, b2), add(b0, b1), add(b0, b2)])
    aa, bb, cc, t12, t01, t02 = fq2_mul(lhs, rhs)
    c0 = add(fq2_mul_by_xi(sub(sub(t12, bb), cc)), aa)
    c1 = add(sub(sub(t01, aa), bb), fq2_mul_by_xi(cc))
    c2 = sub(add(sub(t02, aa), bb), cc)
    return torch.stack([c0, c1, c2], dim=-4)


def fq12_mul(a, b):
    a0, a1, b0, b1 = _c(a, 0, 3), _c(a, 1, 3), _c(b, 0, 3), _c(b, 1, 3)
    aa, bb, t = fq6_mul(_stack2([a0, a1, add(a0, a1)]), _stack2([b0, b1, add(b0, b1)]))
    bb_v = torch.stack([fq2_mul_by_xi(_c(bb, 2, 2)), _c(bb, 0, 2), _c(bb, 1, 2)], dim=-4)
    return torch.stack([add(bb_v, aa), sub(sub(t, aa), bb)], dim=-5)


def fq12_from_ints(values, device) -> torch.Tensor:
    """Twelve integers (the coefficients in limb-tensor order) -> one Fq12,
    (2, 3, 2, 16, 1) int64 in Montgomery form."""
    return torch.from_numpy(ints_to_limbs(values).T.copy()).reshape(2, 3, 2, NLIMBS, 1).to(device)


# --- Jacobian addition over Fq (G1) or Fq2 (G2), for the input generator -------

def jacobian_add(mul, p, q):
    """p + q of Jacobian points, none of them infinity, equal or opposite
    (add-2007-bl); `mul` is mont_mul (G1) or fq2_mul (G2).  The products of
    one level are stacked into one call."""
    (x1, y1, z1), (x2, y2, z2) = (torch.broadcast_tensors(*p), torch.broadcast_tensors(*q))
    z1s, z2s = mul(_stack2([z1, z2]), _stack2([z1, z2]))
    u1, u2, z1c, z2c = mul(_stack2([x1, x2, z1, z2]), _stack2([z2s, z1s, z1s, z2s]))
    s1, s2 = mul(_stack2([y1, y2]), _stack2([z2c, z1c]))
    h, r = sub(u2, u1), sub(s2, s1)
    r = add(r, r)
    h2 = add(h, h)
    zz = add(z1, z2)
    i, zz2, rr = mul(_stack2([h2, zz, r]), _stack2([h2, zz, r]))
    j, v = mul(_stack2([h, u1]), _stack2([i, i]))
    x3 = sub(sub(rr, j), add(v, v))
    y3a, s1j, z3 = mul(_stack2([r, s1, sub(sub(zz2, z1s), z2s)]), _stack2([sub(v, x3), j, h]))
    return x3, sub(y3a, add(s1j, s1j)), z3
