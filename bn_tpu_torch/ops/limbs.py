"""Plain PyTorch 256-bit modular limb arithmetic on (..., L, B) int32 tensors.

Counterpart of the JAX package's ops/limbs.py, and the arithmetic behind the
plain version of every kernel in ops/mont_cuda.py and ops/tower_cuda.py.
Field elements are columns of L = 16 limbs of 16 bits, batch axis last; all
operations are branchless and broadcast over leading axes.

Differences from the JAX engine, none of which changes a result (every
result is the canonical residue in [0, m)):

 - limbs are int32; products widen to int64 inside, so a 32-bit limb product
   needs no lo/hi split and a column of sixteen products stays exact;
 - the Montgomery product reduces column by column (word 2^16) on the
   unnormalised int64 columns and resolves carries once at the end, instead
   of the separated REDC with three convolutions;
 - no einsum: column products are sixteen shifted multiply-adds, which run
   the same on the CPU and on the card (torch has no int64 matmul on CUDA).

Carry resolution is the same ripple + Kogge-Stone scheme as the JAX engine.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..params import LIMB_BITS, LIMB_MASK, NLIMBS, int_to_limbs, limbs_to_int

_MASK = LIMB_MASK


@functools.lru_cache(maxsize=None)
def _const_cached(key: bytes, device_str: str):
    arr = np.frombuffer(key, dtype=np.int32).reshape(-1, 1).copy()
    return torch.from_numpy(arr).to(torch.device(device_str))


def const(limbs: np.ndarray, device) -> torch.Tensor:
    """A host (L,) limb vector as an (L, 1) int32 tensor on `device`,
    broadcastable against (..., L, B).  Cached per value and device."""
    key = np.ascontiguousarray(np.asarray(limbs).reshape(-1).astype(np.int32)).tobytes()
    return _const_cached(key, str(device))


@functools.lru_cache(maxsize=None)
def _mod_ints(m_key: bytes):
    """(m, 2^256 - m, -m^-1 mod 2^16) of a modulus given by its limbs."""
    m = limbs_to_int(np.frombuffer(m_key, dtype=np.uint32))
    return m, (1 << 256) - m, (-pow(m, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)


def _mod(m_limbs):
    return _mod_ints(np.ascontiguousarray(np.asarray(m_limbs, dtype=np.uint32)).tobytes())


# ---------------------------------------------------------------------------
# Kogge-Stone carry resolution
# ---------------------------------------------------------------------------


def _shift_up(x, d):
    """Shift limbs towards the most-significant end (limb axis -2), zero fill."""
    out = torch.zeros_like(x)
    out[..., d:, :] = x[..., :-d, :]
    return out


def resolve_carries(cols, extra: int = 1, passes: int = 2):
    """Normalise non-negative columns to 16-bit limbs.

    cols: (..., C, B).  `passes` ripple passes bring every entry down to at
    most 2^16 (two are enough below 2^27, three below 2^48); a Kogge-Stone
    generate/propagate prefix resolves the binary carries that remain.
    Appends `extra` zero columns at the top first to absorb overflow, and
    returns (..., C+extra, B) limbs < 2^16.
    """
    if extra:
        pad = torch.zeros(cols.shape[:-2] + (extra,) + cols.shape[-1:], dtype=cols.dtype, device=cols.device)
        cols = torch.cat([cols, pad], dim=-2)
    x = cols
    for _ in range(passes):
        x = (x & _MASK) + _shift_up(x >> LIMB_BITS, 1)
    g = x >> LIMB_BITS  # generate (0/1)
    s = x & _MASK
    p = (s == _MASK).to(x.dtype)  # propagate (0/1)
    n = x.shape[-2]
    d = 1
    while d < n:
        g = g | (p & _shift_up(g, d))
        p = p & _shift_up(p, d)
        d *= 2
    return (s + _shift_up(g, 1)) & _MASK


def _plus_one(cols):
    """cols with 1 added to the lowest limb (the +1 of a two's complement)."""
    out = cols.clone()
    out[..., 0, :] += 1
    return out


def sub_limbs(a, b):
    """a - b; returns (diff (..., L, B), borrow (..., B)) with borrow in {0,1}.
    Two's complement: a + ~b + 1; carry-out 1 means a >= b."""
    r = resolve_carries(_plus_one(a + (_MASK - b)), extra=1)
    return r[..., :-1, :], 1 - r[..., -1, :]


def select(mask, a, b):
    """Elementwise select over limb tensors; mask has shape (..., B)."""
    return torch.where(mask[..., None, :], a, b)


def is_zero(a):
    return torch.all(a == 0, dim=-2)


def eq(a, b):
    return torch.all(a == b, dim=-2)


# ---------------------------------------------------------------------------
# modular add / sub / neg
# ---------------------------------------------------------------------------


def mod_add(a, b, m_limbs):
    """(a + b) mod m by dual evaluation: s = a+b and s2 = a+b+(2^256-m); the
    carry-out of the second says whether a+b >= m (then s2 = a+b-m)."""
    _, rminusm, _ = _mod(m_limbs)
    rm = const(int_to_limbs(rminusm), a.device)
    ab = a + b
    r = resolve_carries(torch.stack([ab, ab + rm]), extra=1)
    overflow = r[1][..., -1, :] != 0
    return select(overflow, r[1][..., :-1, :], r[0][..., :-1, :])


def mod_sub(a, b, m_limbs):
    """(a - b) mod m: d = a-b (two's complement) and d2 = a-b+m; select on
    the borrow."""
    m = const(m_limbs, a.device)
    cols = _plus_one(a + (_MASK - b))
    r = resolve_carries(torch.stack([cols, cols + m]), extra=1)
    borrow = r[0][..., -1, :] == 0  # no carry-out -> a < b
    return select(borrow, r[1][..., :-1, :], r[0][..., :-1, :])


def mod_neg(a, m_limbs):
    """(m - a) mod m, with -0 = 0."""
    m = const(m_limbs, a.device).expand_as(a)
    d, _ = sub_limbs(m, a)
    return select(is_zero(a), a, d)


# ---------------------------------------------------------------------------
# Montgomery multiplication (word 2^16, R = 2^256)
# ---------------------------------------------------------------------------


def limb_conv(a, b):
    """Unnormalised product columns of two int64 limb tensors of L limbs:
    (..., 2L, B), column k = sum over i+j=k of a_i*b_j (< 2^36)."""
    L = a.shape[-2]
    shape = torch.broadcast_shapes(a.shape, b.shape)
    cols = torch.zeros(shape[:-2] + (2 * L,) + shape[-1:], dtype=torch.int64, device=a.device)
    for i in range(L):
        cols[..., i : i + L, :] += a[..., i : i + 1, :] * b
    return cols


def mont_mul(a, b, m_limbs):
    """Montgomery product a*b*R^-1 mod m, R = 2^256; a, b in [0, m); result
    in [0, m).  T = a*b as 32 int64 columns; for each low column i, add
    mu_i*m shifted by i with mu_i = T_i*(-m^-1) mod 2^16 so that the column
    clears, and push its carry up; the high 16 columns are then (T + mu*m)/R
    < 2m, normalised once and reduced by one conditional subtract."""
    L = NLIMBS
    assert a.shape[-2] == L and b.shape[-2] == L
    _, _, inv = _mod(m_limbs)
    m32 = const(m_limbs, a.device)
    m64 = m32.to(torch.int64)
    t = limb_conv(a.to(torch.int64), b.to(torch.int64))
    for i in range(L):
        mu = ((t[..., i, :] & _MASK) * inv) & _MASK
        t[..., i : i + L, :] += mu[..., None, :] * m64
        t[..., i + 1, :] += t[..., i, :] >> LIMB_BITS
    res = resolve_carries(t[..., L:, :], extra=1, passes=3).to(torch.int32)
    res, c_out = res[..., :L, :], res[..., L, :]
    d, borrow = sub_limbs(res, m32.expand_as(res))
    return select((borrow == 0) | (c_out != 0), d, res)
