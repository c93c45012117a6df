"""Plain PyTorch 256-bit modular limb arithmetic on (..., L, B) int32 tensors.

Counterpart of the JAX package's ops/limbs.py, and the arithmetic behind the
plain version of every kernel in ops/mont_cuda.py and ops/tower_cuda.py.
Field elements are columns of L = 16 limbs of 16 bits, batch axis last; all
operations are branchless and broadcast over leading axes.

Differences from the JAX engine, none of which changes a result (every
result is the canonical residue in [0, m)):

 - limbs are int32; products widen to int64 inside, so a 32-bit limb product
   needs no lo/hi split and a column of sixteen products stays exact;
 - the Montgomery product is the separated REDC with three convolutions, as
   in the JAX engine, but its quotient digits stay unnormalised and all 32
   columns of T + mu*m are normalised in one go (see `mont_mul`);
 - no einsum: a convolution is one outer product, re-cut so that a plain sum
   adds its anti-diagonals, which runs the same on the CPU and on the card
   (torch has no int64 matmul on CUDA);
 - carry resolution is ripple passes and then one packed integer addition
   for the binary carries that remain, where the JAX engine runs a
   Kogge-Stone prefix.

Everything is written for few tensor operations a call, not few arithmetic
operations: at the small batches the tests run on the CPU, a call costs what
its number of tensor operations costs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

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
    """(m, 2^256 - m, -m^-1 mod 2^256) of a modulus given by its limbs."""
    m = limbs_to_int(np.frombuffer(m_key, dtype=np.uint32))
    return m, (1 << 256) - m, (-pow(m, -1, 1 << 256)) % (1 << 256)


def _mod(m_limbs):
    return _mod_ints(np.ascontiguousarray(np.asarray(m_limbs, dtype=np.uint32)).tobytes())


# ---------------------------------------------------------------------------
# carry resolution
# ---------------------------------------------------------------------------


def _shift_up(x):
    """Shift limbs one place towards the most-significant end (limb axis -2),
    zero fill; what leaves the top is dropped."""
    return F.pad(x[..., :-1, :], (0, 0, 1, 0))


def _ripple(x, passes: int):
    """`passes` times: keep the low 16 bits of every column and add its excess
    to the next column.  Brings non-negative columns below 2^(16k) down to at
    most 2^16 + 2^(16(k-passes)) (2^16 + 1 once that is small); what leaves
    the top column is dropped."""
    for _ in range(passes):
        x = (x & _MASK) + _shift_up(x >> LIMB_BITS)
    return x


@functools.lru_cache(maxsize=None)
def _bit_weights(n: int, device_str: str):
    """(2^k) and (k) for k < n as (n, 1) int64 tensors."""
    k = torch.arange(n, dtype=torch.int64, device=torch.device(device_str)).reshape(n, 1)
    return torch.ones_like(k) << k, k


def _settle(x):
    """Columns of at most 2^16 + 1 -> limbs < 2^16 of the same integer (a carry
    out of the top column is dropped).  What is left to resolve is binary:
    column k generates a carry if it holds 2^16 or more and propagates one if
    it holds 2^16 - 1.  Packed one bit a column into an int64, the machine's
    own adder resolves all of them at once: with a = generate | propagate and
    b = generate, the carries into a + b are (a + b) ^ a ^ b."""
    w, k = _bit_weights(x.shape[-2], str(x.device))
    g = x >> LIMB_BITS
    s = x & _MASK
    p = (s == _MASK).to(x.dtype)
    prop = (p * w).sum(-2)
    total = ((g * 2 + p) * w).sum(-2)  # a + b = 2 * generate + propagate
    carry_in = ((total ^ prop)[..., None, :] >> k) & 1
    return ((s + carry_in) & _MASK).to(x.dtype)


def resolve_carries(cols, extra: int = 1, passes: int = 2):
    """Normalise non-negative columns to 16-bit limbs.

    cols: (..., C, B) with C + extra <= 62.  `passes` ripple passes bring
    every entry down to at most 2^16 + 1 (one is enough below 2^17 + 2^16,
    three below 2^48); the binary carries that remain are settled at once.
    Appends `extra` zero columns at the top first to absorb overflow, and
    returns (..., C+extra, B) limbs < 2^16.
    """
    assert cols.shape[-2] + extra <= 62, "one bit a column must fit an int64 with room for 2g + p"
    if extra:
        cols = F.pad(cols, (0, 0, 0, extra))
    return _settle(_ripple(cols, passes))


def _plus_one(cols):
    """cols with 1 added to the lowest limb (the +1 of a two's complement)."""
    out = cols.clone()
    out[..., 0, :] += 1
    return out


def sub_limbs(a, b):
    """a - b; returns (diff (..., L, B), borrow (..., B)) with borrow in {0,1}.
    Two's complement: a + ~b + 1; carry-out 1 means a >= b."""
    r = resolve_carries(_plus_one(a + (_MASK - b)), extra=1, passes=1)
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
    r = resolve_carries(torch.stack([ab, ab + rm]), extra=1, passes=1)
    overflow = r[1][..., -1, :] != 0
    return select(overflow, r[1][..., :-1, :], r[0][..., :-1, :])


def mod_sub(a, b, m_limbs):
    """(a - b) mod m: d = a-b (two's complement) and d2 = a-b+m; select on
    the borrow."""
    m = const(m_limbs, a.device)
    cols = _plus_one(a + (_MASK - b))
    r = resolve_carries(torch.stack([cols, cols + m]), extra=1, passes=1)
    borrow = r[0][..., -1, :] == 0  # no carry-out -> a < b
    return select(borrow, r[1][..., :-1, :], r[0][..., :-1, :])


def mod_neg(a, m_limbs):
    """(m - a) mod m, with -0 = 0."""
    m = const(m_limbs, a.device).expand_as(a)
    d, _ = sub_limbs(m, a)
    return select(is_zero(a), a, d)


# ---------------------------------------------------------------------------
# Montgomery multiplication (R = 2^256)
# ---------------------------------------------------------------------------


def limb_conv(a, b):
    """Unnormalised product columns of two int64 limb tensors of L limbs:
    (..., 2L, B), column k = sum over i+j=k of a_i*b_j.  The L x L partial
    products are laid out (i, j), each row padded to 2L and the rows re-cut at
    2L-1, which moves row i right by i places; the sum over rows is then the
    sum over anti-diagonals."""
    L = a.shape[-2]
    prod = F.pad(a[..., :, None, :] * b[..., None, :, :], (0, 0, 0, L))  # (..., L, 2L, B)
    lead, B = prod.shape[:-3], prod.shape[-1]
    skew = prod.reshape(lead + (2 * L * L, B))[..., : L * (2 * L - 1), :].reshape(lead + (L, 2 * L - 1, B))
    return F.pad(skew.sum(-3), (0, 0, 0, 1))


def mont_mul(a, b, m_limbs):
    """Montgomery product a*b*R^-1 mod m, R = 2^256; a, b in [0, m); result
    in [0, m).  With T = a*b as 32 int64 columns and mu = T * (-m^-1) mod R,
    T + mu*m is a multiple of R and (T + mu*m)/R < 2m is the product up to one
    subtraction of m.  No step runs limb by limb, and every step is exact
    integer arithmetic:

     - mu is kept as sixteen columns of at most 2^16 + 2^8 (three ripple
       passes on columns below 2^56, carries out of the top dropped): any
       mu' = mu mod R serves, and this one is below R (1 + 2^-8), so the
       quotient stays below 2m;
     - T + mu'*m has columns below 2^36 + 2^37 < 2^38 and is normalised
       whole, 32 columns and one for the carry out, together with itself plus
       (R - m) * R.  Its low half comes out zero, its high half is the
       quotient, and the carry out of the second says whether to subtract m."""
    L = NLIMBS
    assert a.shape[-2] == L and b.shape[-2] == L
    _, rminusm, minv = _mod(m_limbs)
    device = a.device
    m64 = const(m_limbs, device).to(torch.int64)
    minv64 = const(int_to_limbs(minv), device).to(torch.int64)
    rm_hi = const(np.concatenate([np.zeros(L, np.uint32), int_to_limbs(rminusm)]), device)
    t = limb_conv(a.to(torch.int64), b.to(torch.int64))
    mu = _ripple(limb_conv(t[..., :L, :], minv64)[..., :L, :], 3)
    s = t + limb_conv(mu, m64)
    r = resolve_carries(torch.stack([s, s + rm_hi]), extra=1, passes=3).to(torch.int32)
    overflow = r[1][..., 2 * L, :] != 0  # quotient + R - m reached R: quotient >= m
    return select(overflow, r[1][..., L : 2 * L, :], r[0][..., L : 2 * L, :])
