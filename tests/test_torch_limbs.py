"""The plain limb engine (bn_tpu_torch/ops/limbs.py) against Python integers
and against a column-by-column Montgomery reduction kept here for the purpose.

The engine is the arithmetic of every kernel's plain version, so it is held to
the integers themselves: edge values (0, 1, m-1, m-1 squared, values whose
limbs are all 0xFFFF or all 0 but one), long carry and borrow chains, both
moduli, and a seeded random batch.  Tolerance: none.
"""

import numpy as np
import pytest
import torch

from bn_tpu_torch import params as TP
from bn_tpu_torch.ops import limbs as L

MODULI = {"Fq": TP.Q, "Fr": TP.R_SCALAR}
R = 1 << 256
MASK = TP.LIMB_MASK


def _tensor(vals):
    return torch.from_numpy(TP.ints_to_limbs(vals).astype(np.int32))


def _ints(t):
    return TP.limbs_to_ints(t.numpy().astype(np.uint32))


def _edge_values(m, seed):
    """Values in [0, m) that stress the carries: the ends of the range, the
    largest value of all-0xFFFF low limbs below m, single-limb values, limbs of
    0xFFFF next to limbs of 0, and random ones."""
    top = m >> 240
    vals = [0, 1, 2, m - 1, m - 2, (m - 1) // 2, (m + 1) // 2, R % m, (R - 1) % m, R * R % m]
    vals += [((top - 1) << 240) | ((1 << 240) - 1), (1 << 240) - 1, (1 << 128) - 1, 1 << 128]
    vals += [1 << (16 * k) for k in range(16) if (1 << (16 * k)) < m]
    vals += [MASK << (16 * k) for k in range(15)]
    vals += [sum(MASK << (32 * k) for k in range(8)) % m, sum(MASK << (32 * k + 16) for k in range(8)) % m]
    rng = np.random.default_rng(seed)
    vals += [int.from_bytes(rng.bytes(40), "big") % m for _ in range(24)]
    assert all(0 <= v < m for v in vals)
    return vals


def _pairs(m, seed):
    """Every edge value against every other, as two flat lists."""
    vals = _edge_values(m, seed)
    return [a for a in vals for _ in vals], [b for _ in vals for b in vals]


def _mont_mul_by_columns(a, b, m):
    """The column-by-column reduction (word 2^16): for each low column i add
    mu_i * m shifted by i with mu_i = T_i * (-m^-1) mod 2^16, so the column
    clears, and push its carry up; then one carry sweep and one conditional
    subtraction.  On int64 numpy arrays (16, B), limb by limb on purpose."""
    m_limbs = TP.int_to_limbs(m).astype(np.int64)
    inv = (-pow(m, -1, 1 << 16)) % (1 << 16)
    n = a.shape[-1]
    t = np.zeros((33, n), np.int64)
    for i in range(16):
        t[i : i + 16] += a[i] * b
    for i in range(16):
        mu = ((t[i] & MASK) * inv) & MASK
        t[i : i + 16] += mu * m_limbs[:, None]
        t[i + 1] += t[i] >> 16
    hi = t[16:].copy()
    for k in range(16):
        hi[k + 1] += hi[k] >> 16
        hi[k] &= MASK
    vals = [sum(int(hi[k, j]) << (16 * k) for k in range(17)) for j in range(n)]
    return [v - m if v >= m else v for v in vals]


@pytest.mark.parametrize("field", list(MODULI))
def test_mont_mul_equals_the_integers_on_edge_values(field):
    m = MODULI[field]
    xs, ys = _pairs(m, 1)
    got = _ints(L.mont_mul(_tensor(xs), _tensor(ys), TP.int_to_limbs(m)))
    r_inv = pow(R, -1, m)
    assert got == [x * y * r_inv % m for x, y in zip(xs, ys)]


@pytest.mark.parametrize("field", list(MODULI))
def test_mont_mul_equals_the_reduction_by_columns(field):
    m = MODULI[field]
    xs, ys = _pairs(m, 2)
    a, b = TP.ints_to_limbs(xs).astype(np.int64), TP.ints_to_limbs(ys).astype(np.int64)
    got = _ints(L.mont_mul(_tensor(xs), _tensor(ys), TP.int_to_limbs(m)))
    assert got == _mont_mul_by_columns(a, b, m)


@pytest.mark.parametrize("field", list(MODULI))
def test_mont_mul_broadcasts_over_lead_axes_and_a_constant(field):
    m = MODULI[field]
    vals = _edge_values(m, 3)[:48]
    a = _tensor(vals).reshape(16, 2, 3, 8).permute(1, 2, 0, 3).contiguous()  # (2, 3, 16, 8)
    k = _tensor([m - 1])  # (16, 1)
    got = L.mont_mul(a, k, TP.int_to_limbs(m))
    assert got.shape == a.shape and got.dtype == torch.int32
    flat = got.permute(2, 0, 1, 3).reshape(16, 48)
    assert _ints(flat) == [v * (m - 1) * pow(R, -1, m) % m for v in vals]


@pytest.mark.parametrize("field", list(MODULI))
@pytest.mark.parametrize("op", ["add", "sub", "neg"])
def test_mod_add_sub_neg_equal_the_integers_on_edge_values(field, op):
    m = MODULI[field]
    xs, ys = _pairs(m, 4)
    a, b, ml = _tensor(xs), _tensor(ys), TP.int_to_limbs(m)
    if op == "add":
        assert _ints(L.mod_add(a, b, ml)) == [(x + y) % m for x, y in zip(xs, ys)]
    elif op == "sub":
        assert _ints(L.mod_sub(a, b, ml)) == [(x - y) % m for x, y in zip(xs, ys)]
    else:
        assert _ints(L.mod_neg(a, ml)) == [(-x) % m for x in xs]


def test_sub_limbs_borrows_through_a_whole_row_of_zeros():
    xs = [0, 1 << 240, 1 << 255, R - 1, 5, 1 << 128]
    ys = [1, 1, R - 1, R - 1, 5, (1 << 128) + 1]
    d, borrow = L.sub_limbs(_tensor(xs), _tensor(ys))
    assert _ints(d) == [(x - y) % R for x, y in zip(xs, ys)]
    assert borrow.tolist() == [int(x < y) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("columns", [16, 32, 61])
def test_resolve_carries_settles_the_longest_chains(columns):
    """Columns of 0xFFFF with one carry entering at the bottom, columns of
    2^16 + 1 throughout, and the largest columns three passes allow."""
    chain = np.full((columns, 1), MASK, np.int64)
    chain[0, 0] = MASK + 1
    full = np.full((columns, 1), (1 << 16) + 1, np.int64)
    big = np.full((columns, 1), (1 << 48) - 1, np.int64)
    rng = np.random.default_rng(columns)
    rand = rng.integers(0, 1 << 48, size=(columns, 5), dtype=np.int64)
    cols = np.concatenate([chain, full, big, rand], axis=1)
    want = [sum(int(c) << (16 * k) for k, c in enumerate(cols[:, j])) for j in range(cols.shape[1])]
    got = L.resolve_carries(torch.from_numpy(cols), extra=1, passes=3).numpy()
    assert got.shape[0] == columns + 1 and got.min() >= 0 and got.max() <= MASK
    # the integer, up to what leaves the one appended column
    assert [sum(int(c) << (16 * k) for k, c in enumerate(got[:, j])) for j in range(got.shape[1])] == [
        w % (1 << (16 * (columns + 1))) for w in want
    ]


def test_resolve_carries_refuses_more_columns_than_an_int64_packs():
    with pytest.raises(AssertionError):
        L.resolve_carries(torch.zeros((62, 1), dtype=torch.int64), extra=1)
