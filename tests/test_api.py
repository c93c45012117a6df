"""Public API surface (reference: src/lib.rs) plus the two reference examples
as executable tests (examples/dh.rs, examples/joux.rs)."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

from bn_tpu import Fr, G1, G2, Gt, pairing
from bn_tpu import oracle as O, params as P


def test_fr_ops():
    a = Fr.from_ints([3, 5])
    b = Fr.from_ints([10, P.R_SCALAR - 1])
    assert (a + b).to_ints() == [13, 4]
    assert (a * b).to_ints() == [30, (5 * (P.R_SCALAR - 1)) % P.R_SCALAR]
    assert (-a).to_ints() == [P.R_SCALAR - 3, P.R_SCALAR - 5]
    assert (a - b).to_ints() == [(3 - 10) % P.R_SCALAR, 6]
    inv = a.inverse()
    assert (a * inv).to_ints() == [1, 1]
    assert Fr.from_str("1901").to_ints() == [1901]
    assert Fr.from_str("19x1") is None
    # -1 == from_str(r-1) (reference: test_str, src/fields/mod.rs:68-71)
    assert (-Fr.one()) == Fr.from_str(str(P.R_SCALAR - 1))


def test_fr_interpret():
    buf = (123456789).to_bytes(64, "big")
    assert Fr.interpret(buf).to_ints() == [123456789]
    big = ((1 << 512) - 1).to_bytes(64, "big")
    assert Fr.interpret(big).to_ints() == [((1 << 512) - 1) % P.R_SCALAR]


def test_fr_pow():
    a = Fr.from_ints([3])
    e = Fr.from_ints([20])
    assert a.pow(e).to_ints() == [pow(3, 20, P.R_SCALAR)]


def test_group_api():
    k = Fr.from_ints([5, 7])
    p = G1.one(2) * k
    expect = [O.g1_mul(O.G1_ONE, 5), O.g1_mul(O.G1_ONE, 7)]
    for g, e in zip(p.to_oracle(), expect):
        assert O.g_eq(O.FQ_OPS, g, e)
    assert (p - p).is_zero().all()
    assert (p + G1.zero(2)) == p
    n = p.normalize()
    assert n == p
    # normalized z == 1 (or 0 at infinity)
    zs = n.dev[2]
    assert (G1.zero(2).normalize()).is_zero().all()


@pytest.mark.slow
def test_pairing_api_bilinear():
    s = Fr.from_ints([12345])
    p = G1.one(1) * Fr.from_ints([777])
    q = G2.one(1) * Fr.from_ints([888])
    a = pairing(p * s, q)
    b = pairing(p, q * s)
    c = pairing(p, q).pow(s)
    assert a == b and b == c
    assert not (a == Gt.one())
    assert a * a.inverse() == Gt.one()


@pytest.mark.slow
def test_serialization_api():
    p = G1.random(3, 2)
    round_ = G1.from_bytes(p.to_bytes())
    assert round_ == p
    q = G2.random(4, 2)
    assert G2.from_bytes(q.to_bytes()) == q
    s = Fr.random(5, 3)
    assert Fr.from_bytes(s.to_bytes()) == s
    assert not hasattr(Gt, "to_bytes")  # Gt is not serializable (lib.rs:165)


def test_example_dh():
    import dh

    dh.main(batch=2, seed=21)


@pytest.mark.slow
def test_example_joux():
    import joux

    joux.main(batch=2, seed=31)
