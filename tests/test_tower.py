"""Fq2/Fq6/Fq12 tower differentially tested against the host oracle (which is
itself pinned to the reference's golden vectors in test_oracle.py)."""

import random

import jax
import numpy as np
import pytest

from bn_tpu import oracle as O
from bn_tpu import params as P
from bn_tpu.fields import fp, tower as T

B = 3


@pytest.fixture(scope="module")
def rng():
    random.seed(33)
    return random


def rfq2(rng):
    return (rng.randrange(P.Q), rng.randrange(P.Q))


def rfq6(rng):
    return (rfq2(rng), rfq2(rng), rfq2(rng))


def rfq12(rng):
    return (rfq6(rng), rfq6(rng))


def fq6_from_device(arr):
    arr = np.asarray(arr)
    out = []
    for b in range(arr.shape[-1]):
        out.append(
            tuple(
                (
                    P.from_mont(P.limbs_to_int(arr[j, 0, :, b]), P.Q),
                    P.from_mont(P.limbs_to_int(arr[j, 1, :, b]), P.Q),
                )
                for j in range(3)
            )
        )
    return out


def test_fq2_ops(rng):
    a = [rfq2(rng) for _ in range(B)]
    b = [rfq2(rng) for _ in range(B)]
    da, db = T.fq2_to_device(a), T.fq2_to_device(b)
    assert T.fq2_from_device(jax.jit(T.fq2_mul)(da, db)) == [
        O.fq2_mul(x, y) for x, y in zip(a, b)
    ]
    assert T.fq2_from_device(jax.jit(T.fq2_sq)(da)) == [O.fq2_sq(x) for x in a]
    assert T.fq2_from_device(jax.jit(T.fq2_mul_by_xi)(da)) == [
        O.fq2_mul_by_xi(x) for x in a
    ]
    assert T.fq2_from_device(jax.jit(T.fq2_inv)(da)) == [O.fq2_inv(x) for x in a]
    assert T.fq2_from_device(jax.jit(T.fq2_conj)(da)) == [O.fq2_conj(x) for x in a]


def test_fq6_ops(rng):
    a = [rfq6(rng) for _ in range(B)]
    b = [rfq6(rng) for _ in range(B)]
    da, db = T.fq6_to_device(a), T.fq6_to_device(b)
    assert fq6_from_device(jax.jit(T.fq6_mul)(da, db)) == [
        O.fq6_mul(x, y) for x, y in zip(a, b)
    ]
    assert fq6_from_device(jax.jit(T.fq6_sq)(da)) == [O.fq6_sq(x) for x in a]
    assert fq6_from_device(jax.jit(T.fq6_inv)(da)) == [O.fq6_inv(x) for x in a]
    assert fq6_from_device(jax.jit(T.fq6_mul_by_nonresidue)(da)) == [
        O.fq6_mul_by_nonresidue(x) for x in a
    ]
    for pw in (1, 2, 3):
        assert fq6_from_device(jax.jit(lambda v, pw=pw: T.fq6_frob(v, pw))(da)) == [
            O.fq6_frob(x, pw) for x in a
        ]


@pytest.mark.slow
def test_fq12_ops(rng):
    a = [rfq12(rng) for _ in range(B)]
    b = [rfq12(rng) for _ in range(B)]
    da, db = T.fq12_to_device(a), T.fq12_to_device(b)
    assert T.fq12_from_device(jax.jit(T.fq12_mul)(da, db)) == [
        O.fq12_mul(x, y) for x, y in zip(a, b)
    ]
    assert T.fq12_from_device(jax.jit(T.fq12_sq)(da)) == [O.fq12_sq(x) for x in a]
    assert T.fq12_from_device(jax.jit(T.fq12_cyclotomic_sq)(da)) == [
        O.fq12_cyclotomic_sq(x) for x in a
    ]
    assert T.fq12_from_device(jax.jit(T.fq12_inv)(da)) == [O.fq12_inv(x) for x in a]
    assert T.fq12_from_device(jax.jit(T.fq12_conj)(da)) == [O.fq12_conj(x) for x in a]
    for pw in (1, 2, 3):
        assert T.fq12_from_device(jax.jit(lambda v, pw=pw: T.fq12_frob(v, pw))(da)) == [
            O.fq12_frob(x, pw) for x in a
        ]


def test_fq12_mul_by_024(rng):
    a = [rfq12(rng) for _ in range(B)]
    e0 = [rfq2(rng) for _ in range(B)]
    vw = [rfq2(rng) for _ in range(B)]
    vv = [rfq2(rng) for _ in range(B)]
    got = jax.jit(T.fq12_mul_by_024)(
        T.fq12_to_device(a), T.fq2_to_device(e0), T.fq2_to_device(vw), T.fq2_to_device(vv)
    )
    assert T.fq12_from_device(got) == [
        O.fq12_mul_by_024(x, u, v, w) for x, u, v, w in zip(a, e0, vw, vv)
    ]


def test_exp_by_neg_z(rng):
    a = [rfq12(rng) for _ in range(B)]
    da = T.fq12_to_device(a)
    got = jax.jit(T.fq12_exp_by_neg_z)(da)
    assert T.fq12_from_device(got) == [O.fq12_exp_by_neg_z(x) for x in a]


def test_final_exponentiation(rng):
    a = [rfq12(rng) for _ in range(B)]
    da = T.fq12_to_device(a)
    got = jax.jit(T.final_exponentiation)(da)
    assert T.fq12_from_device(got) == [O.final_exponentiation(x) for x in a]


@pytest.mark.slow
def test_final_exp_straight_matches_tape(rng):
    """The straight-line chain (_final_exp_straight) is what the Pallas
    backend runs, but CI uses the jnp backend, where final_exponentiation
    dispatches to the tape VM — so exercise the straight-line path directly
    against the oracle and the tape.  Run EAGERLY: under the jnp backend
    the straight-line trace inlines every op's limb expansion (~280k HLO),
    which is exactly the compile blowup the tape VM exists to avoid."""
    a = [rfq12(rng) for _ in range(B)]
    da = T.fq12_to_device(a)
    got = T._final_exp_straight(da)
    assert T.fq12_from_device(got) == [O.final_exponentiation(x) for x in a]
    tape = jax.jit(T.final_exponentiation)(da)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(tape))


@pytest.mark.slow
def test_exp_by_neg_z_cyclotomic_naf(rng):
    """The NAF conj-as-inverse ladder is only valid for cyclotomic inputs;
    feed it elements of the cyclotomic subgroup (easy-part outputs) and
    check against the plain binary ladder.  Eager for the same compile-cost
    reason as test_final_exp_straight_matches_tape."""
    raw = [rfq12(rng) for _ in range(B)]
    cyc = []
    for x in raw:
        t = O.fq12_mul(O.fq12_conj(x), O.fq12_inv(x))  # f^(q^6-1)
        cyc.append(O.fq12_mul(O.fq12_frob(t, 2), t))  # ... ^(q^2+1)
    da = T.fq12_to_device(cyc)
    got = T._exp_by_neg_z_cyclotomic(da)
    assert T.fq12_from_device(got) == [O.fq12_exp_by_neg_z(x) for x in cyc]


def test_fq12_mul_slice_stack_regression():
    """Regression for an XLA:TPU miscompile: fq12_mul at batch >= 1024 with
    operands sliced+stacked from the (2,3,2,L,B) tensor produced wrong
    Karatsuba products until operands were materialized with an
    optimization_barrier (bn_tpu.fields.fp.mul).  Runs at batch 1024 so the
    failing configuration is covered on every backend."""
    rng = random.Random(101)
    B = 1024
    a = [rfq12(rng) for _ in range(B)]
    b = [rfq12(rng) for _ in range(B)]
    da, db = T.fq12_to_device(a), T.fq12_to_device(b)
    got = T.fq12_from_device(np.asarray(jax.jit(T.fq12_mul)(da, db))[..., ::97])
    expect = [O.fq12_mul(x, y) for x, y in list(zip(a, b))[::97]]
    assert got == expect
