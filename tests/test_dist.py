"""Multi-chip sharding on the virtual 8-device CPU mesh (SURVEY.md §4
'multi-node testing'): sharded outputs must be bit-identical to single-device
results."""

import random

import jax
import numpy as np
import pytest

from bn_tpu import curve, oracle as O, params as P
from bn_tpu.fields import tower
from bn_tpu.parallel import dist
from bn_tpu.ate import pairing_batch


@pytest.fixture(scope="module")
def inputs():
    random.seed(88)
    B = 8
    ps = [O.g1_mul(O.G1_ONE, random.randrange(1, P.R_SCALAR)) for _ in range(B)]
    qs = [O.g2_mul(O.G2_ONE, random.randrange(1, P.R_SCALAR)) for _ in range(B)]
    p = curve.to_device(curve.g1_spec(), ps)
    q = curve.to_device(curve.g2_spec(), qs)
    return p, q


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


@pytest.mark.slow
def test_sharded_pairing_bitexact(inputs):
    p, q = inputs
    mesh = dist.make_mesh(4)
    single = np.asarray(jax.jit(pairing_batch)(p, q))
    sharded = np.asarray(dist.sharded_pairing(mesh, p, q))
    assert np.array_equal(single, sharded)


@pytest.mark.slow
def test_sharded_pairing_product(inputs):
    p, q = inputs
    mesh = dist.make_mesh(4)
    out = dist.sharded_pairing_product(mesh, p, q)
    got = tower.fq12_from_device(np.asarray(out))[0]
    # expected: product of individual pairings via oracle
    ps = curve.from_device(curve.g1_spec(), p)
    qs = curve.from_device(curve.g2_spec(), q)
    expect = O.FQ12_ONE
    for pp, qq in zip(ps, qs):
        expect = O.fq12_mul(expect, O.pairing(pp, qq))
    assert got == expect


@pytest.mark.slow
def test_sharded_msm_matches_oracle():
    """Shard-and-add MSM over a 4-device mesh vs the host oracle; uneven
    shard sizes exercise the padding path."""
    random.seed(90)
    n = 21  # not divisible by 4 -> uneven shards
    points = [O.g1_mul(O.G1_ONE, random.randrange(1, P.R_SCALAR)) for _ in range(n)]
    scalars = [random.randrange(P.R_SCALAR) for _ in range(n)]
    mesh = dist.make_mesh(4)
    got_pt = dist.sharded_msm(mesh, points, scalars, c=5)
    got = curve.from_device(curve.g1_spec(), got_pt)[0]

    from bn_tpu.msm import msm_oracle

    expect = msm_oracle(points, scalars)
    assert O.g_eq(O.FQ_OPS, got, expect)


def test_fold_product_odd_batch():
    random.seed(89)
    vals = []
    for _ in range(5):
        el = tuple(
            tuple(
                (random.randrange(P.Q), random.randrange(P.Q)) for _ in range(3)
            )
            for _ in range(2)
        )
        vals.append(el)
    dev = tower.fq12_to_device(vals)
    got = tower.fq12_from_device(np.asarray(jax.jit(dist.fq12_fold_product)(dev)))[0]
    expect = O.FQ12_ONE
    for v in vals:
        expect = O.fq12_mul(expect, v)
    assert got == expect
