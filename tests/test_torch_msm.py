"""The port's Pippenger MSM on CPU tensors: the port of tests/test_msm.py, the
host schedule against bn_tpu.msm's on the same scalars, and one whole MSM
against the JAX package, limb for limb.

The JAX call is `bn_tpu.msm.msm` at n = 7, c = 4 on the very points and
scalars tests/test_msm.py draws for that case (random.seed(66), same order of
draws), so it reuses that test's compiled program.  Tolerance: none.
"""

import random

import numpy as np
import pytest
import torch

from bn_tpu import msm as jmsm
from bn_tpu_torch import convert, curve, msm
from bn_tpu_torch import oracle as O
from bn_tpu_torch import params as P
from bn_tpu_torch.ops import backend, build

torch.set_num_threads(1)  # tiny tensors: threads only add overhead

CPU = "cpu"


def _draws():
    """The random draws of tests/test_msm.py in its order: five scalars, fifty
    scalars, then (points' scalars, scalars) for n = 1, 7, 33."""
    rng = random.Random(66)
    out = {"five": [rng.randrange(P.R_SCALAR) for _ in range(5)], "fifty": [rng.randrange(P.R_SCALAR) for _ in range(50)]}
    for n in (1, 7, 33):
        ks = [rng.randrange(1, P.R_SCALAR) for _ in range(n)]
        scalars = [rng.randrange(P.R_SCALAR) for _ in range(n)]
        if n > 2:
            scalars[1] = 0
            scalars[2] = 1
        out[n] = (ks, scalars)
    return out


DRAWS = _draws()


def test_digit_extraction():
    scalars = DRAWS["five"] + [0, 1]
    sc16 = msm.scalars_to_u16(scalars)
    for c in (4, 13):
        digits = msm.extract_digits(sc16, c)
        for i, s in enumerate(scalars):
            assert sum(int(digits[k, i]) << (c * k) for k in range(digits.shape[0])) == s


def test_schedule_covers_all_points():
    digits = msm.extract_digits(msm.scalars_to_u16(DRAWS["fifty"]), 4)
    idx = msm.build_schedule(digits, 4)
    for k in range(idx.shape[0]):
        scheduled = idx[k][idx[k] != 50]
        assert sorted(scheduled.tolist()) == sorted(np.nonzero(digits[k])[0].tolist())


@pytest.mark.parametrize("c,r_cap", [(4, None), (4, 2), (13, 3), (16, 1)])
def test_host_schedule_equals_the_jax_package(c, r_cap):
    """Every host function on the same scalars, a skewed half included so
    that the capped schedules spill."""
    scalars = DRAWS["fifty"][:25] + [DRAWS["five"][0]] * 25
    sc16 = msm.scalars_to_u16(scalars)
    assert np.array_equal(sc16, jmsm.scalars_to_u16(scalars))
    digits = msm.extract_digits(sc16, c)
    assert np.array_equal(digits, jmsm.extract_digits(sc16, c))
    for got, want in zip(msm.build_schedule_capped(digits, c, r_cap), jmsm.build_schedule_capped(digits, c, r_cap)):
        assert np.array_equal(got, want)
    cap = msm.default_r_cap(len(scalars), c) if r_cap is None else r_cap
    assert cap == (jmsm.default_r_cap(len(scalars), c) if r_cap is None else r_cap)
    (first, spills), (jfirst, jspills) = msm.build_rounds(scalars, c, cap), jmsm.build_rounds(scalars, c, cap)
    assert np.array_equal(first, jfirst) and len(spills) == len(jspills)
    assert len(spills) > 0  # the skewed half overflows a bucket even under the default cap
    for (wk, idx), (jwk, jidx) in zip(spills, jspills):
        assert wk == jwk and np.array_equal(idx, jidx)


def test_auto_c_scales_with_n():
    assert [msm.auto_c(n) for n in (1, 33, 1 << 10, 1 << 16, 1 << 20)] == [4, 4, 7, 13, 16]
    assert all(msm.auto_c(1 << k) == jmsm.auto_c(1 << k) for k in range(22))
    assert all(msm.auto_c(1 << k) <= msm.auto_c(1 << (k + 1)) for k in range(21))
    assert msm.DEFAULT_C == jmsm.DEFAULT_C


@pytest.fixture(scope="module")
def msm_results():
    """The port's MSM for n = 1, 7, 33 at c = 4 on the CPU."""
    out = {}
    for n in (1, 7, 33):
        ks, scalars = DRAWS[n]
        pts = [O.g1_mul(O.G1_ONE, k) for k in ks]
        out[n] = (pts, scalars, msm.msm(pts, scalars, c=4, device=CPU))
    return out


@pytest.mark.parametrize("n", [1, 7, 33])
def test_msm_matches_oracle(msm_results, n):
    pts, scalars, res = msm_results[n]
    assert res[0].shape == (16, 1) and res[0].device.type == "cpu"
    got = curve.from_device(curve.g1_spec(), res)[0]
    assert O.g_eq(O.FQ_OPS, got, msm.msm_oracle(pts, scalars))


def test_msm_has_the_limbs_of_the_jax_package(msm_results):
    pts, scalars, res = msm_results[7]
    want = jmsm.msm(pts, scalars, c=4)
    for got, w in zip(convert.to_numpy(res), want):
        assert np.array_equal(got, np.asarray(w))


def test_msm_spill_path_matches_oracle_on_both_group_law_paths():
    """Skewed scalars (identical digits pile into one bucket) under r_cap = 2
    force window-local spill rounds; the result is exact, and the same limbs
    with the `curve_kernels` switch off.  The repeated scalar has two non-zero
    digits, so two windows overflow by far and a few more by chance: some
    twenty spill rounds, not the three hundred a full-width one would cost."""
    rng = random.Random(67)
    n = 24
    pts = [O.g1_mul(O.G1_ONE, rng.randrange(1, P.R_SCALAR)) for _ in range(n)]
    skew = 0xB000_0000_0000_0007
    scalars = [skew] * (n // 2) + [rng.randrange(P.R_SCALAR) for _ in range(n - n // 2)]
    first, spills = msm.build_rounds(scalars, c=4, r_cap=2)
    assert 10 <= len(spills) <= 60 and first.shape[-1] <= 2
    assert all(idx.shape == (1, 16, 2) for _, idx in spills)
    build.reset_counts()
    res = msm.msm(pts, scalars, c=4, r_cap=2, device=CPU)
    assert O.g_eq(O.FQ_OPS, curve.from_device(curve.g1_spec(), res)[0], msm.msm_oracle(pts, scalars))
    px, py, pz = msm.host_points_to_affine_arrays(pts, CPU)
    assert px.shape == (16, n + 1) and bool((pz[:, -1] == 0).all())
    # the accumulation on the per-field-op law (the reduce is shared code)
    spec = curve.g1_spec()
    acc = {}
    for on in (True, False):
        with backend.fusions(curve_kernels=on):
            a = msm._accumulate_rounds(px, py, pz, torch.from_numpy(first), curve.zero(spec, (64 * 16,), CPU))
            wk, idx = spills[0]
            acc[on] = msm._accumulate_window(px, py, pz, torch.from_numpy(idx), a, wk, 16)
    assert all(torch.equal(a, b) for a, b in zip(acc[True], acc[False]))
    assert sum(build.COUNTS.values()) == 0  # CPU tensors launch nothing
