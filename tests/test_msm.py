"""Pippenger MSM vs the naive oracle sum (new capability; BASELINE.md)."""

import random

import numpy as np
import pytest

from bn_tpu import curve, msm, oracle as O, params as P


@pytest.fixture(scope="module")
def rng():
    random.seed(66)
    return random


def test_digit_extraction(rng):
    scalars = [rng.randrange(P.R_SCALAR) for _ in range(5)] + [0, 1]
    sc16 = msm.scalars_to_u16(scalars)
    for c in (4, 13):
        digits = msm.extract_digits(sc16, c)
        for i, s in enumerate(scalars):
            rec = sum(int(digits[k, i]) << (c * k) for k in range(digits.shape[0]))
            assert rec == s


def test_schedule_covers_all_points(rng):
    scalars = [rng.randrange(P.R_SCALAR) for _ in range(50)]
    digits = msm.extract_digits(msm.scalars_to_u16(scalars), 4)
    idx = msm.build_schedule(digits, 4)
    w, nb, r = idx.shape
    for k in range(w):
        scheduled = idx[k][idx[k] != 50]
        nonzero = np.nonzero(digits[k])[0]
        assert sorted(scheduled.tolist()) == sorted(nonzero.tolist())


@pytest.mark.slow
@pytest.mark.parametrize("n", [1, 7, 33])
def test_msm_matches_oracle(rng, n):
    pts = [O.g1_mul(O.G1_ONE, rng.randrange(1, P.R_SCALAR)) for _ in range(n)]
    scalars = [rng.randrange(P.R_SCALAR) for _ in range(n)]
    if n > 2:
        scalars[1] = 0
        scalars[2] = 1
    got = curve.from_device(curve.g1_spec(), msm.msm(pts, scalars, c=4))[0]
    expect = msm.msm_oracle(pts, scalars)
    assert O.g_eq(O.FQ_OPS, got, expect)


@pytest.mark.slow
def test_msm_spill_path_matches_oracle(rng):
    """Window-local spill scheduling (build_rounds + _accumulate_window with
    a traced window index): force spills with a tiny r_cap and SKEWED
    scalars (identical digits pile into one bucket, the adversarial case the
    occupancy cap exists for) and check exactness against the oracle."""
    n = 24
    pts = [O.g1_mul(O.G1_ONE, rng.randrange(1, P.R_SCALAR)) for _ in range(n)]
    # half the scalars identical -> one bucket holds 12 entries; r_cap=2
    # forces ceil(12/2)-1 = 5 spill rounds on that bucket's window(s)
    skew = rng.randrange(1, P.R_SCALAR)
    scalars = [skew] * (n // 2) + [
        rng.randrange(P.R_SCALAR) for _ in range(n - n // 2)
    ]
    first, spills = msm.build_rounds(scalars, c=4, r_cap=2)
    assert len(spills) > 0, "r_cap=2 with 12 identical scalars must spill"
    assert first.shape[-1] <= 2
    got = curve.from_device(
        curve.g1_spec(), msm.msm(pts, scalars, c=4, r_cap=2)
    )[0]
    expect = msm.msm_oracle(pts, scalars)
    assert O.g_eq(O.FQ_OPS, got, expect)


def test_auto_c_scales_with_n():
    assert msm.auto_c(1) == 4
    assert msm.auto_c(33) == 4
    assert msm.auto_c(1 << 10) == 7
    assert msm.auto_c(1 << 16) == 13
    assert msm.auto_c(1 << 20) == 16
    # monotone non-decreasing
    last = 0
    for k in range(21):
        c = msm.auto_c(1 << k)
        assert c >= last
        last = c
