"""The port's pairing pipeline on CPU tensors: against the reference's literal
G2Precomp vector, against the oracle copy, and — the slice as a whole —
against the JAX package limb for limb, in three configurations of
ops/backend.py (fused, the default; unfused; and the fused configuration with
the Miller-step kernel).  Tolerance: none."""

import random

import jax
import numpy as np
import pytest
import torch

from bn_tpu import ate as JATE
from bn_tpu import curve as jcurve
from bn_tpu import oracle as JO
from bn_tpu_torch import ate, convert, curve
from bn_tpu_torch import oracle as O
from bn_tpu_torch import params as P
from bn_tpu_torch.fields import fp
from bn_tpu_torch.fields import tower as T
from bn_tpu_torch.ops import backend, build

import vectors_g2_precomp as V
from test_oracle import S1, S2

CPU = "cpu"
UNFUSED = dict(pow_fixed=False, cyclo_chain=False, ladder=False)


@pytest.fixture(scope="module")
def fixed_points():
    return O.g1_mul(O.G1_ONE, S1), O.g2_mul(O.G2_ONE, S2)


@pytest.fixture(scope="module")
def precomputed():
    """Coefficients of two lanes: the golden-vector point and another one."""
    qa = O.g_to_affine(O.FQ2_OPS, O.g2_mul(O.G2_ONE, V.SCALAR))
    qb = O.g_to_affine(O.FQ2_OPS, O.g2_mul(O.G2_ONE, 12345))
    dq = (T.fq2_to_device([qa[0], qb[0]], CPU), T.fq2_to_device([qa[1], qb[1]], CPU))
    return (qa, qb), ate.precompute(dq)


def test_precompute_matches_reference_literals(precomputed):
    (qa, _), coeffs = precomputed
    assert (qa[0], qa[1]) == (V.Q_X, V.Q_Y)
    assert tuple(coeffs.shape) == (102, 3, 2, 16, 2) and len(V.COEFFS) == 102
    for k, want in enumerate(V.COEFFS):
        got = tuple(T.fq2_from_device(coeffs[k, ci])[0] for ci in range(3))
        assert got == want, f"coeff {k}"


def test_precompute_matches_oracle_on_other_lane(precomputed):
    (_, qb), coeffs = precomputed
    expect = O.precompute_g2(qb)
    for k in range(102):
        got = tuple(T.fq2_from_device(coeffs[k, ci])[1] for ci in range(3))
        assert got == tuple(expect[k]), f"coeff {k}"


def test_precompute_fused_equals_unfused_whole_tensor(precomputed):
    """Three lanes — the golden-vector point, another one, and what to_affine
    makes of an infinite Q (a point the steps were never meant for, masked
    later) — through both ladders: every limb of (102, 3, 2, 16, 3) equal."""
    (qa, qb), coeffs = precomputed
    g2s = curve.g2_spec()
    pts = [(qa[0], qa[1], O.FQ2_ONE), (qb[0], qb[1], O.FQ2_ONE), O.g_zero(O.FQ2_OPS)]
    dq = curve.to_affine(g2s, curve.to_device(g2s, pts, CPU))
    build.reset_counts()
    fused = ate.precompute(dq)
    with backend.fusions(ladder=False):
        unfused = ate.precompute(dq)
    assert sum(build.COUNTS.values()) == 0  # CPU tensors launch nothing
    assert tuple(fused.shape) == (102, 3, 2, 16, 3) and torch.equal(fused, unfused)
    assert torch.equal(fused[..., :2], coeffs)


def test_precompute_fused_keeps_leading_batch_axes_where_the_unfused_does():
    qs = [O.g_to_affine(O.FQ2_OPS, O.g2_mul(O.G2_ONE, k)) for k in (3, 5, 7, 11)]
    bx, by = (T.fq2_to_device([q[i] for q in qs], CPU).reshape(2, 16, 2, 2).permute(2, 0, 1, 3) for i in range(2))
    fused = ate.precompute((bx, by))
    with backend.fusions(ladder=False):
        unfused = ate.precompute((bx, by))
    assert tuple(fused.shape) == (102, 3, 2, 2, 16, 2) and torch.equal(fused, unfused)


def test_miller_loop(fixed_points):
    g1, g2 = fixed_points
    pa = O.g_to_affine(O.FQ_OPS, g1)
    qa = O.g_to_affine(O.FQ2_OPS, g2)
    dq = (T.fq2_to_device([qa[0]], CPU), T.fq2_to_device([qa[1]], CPU))
    dp = (fp.to_device(fp.FQ, [pa[0]], CPU), fp.to_device(fp.FQ, [pa[1]], CPU))
    f = ate.miller_loop(ate.precompute(dq), dp)
    assert T.fq12_from_device(f)[0] == O.miller_loop(O.precompute_g2(qa), pa)


def test_miller_batch_then_final_exponentiation_is_pairing(fixed_points):
    g1, g2 = fixed_points
    dp = curve.to_device(curve.g1_spec(), [g1], CPU)
    dq = curve.to_device(curve.g2_spec(), [g2], CPU)
    f = ate.miller_batch(dp, dq)
    assert T.fq12_from_device(T.final_exponentiation(f))[0] == O.pairing(g1, g2)


@pytest.fixture(scope="module")
def four_pairs(fixed_points):
    """The golden-vector pair, a random pair, and the two degenerate pairs."""
    g1, g2 = fixed_points
    random.seed(77)
    p2 = O.g1_mul(O.G1_ONE, random.randrange(P.R_SCALAR))
    q2 = O.g2_mul(O.G2_ONE, random.randrange(P.R_SCALAR))
    inf1, inf2 = O.g_zero(O.FQ_OPS), O.g_zero(O.FQ2_OPS)
    return [g1, p2, inf1, g1], [g2, q2, q2, inf2]


@pytest.fixture(scope="module")
def four_pairs_out(four_pairs):
    """pairing_batch as a caller gets it: every fusion on."""
    ps, qs = four_pairs
    assert backend.pow_fixed and backend.cyclo_chain and backend.ladder
    build.reset_counts()
    out = ate.pairing_batch(curve.to_device(curve.g1_spec(), ps, CPU), curve.to_device(curve.g2_spec(), qs, CPU))
    assert sum(build.COUNTS.values()) == 0  # CPU tensors launch nothing
    return out


@pytest.fixture(scope="module")
def jax_four_pairs(four_pairs):
    """The same four pairs as JAX arrays and through jax.jit(pairing_batch):
    the one pairing-sized JAX compile of the port's tests (same shapes as
    tests/test_pairing.py, so the compile cache is shared)."""
    ps, qs = four_pairs
    jp = jcurve.to_device(jcurve.g1_spec(), ps)
    jq = jcurve.to_device(jcurve.g2_spec(), qs)
    return jp, jq, np.asarray(jax.jit(JATE.pairing_batch)(jp, jq))


@pytest.fixture(scope="module")
def four_pairs_out_unfused(jax_four_pairs):
    """The unfused configuration, on the JAX arrays themselves carried across."""
    jp, jq, _ = jax_four_pairs
    tp = convert.from_jax(tuple(np.asarray(x) for x in jp), device=CPU)
    tq = convert.from_jax(tuple(np.asarray(x) for x in jq), device=CPU)
    build.reset_counts()
    with backend.fusions(**UNFUSED):
        out = ate.pairing_batch(tp, tq)
    assert sum(build.COUNTS.values()) == 0
    return out


@pytest.fixture(scope="module")
def four_pairs_out_miller(jax_four_pairs):
    """The fused configuration with `miller_step` on: one Miller-step kernel
    per ladder step, on the JAX arrays carried across."""
    jp, jq, _ = jax_four_pairs
    tp = convert.from_jax(tuple(np.asarray(x) for x in jp), device=CPU)
    tq = convert.from_jax(tuple(np.asarray(x) for x in jq), device=CPU)
    build.reset_counts()
    with backend.fusions(miller_step=True):
        out = ate.pairing_batch(tp, tq)
    assert sum(build.COUNTS.values()) == 0
    return out


def test_reduced_pairing_against_oracle(four_pairs, four_pairs_out):
    ps, qs = four_pairs
    assert T.fq12_from_device(four_pairs_out) == [O.pairing(p, q) for p, q in zip(ps, qs)]


def test_infinity_lanes_give_gt_one(four_pairs_out):
    got = T.fq12_from_device(four_pairs_out)
    assert got[2] == O.FQ12_ONE and got[3] == O.FQ12_ONE
    assert got[0] != O.FQ12_ONE and got[1] != O.FQ12_ONE


def test_slice_equals_jax_package(four_pairs, four_pairs_out, four_pairs_out_unfused, four_pairs_out_miller,
                                  jax_four_pairs):
    """The whole slice: the same four pairs through jax.jit(pairing_batch)
    and through the port in all three configurations; all (2, 3, 2, 16, 4)
    limbs equal."""
    ps, qs = four_pairs
    want = jax_four_pairs[2]
    fused = convert.to_numpy(four_pairs_out)
    unfused = convert.to_numpy(four_pairs_out_unfused)
    miller = convert.to_numpy(four_pairs_out_miller)
    assert want.shape == (2, 3, 2, 16, 4) and fused.shape == want.shape
    assert np.array_equal(fused, want)
    assert np.array_equal(unfused, want)
    assert np.array_equal(miller, want)
    assert JO.pairing(ps[0], qs[0]) == T.fq12_from_device(four_pairs_out)[0]


def test_unfused_pairing_against_oracle(four_pairs, four_pairs_out_unfused):
    ps, qs = four_pairs
    assert T.fq12_from_device(four_pairs_out_unfused) == [O.pairing(p, q) for p, q in zip(ps, qs)]


def test_bilinearity():
    random.seed(99)
    s, kp, kq = (random.randrange(P.R_SCALAR) for _ in range(3))
    p, q = O.g1_mul(O.G1_ONE, kp), O.g2_mul(O.G2_ONE, kq)
    dp = curve.to_device(curve.g1_spec(), [O.g1_mul(p, s), p], CPU)
    dq = curve.to_device(curve.g2_spec(), [q, O.g2_mul(q, s)], CPU)
    out = T.fq12_from_device(ate.pairing_batch(dp, dq))
    assert out[0] == out[1] == O.fq12_pow(O.pairing(p, q), s)
