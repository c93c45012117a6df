"""Device pairing pipeline vs the oracle (itself pinned to the reference's
golden vectors): precompute, Miller loop, full reduced pairing, degenerate
inputs, bilinearity (src/groups/mod.rs:522-547, 637-762, 773-823)."""

import random

import jax
import numpy as np
import pytest

from bn_tpu import ate as PRG, curve, oracle as O, params as P
from bn_tpu.fields import fp, tower as T

S1 = 18097487326282793650237947474982649264364522469319914492172746413872781676
S2 = 20390255904278144451778773028944684152769293537511418234311120800877067946


@pytest.fixture(scope="module")
def fixed_points():
    g1 = O.g1_mul(O.G1_ONE, S1)
    g2 = O.g2_mul(O.G2_ONE, S2)
    return g1, g2


def test_precompute_vector(fixed_points):
    """All 102 line coefficients vs the oracle (the oracle's are asserted
    against the reference's G2Precomp golden vector semantics in
    test_oracle.py via the miller/pairing vectors)."""
    _, g2 = fixed_points
    qa = O.g_to_affine(O.FQ2_OPS, g2)
    expect = O.precompute_g2(qa)

    dq = (T.fq2_to_device([qa[0]]), T.fq2_to_device([qa[1]]))
    coeffs = jax.jit(PRG.precompute)(dq)
    assert coeffs.shape[0] == 102
    got = np.asarray(coeffs)
    for k in range(102):
        for ci, name in enumerate(("ell_0", "ell_vw", "ell_vv")):
            g = T.fq2_from_device(got[k, ci])[0]
            assert g == expect[k][ci], (k, name)


def test_miller_loop(fixed_points):
    g1, g2 = fixed_points
    pa = O.g_to_affine(O.FQ_OPS, g1)
    qa = O.g_to_affine(O.FQ2_OPS, g2)
    dq = (T.fq2_to_device([qa[0]]), T.fq2_to_device([qa[1]]))
    dp = (fp.to_device(fp.FQ, [pa[0]]), fp.to_device(fp.FQ, [pa[1]]))
    f = jax.jit(lambda q, p: PRG.miller_loop(PRG.precompute(q), p))(dq, dp)
    assert T.fq12_from_device(f)[0] == O.miller_loop(O.precompute_g2(qa), pa)


@pytest.mark.slow
def test_reduced_pairing_batch(fixed_points):
    """Batch containing the golden-vector pair, a random pair, and degenerate
    (infinity) pairs — all in one call."""
    g1, g2 = fixed_points
    random.seed(77)
    p2 = O.g1_mul(O.G1_ONE, random.randrange(P.R_SCALAR))
    q2 = O.g2_mul(O.G2_ONE, random.randrange(P.R_SCALAR))
    inf1, inf2 = O.g_zero(O.FQ_OPS), O.g_zero(O.FQ2_OPS)

    ps = [g1, p2, inf1, g1]
    qs = [g2, q2, q2, inf2]
    dp = curve.to_device(curve.g1_spec(), ps)
    dq = curve.to_device(curve.g2_spec(), qs)
    out = jax.jit(PRG.pairing_batch)(dp, dq)
    got = T.fq12_from_device(out)
    expect = [O.pairing(p, q) for p, q in zip(ps, qs)]
    assert got == expect


@pytest.mark.slow
def test_bilinearity_device():
    random.seed(99)
    s = random.randrange(P.R_SCALAR)
    kp = random.randrange(P.R_SCALAR)
    kq = random.randrange(P.R_SCALAR)
    p = O.g1_mul(O.G1_ONE, kp)
    q = O.g2_mul(O.G2_ONE, kq)
    sp = O.g1_mul(p, s)
    sq = O.g2_mul(q, s)
    dp = curve.to_device(curve.g1_spec(), [sp, p])
    dq = curve.to_device(curve.g2_spec(), [q, sq])
    out = T.fq12_from_device(jax.jit(PRG.pairing_batch)(dp, dq))
    assert out[0] == out[1]
    assert out[0] == O.fq12_pow(O.pairing(p, q), s)
