"""Differential tests of the fused Jacobian group-law kernels
(ops/curve_pallas.py) against the jnp reference path in curve.py.

Tier-1 style (cf. tests/test_pallas_interpret.py): the kernel formulas run
directly as register algebra on (8, 128) tiles — no Pallas interpreter
needed — and must match curve.add / curve.double bit-exactly, including
every degenerate case the reference handles by branching
(src/groups/mod.rs:272-312): P+∞, ∞+Q, ∞+∞, P+P (falls into double),
P+(−P) (→ ∞), and doubling the point at infinity.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from bn_tpu import curve, oracle as O, params as P
from bn_tpu.fields import fp, tower
from bn_tpu.ops import curve_pallas as cp
from bn_tpu.params import NLIMBS

B = 1024
RNG = np.random.default_rng(4242)

Q_CONST = [np.uint32(int(v)) for v in fp.FQ.m_limbs]
INV_CONST = np.uint32(int(fp.FQ.inv))


def _mk_points(spec, n=B):
    """n pseudo-random points incl. forced degenerate pairs in known lanes."""
    mul = O.g1_mul if spec.name == "G1" else O.g2_mul
    gen = O.G1_ONE if spec.name == "G1" else O.G2_ONE
    ks1 = [3 + int(RNG.integers(1, 1 << 62)) for _ in range(n)]
    ks2 = [5 + int(RNG.integers(1, 1 << 62)) for _ in range(n)]
    p_host = [mul(gen, k) for k in ks1]
    q_host = [mul(gen, k) for k in ks2]
    zero = O.g_zero(O.FQ_OPS if spec.name == "G1" else O.FQ2_OPS)
    ops = O.FQ_OPS if spec.name == "G1" else O.FQ2_OPS
    # lane 0: P + inf; lane 1: inf + Q; lane 2: inf + inf;
    # lane 3: P + P (double); lane 4: P + (-P) (infinity result)
    q_host[0] = zero
    p_host[1] = zero
    p_host[2] = zero
    q_host[2] = zero
    q_host[3] = p_host[3]
    q_host[4] = O.g_neg(ops, p_host[4])
    return curve.to_device(spec, p_host), curve.to_device(spec, q_host)


def _tiles(coord, struct_f):
    """(…, L, B) device tensor -> nested tile lists for the kernel body."""
    arr = jnp.asarray(coord)
    if struct_f == 0:
        return [arr[i].reshape(8, 128) for i in range(NLIMBS)]
    return [
        [arr[j, i].reshape(8, 128) for i in range(NLIMBS)] for j in range(2)
    ]


def _untile(pt, struct_f):
    if struct_f == 0:
        return jnp.stack([t.reshape(B) for t in pt])
    return jnp.stack(
        [jnp.stack([t.reshape(B) for t in comp]) for comp in pt]
    )


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_body_point_add_and_double(name, monkeypatch):
    monkeypatch.setenv("BN_TPU_CURVE_KERNELS", "0")  # reference path = jnp
    spec = curve.g1_spec() if name == "G1" else curve.g2_spec()
    f = 0 if name == "G1" else 1
    p, q = _mk_points(spec)

    F = cp._FqK(Q_CONST, INV_CONST) if f == 0 else cp._Fq2K(Q_CONST, INV_CONST)
    pt = [_tiles(c, f) for c in p]
    qt = [_tiles(c, f) for c in q]

    got_add = cp._point_add(F, pt, qt)
    want_add = curve.add(spec, p, q)
    for g, w in zip(got_add, want_add):
        np.testing.assert_array_equal(np.asarray(_untile(g, f)), np.asarray(w))

    got_dbl = cp._point_double(F, *pt)
    want_dbl = curve.double(spec, p)
    for g, w in zip(got_dbl, want_dbl):
        np.testing.assert_array_equal(np.asarray(_untile(g, f)), np.asarray(w))


# The pallas-interpret compile of the fused curve kernels is body-size-bound,
# not batch-bound: even the smaller DOUBLE kernel at a single-block batch
# exceeded 15 min on XLA:CPU, so no reduced-batch variant fits the default
# run.  The body tests above cover formulas and masks bit-exactly, the
# pack/grid plumbing is shared with tower_pallas (interpret-covered there by
# default), and Mosaic codegen is gated on hardware by bench.py / tpu_verify.py.
@pytest.mark.slow
@pytest.mark.parametrize("name", ["G1", "G2"])
def test_wrapper_matches_jnp_path(name, monkeypatch):
    """Public wrappers through the interpret-mode pallas_call plumbing."""
    from bn_tpu.ops import backend

    spec = curve.g1_spec() if name == "G1" else curve.g2_spec()
    p, q = _mk_points(spec)
    want_add = curve.add(spec, p, q)  # jnp path (BN_TPU_BACKEND=jnp in conftest)
    want_dbl = curve.double(spec, p)

    monkeypatch.setattr(backend, "_BACKEND", "pallas-interpret")
    got_add = cp.point_add(spec.name, p, q, fp.FQ.m_limbs, fp.FQ.inv)
    got_dbl = cp.point_double(spec.name, p, fp.FQ.m_limbs, fp.FQ.inv)
    monkeypatch.setattr(backend, "_BACKEND", "jnp")
    for g, w in zip(got_add, want_add):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for g, w in zip(got_dbl, want_dbl):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
