"""The port's G1/G2 group law on CPU tensors against its pure-int oracle copy
(which tests/test_torch_params.py holds to the JAX package's oracle).
Tolerance: none."""

import random

import pytest
import torch

from bn_tpu_torch import curve
from bn_tpu_torch import oracle as O
from bn_tpu_torch import params as P
from bn_tpu_torch.fields import fp

CPU = "cpu"


def _setup(group):
    if group == "G1":
        return curve.g1_spec(), O.FQ_OPS, O.G1_ONE, O.g1_mul
    return curve.g2_spec(), O.FQ2_OPS, O.G2_ONE, O.g2_mul


def _affine_or_none(F, pt):
    return None if O.g_is_zero(F, pt) else O.g_to_affine(F, pt)


def _same_points(F, got, want):
    return [_affine_or_none(F, g) for g in got] == [_affine_or_none(F, w) for w in want]


@pytest.fixture(scope="module", params=["G1", "G2"])
def group(request):
    return request.param


def test_to_affine(group):
    spec, F, gen, gmul = _setup(group)
    pts = [gmul(gen, k) for k in (1, 2, 12345, P.R_SCALAR - 1)] + [O.g_zero(F)]
    # non-trivial z: double the first on the host without normalising
    pts[0] = O.g_double(F, pts[0])
    x, y = curve.to_affine(spec, curve.to_device(spec, pts, CPU))
    got = list(zip(spec.field.from_device(x), spec.field.from_device(y)))
    assert got[:-1] == [O.g_to_affine(F, pt) for pt in pts[:-1]]
    zero = 0 if group == "G1" else (0, 0)
    assert got[-1] == (zero, zero)  # infinity maps to (0, 0)


def test_add_and_double_degenerate_cases(group):
    spec, F, gen, gmul = _setup(group)
    a, b = gmul(gen, 7), gmul(gen, 11)
    inf = O.g_zero(F)
    lhs = [a, a, a, a, inf, inf, O.g_double(F, a)]
    rhs = [b, a, O.g_neg(F, a), inf, b, inf, gmul(gen, 14)]  # generic, P+P, P-P, P+0, 0+Q, 0+0, same point other z
    dl, dr = curve.to_device(spec, lhs, CPU), curve.to_device(spec, rhs, CPU)
    got = curve.from_device(spec, curve.add(spec, dl, dr))
    assert _same_points(F, got, [O.g_add(F, p, q) for p, q in zip(lhs, rhs)])
    got2 = curve.from_device(spec, curve.double(spec, dl))
    assert _same_points(F, got2, [O.g_double(F, p) for p in lhs])
    assert curve.is_zero(spec, curve.add(spec, dl, dr)).tolist() == [False, False, True, False, False, True, False]


def test_mul_by_scalars(group):
    spec, F, gen, gmul = _setup(group)
    random.seed(3)
    ks = [0, 1, 2, P.R_SCALAR - 1, random.randrange(P.R_SCALAR)]
    if group == "G2":
        ks = ks[:1] + ks[3:]  # the G2 ladder is the slow one on the CPU
    base = curve.one(spec, (len(ks),), CPU)
    got = curve.from_device(spec, curve.mul(spec, base, fp.to_device(fp.FR, ks, CPU)))
    assert _same_points(F, got, [gmul(gen, k) for k in ks])


def test_scalar_bits():
    random.seed(4)
    ks = [0, 1, P.R_SCALAR - 1, random.randrange(P.R_SCALAR)]
    bits = curve.scalar_bits(fp.to_device(fp.FR, ks, CPU))
    assert tuple(bits.shape) == (256, len(ks))
    for lane, k in enumerate(ks):
        assert [int(b) for b in bits[:, lane]] == [int(c) for c in bin(k)[2:].zfill(256)]


def test_neg_eq_from_affine_on_curve(group):
    spec, F, gen, gmul = _setup(group)
    pts = [gmul(gen, 5), O.g_double(F, gmul(gen, 9)), O.g_zero(F)]
    dp = curve.to_device(spec, pts, CPU)
    assert _same_points(F, curve.from_device(spec, curve.neg(spec, dp)), [O.g_neg(F, p) for p in pts])
    # eq across representations: 18 G via double vs via mul; unequal; infinity
    other = curve.to_device(spec, [gmul(gen, 5), gmul(gen, 18), gmul(gen, 18)], CPU)
    assert curve.eq(spec, dp, other).tolist() == [True, True, False]
    assert curve.eq(spec, dp, dp).tolist() == [True, True, True]
    aff = curve.to_affine(spec, dp)
    assert curve.on_curve_affine(spec, aff).tolist()[:2] == [True, True]
    off = (aff[0], spec.field.add(aff[1], spec.field.ones((3,), CPU)))
    assert curve.on_curve_affine(spec, off).tolist()[:2] == [False, False]
    back = curve.from_affine(spec, aff, inf_mask=curve.is_zero(spec, dp))
    assert curve.eq(spec, back, dp).tolist() == [True, True, True]


def test_zero_and_one(group):
    spec, F, gen, _ = _setup(group)
    assert curve.is_zero(spec, curve.zero(spec, (3,), CPU)).tolist() == [True] * 3
    assert _same_points(F, curve.from_device(spec, curve.one(spec, (2,), CPU)), [gen, gen])
    assert all(t.dtype == torch.int32 for t in curve.one(spec, (2,), CPU))
