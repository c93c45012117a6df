"""The input generator at a small size on the CPU."""

import pytest
import torch

from bn_tpu_torch import curve
from bn_tpu_torch import oracle as O
from cardbench import inputs
from cardbench.reference import field as rf


@pytest.mark.parametrize("n", [2, 5, 37])
def test_points_are_the_progressions_multiples_in_their_subgroups_distinct_and_jacobian(n):
    prog = inputs.progression(2**33 + 17, 1, n)
    p, q = inputs.make_batch(prog, "cpu")
    assert p[0].shape == (16, n) and q[0].shape == (2, 16, n) and p[0].dtype == torch.int32
    g1, g2 = curve.from_device(curve.g1_spec(), p), curve.from_device(curve.g2_spec(), q)
    for i in range(n):
        assert O.g_eq(O.FQ_OPS, g1[i], O.g1_mul(O.G1_ONE, prog.k0 + (i + 1) * prog.d1))
        assert O.g_eq(O.FQ2_OPS, g2[i], O.g2_mul(O.G2_ONE, prog.m0 + (i + 1) * prog.d2))
        assert g1[i][2] != 1 and g2[i][2] != O.FQ2_ONE
    a1 = [O.g_to_affine(O.FQ_OPS, x) for x in g1]
    a2 = [O.g_to_affine(O.FQ2_OPS, x) for x in g2]
    assert all(O.g1_on_curve(a) for a in a1) and all(O.g2_on_curve(a) for a in a2)
    assert O.g2_in_subgroup(a2[0]) and O.g2_in_subgroup(a2[-1])
    assert len(set(a1)) == n and len(set(a2)) == n


def test_the_seed_decides_the_batch():
    a, b = inputs.progression(2**31 + 5, 0, 64), inputs.progression(2**31 + 5, 0, 64)
    assert a == b and inputs.progression(2**31 + 6, 0, 64) != a and inputs.progression(2**31 + 5, 1, 64) != a


def test_exponents_sum_and_second_difference():
    prog = inputs.progression(12345678901, 0, 9)
    e = [prog.exponent(i) for i in range(9)]
    assert sum(e) % rf.R == prog.exponent_sum()
    assert all((e[i + 1] - 2 * e[i] + e[i - 1]) % rf.R == prog.second_difference() for i in range(1, 8))


@pytest.mark.parametrize("n", [2, 3, 10, 65536, 262144, 1000003])
def test_split_covers_the_batch(n):
    lo, hi = inputs.split(n)
    assert lo * hi >= n and (hi - 1) * lo < n
