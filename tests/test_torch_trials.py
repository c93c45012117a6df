"""tools/torch_trials.py on the CPU, at N = 8.

Every field trial (Fr, Fq, Fq2, Fq6, Fq12) passes on CPU tensors, where each
wrapper runs its kernel's plain version.  The group addition and doubling
trials pass with the oracle's scalar products in place of the tool's
`times` (the random points, and doubling's 2 r1 times 2^-1): a ladder costs
4.6 s (G1) or 8.6 s (G2) on the CPU, so the trials made of ladders
(Diffie-Hellman, the do / undo walk, the oracle points) run on the card only
(chip_smoke.py `trials`).  A field whose product is wrong on one lane fails on that lane.  The
tool's draws are those of tests/test_field_trials.py: the same values.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from bn_tpu_torch import curve
from bn_tpu_torch import oracle as O

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import torch_trials as TT  # noqa: E402

N = 8


@pytest.mark.parametrize("field", list(TT.FIELDS))
def test_field_trials_pass(field):
    F = TT.FIELDS[field]
    for trial in TT.FIELD_TRIALS + TT.FIELD_ONLY.get(field, ()):
        res = trial(F, "cpu", N)
        assert res.name == f"{field}.{trial.__name__}" and res.failed == [], res


def _oracle_times(G, p, k, device):
    return curve.to_device(G.spec, [O.g_mul(G.ops, pt, x) for pt, x in zip(curve.from_device(G.spec, p), k)], device)


@pytest.mark.parametrize("group", list(TT.GROUPS))
def test_group_addition_and_doubling_pass(group, monkeypatch):
    monkeypatch.setattr(TT, "times", _oracle_times)
    G = TT.GROUPS[group]
    for trial in (TT.addition, TT.doubling):
        res = trial(G, "cpu", N)
        assert (res.lanes, res.failed) == (N, []), res


class _WrongOnLane5(TT.BaseField):
    def mul(self, a, b):
        c = super().mul(a, b).clone()
        c[..., 0, 5] ^= 1
        return c


def test_a_wrong_lane_fails():
    F = _WrongOnLane5("fq", TT.FIELDS["fq"].spec)
    assert TT.associativity(F, "cpu", N).failed == [5]


def test_draws_are_the_field_trials_values():
    """The tool's Fq2 draw of seed 103245 is tests/test_field_trials.py's."""
    from bn_tpu.fields import fp as jfp
    F = TT.FIELDS["fq2"]
    rng = np.random.default_rng(103245)
    got = F.random(rng, N, "cpu").numpy()
    rng = np.random.default_rng(103245)
    coeffs = [[int.from_bytes(rng.bytes(40), "big") % F.modulus for _ in range(N)] for _ in range(2)]
    want = np.stack([np.asarray(jfp.to_device(jfp.FQ, v)) for v in coeffs])
    assert np.array_equal(got.astype(np.uint32), want)
