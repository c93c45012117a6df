"""An example generator of a traffic mix, in the form cardbench/traffic/<mix>.py
takes: every lane's G1 point is one fixed point h G1 (one message's hash),
the G2 points run in inputs.py's progression (public keys), as a check of
many signatures of one message pairs them.  The tests load it as the
generator of a mix of their own, in a copy of the tree.

The exponent h m_i is linear in i, so every second difference is 0."""

from __future__ import annotations

import dataclasses
import random

from cardbench import inputs
from cardbench.reference import field as rf


@dataclasses.dataclass
class FixedG1:
    n: int
    h: int
    m0: int
    d2: int

    stride = 1

    def exponent(self, i: int) -> int:
        return self.h * (self.m0 + (i + 1) * self.d2) % rf.R

    def second_difference(self, c: int = 0) -> int:
        return 0

    def exponent_sum(self) -> int:
        n = self.n
        return self.h * (n * self.m0 + self.d2 * n * (n + 1) // 2) % rf.R


def draw(seed: int, index: int, traffic: dict) -> FixedG1:
    rng = random.Random(f"cardbench.g1fixed/{seed}/{index}")
    n = traffic["pairs_per_call"]
    m0, d2 = inputs._start_and_step(rng, n)
    return FixedG1(n, rng.randrange(1, rf.R - 4), m0, d2)


def make_batch(desc: FixedG1, device):
    ref = rf.Ref()
    p = inputs.fixed_points(ref, ref.fq_ops(), rf.G1_GEN, [desc.h], desc.n, False, device)
    q = inputs._points(ref, ref.fq2_ops(), rf.G2_GEN, desc.m0, desc.d2, desc.n, True, device)
    return p, q
