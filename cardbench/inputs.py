"""The default input generator: batches of (G1, G2) pairs from the seed.

A traffic mix without a generator of its own (cardbench/traffic/<mix>.py)
is made here.  A generator is a module with two functions:
 - draw(seed, index, traffic): the description of input batch `index` of a
   run seeded with `seed`, for the mix whose parameters are `traffic`; it
   carries what the judge (judge.py) needs, as Progression below does:
   `n`, `stride`, `exponent(i)`, `second_difference(c)`, `exponent_sum()`;
 - make_batch(description, device): the batch itself.

Within a batch the scalars run in arithmetic progressions,

    P_i = (k0 + (i + 1) d1) G1,   Q_i = (m0 + (i + 1) d2) G2,   i < n,

so every point lies in its subgroup, no two points of a batch are equal, and
e(P_i, Q_i) = e(G1, G2)^(k_i m_i) is known to the judge from four numbers.
Scalar multiplications in Python's integers cost milliseconds a G2 point, so
only two short tables are made on the host, T_lo[j] = (j + 1) D and
T_hi[k] = A + k n_lo D (A = k0 G, D = d G, n_lo n_hi >= n), and the card adds
them in one batched Jacobian addition, P_(k n_lo + j) = T_hi[k] + T_lo[j], in
plain PyTorch (reference/limbs.py).  The sums come out in Jacobian form with
z != 1, as the package's callers hand them over.

A mix that sets `g2_fixed_points` (k >= 1) keeps the G1 progression but
gives every lane one of k fixed G2 points, lane i the point keys[i mod k] G2
(keys[0] = 1, the generator; the others drawn from the seed), as BLS checks
on BN254 pair many messages with a few public keys (FixedG2).  Each fixed
point is made as the Jacobian sum (s + 2) G2 + (-2) G2, so z != 1 there too.
"""

from __future__ import annotations

import dataclasses
import math
import random

import torch

from .reference import field as rf
from .reference import limbs as rl


@dataclasses.dataclass
class Progression:
    """The scalars of one batch: k_i = k0 + (i + 1) d1 for G1, m_i = m0 +
    (i + 1) d2 for G2, i < n (all mod r)."""

    n: int
    k0: int
    d1: int
    m0: int
    d2: int

    stride = 1  # lane i is judged against lanes i - stride and i + stride

    def exponent(self, i: int) -> int:
        """k_i m_i mod r: e(P_i, Q_i) = e(G1, G2)^exponent(i)."""
        return (self.k0 + (i + 1) * self.d1) * (self.m0 + (i + 1) * self.d2) % rf.R

    def second_difference(self, c: int = 0) -> int:
        """exponent(i + stride) - 2 exponent(i) + exponent(i - stride) for
        the lanes i = c mod stride: here the same for every i."""
        return 2 * self.d1 * self.d2 % rf.R

    def exponent_sum(self) -> int:
        """The sum of exponent(i) over the batch: the product of its pairings
        is e(G1, G2) to this power."""
        n = self.n
        s1, s2 = n * (n + 1) // 2, n * (n + 1) * (2 * n + 1) // 6
        return (n * self.k0 * self.m0 + (self.k0 * self.d2 + self.m0 * self.d1) * s1 + self.d1 * self.d2 * s2) % rf.R


@dataclasses.dataclass
class FixedG2:
    """The scalars of one batch of a mix with fixed G2 points: k_i = k0 +
    (i + 1) d1 for G1, keys[i mod len(keys)] for G2.  Within the lanes of one
    key the exponent is linear in i, so with the stride len(keys) every
    second difference is 0."""

    n: int
    k0: int
    d1: int
    keys: tuple

    @property
    def stride(self) -> int:
        return len(self.keys)

    def exponent(self, i: int) -> int:
        return (self.k0 + (i + 1) * self.d1) * self.keys[i % self.stride] % rf.R

    def second_difference(self, c: int = 0) -> int:
        return 0

    def exponent_sum(self) -> int:
        """Over the lanes of each key, the sum of an arithmetic progression."""
        total, t = 0, self.stride
        for c, key in enumerate(self.keys):
            m = len(range(c, self.n, t))  # lanes c, c + t, ...: k = k0 + (c + 1) d1 + j t d1, j < m
            total += key * (m * (self.k0 + (c + 1) * self.d1) + t * self.d1 * m * (m - 1) // 2)
        return total % rf.R


def split(n: int) -> tuple:
    """(n_lo, n_hi) with n_lo n_hi >= n, both near sqrt(n)."""
    n_lo = max(2, math.isqrt(n - 1) + 1)
    return n_lo, max(1, -(-n // n_lo))


def _start_and_step(rng: random.Random, n: int) -> tuple:
    """(start, step) with no degenerate addition in the tables or the sums:
    start / step mod r lies outside [-n - 1, n_lo + 1]."""
    n_lo, _ = split(n)
    while True:
        start, step = rng.randrange(1, rf.R), rng.randrange(1, rf.R)
        t = start * pow(step, -1, rf.R) % rf.R
        if n_lo + 2 <= t <= rf.R - n - 2:
            return start, step


def draw(seed: int, index: int, traffic: dict):
    """The description of batch `index` of a run seeded with `seed`."""
    n, fixed = traffic["pairs_per_call"], traffic.get("g2_fixed_points")
    if not fixed:
        return progression(seed, index, n)
    rng = random.Random(f"cardbench/g2fixed/{seed}/{index}")
    k0, d1 = _start_and_step(rng, n)
    return FixedG2(n, k0, d1, (1,) + tuple(rng.randrange(2, rf.R - 4) for _ in range(fixed - 1)))


def progression(seed: int, index: int, n: int) -> Progression:
    """The progression of batch `index` of a run seeded with `seed`, n pairs."""
    rng = random.Random(f"cardbench/{seed}/{index}")
    k0, d1 = _start_and_step(rng, n)
    m0, d2 = _start_and_step(rng, n)
    return Progression(n, k0, d1, m0, d2)


def _tables(ref, ops, gen, start: int, step: int, n: int):
    """Affine T_hi and T_lo (lists of (x, y)) over one field."""
    n_lo, n_hi = split(n)
    one = ops[3]
    base = (gen[0], gen[1], one)
    a, d = ref.g_mul(ops, base, start), ref.g_mul(ops, base, step)
    e = ref.g_mul(ops, d, n_lo)
    lo = [d, ref.g_double(ops, d)]
    while len(lo) < n_lo:
        lo.append(ref.g_add(ops, lo[-1], d))
    hi = [a]
    while len(hi) < n_hi:
        hi.append(ref.g_add(ops, hi[-1], e))
    return _affine(ref, hi), _affine(ref, lo[:n_lo])


def _affine(ref, points):
    if isinstance(points[0][2], tuple):
        return [ref.g2_to_affine(p) for p in points]
    return [ref.g1_to_affine(p) for p in points]


def _to_card(coords, fq2: bool, device):
    """Affine coordinates (ints or Fq2 pairs) -> (x, y) int64 limb tensors,
    (16, m) or (2, 16, m)."""
    out = []
    for c in range(2):
        vals = [p[c] for p in coords]
        if fq2:
            t = torch.stack([torch.from_numpy(rl.ints_to_limbs([v[k] for v in vals])) for k in range(2)])
        else:
            t = torch.from_numpy(rl.ints_to_limbs(vals))
        out.append(t.to(device))
    return out


def _points(ref, ops, gen, start, step, n, fq2: bool, device):
    n_lo, n_hi = split(n)
    hi, lo = _tables(ref, ops, gen, start, step, n)
    hx, hy = (t.repeat_interleave(n_lo, dim=-1)[..., :n] for t in _to_card(hi, fq2, device))
    lx, ly = (t.repeat((1,) * (t.dim() - 1) + (n_hi,))[..., :n] for t in _to_card(lo, fq2, device))
    one = rl.const(1, device)
    if fq2:
        one = torch.stack([one, torch.zeros_like(one)])
    mul = rl.fq2_mul if fq2 else rl.mont_mul
    x, y, z = rl.jacobian_add(mul, (hx, hy, one), (lx, ly, one))
    return tuple(c.to(torch.int32).contiguous() for c in (x, y, z))


def fixed_points(ref, ops, gen, scalars, n, fq2: bool, device):
    """Lane i: scalars[i mod len(scalars)] G as the Jacobian sum (s + 2) G +
    (-2) G (z != 1); no scalar may be 0 or -4 mod r."""
    base = (gen[0], gen[1], ops[3])
    left = _affine(ref, [ref.g_mul(ops, base, s + 2) for s in scalars])
    right = _affine(ref, [ref.g_mul(ops, base, rf.R - 2)]) * len(scalars)
    (lx, ly), (rx, ry) = _to_card(left, fq2, device), _to_card(right, fq2, device)
    one = rl.const(1, device)
    if fq2:
        one = torch.stack([one, torch.zeros_like(one)])
    points = rl.jacobian_add(rl.fq2_mul if fq2 else rl.mont_mul, (lx, ly, one), (rx, ry, one))
    lane = torch.arange(n, device=device) % len(scalars)
    return tuple(c[..., lane].to(torch.int32).contiguous() for c in points)


def make_batch(prog, device):
    """((x, y, z) of G1, (x, y, z) of G2): int32 limb tensors on `device`,
    (16, n) and (2, 16, n)."""
    ref = rf.Ref()
    p = _points(ref, ref.fq_ops(), rf.G1_GEN, prog.k0, prog.d1, prog.n, False, device)
    if isinstance(prog, FixedG2):
        q = fixed_points(ref, ref.fq2_ops(), rf.G2_GEN, prog.keys, prog.n, True, device)
    else:
        q = _points(ref, ref.fq2_ops(), rf.G2_GEN, prog.m0, prog.d2, prog.n, True, device)
    return p, q
