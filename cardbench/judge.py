"""Whether what the timed calls returned is right: the comparison with the
plain reference that decides `correct`.

Every number compared is a count that must be 0: an exact comparison.

`gt_per_pair` (a Gt value a pair, (2, 3, 2, 16, n) limbs).  The input
generator's description of the batch (inputs.py) gives the reference's
value of lane i as E_i = g^(e_i), g = e(G1, G2), through its hooks: e_i for
the first lanes, a stride t and, for each class c < t, the second difference
S_c = e_(i+t) - 2 e_i + e_(i-t), the same for every lane i = c mod t (t = 1
and one S for inputs.py's progressions, whose e_i is quadratic in i).  A
lane counts as failed unless its twelve coefficients are canonical (limbs in
[0, 2^16), value below q) and not all zero, and
 - lanes 0 to 2t - 1 equal g^(e_i) limb for limb, and
 - lane i (t <= i <= n - t - 1) satisfies E_(i+t) E_(i-t) = E_i^2 g^(S_c),
   c = i mod t.
By induction over i that holds for every lane exactly when every lane equals
g^(e_i) limb for limb (a Gt element is never 0, so E_(i-t) is invertible).
g, its powers and the g^(S_c) come from reference/field.py in Python's
integers; the products over all lanes from reference/limbs.py in plain
PyTorch, in blocks of lanes.

`gt_product` (one Gt value, (2, 3, 2, 16, 1)).  The reference's value is
g^(sum of e_i); the product counts as failed unless it equals that limb for
limb.
"""

from __future__ import annotations

import functools

import torch

from .reference import field as rf
from .reference import limbs as rl

BLOCK = 8192  # lanes a block of the judge's products


@functools.lru_cache(maxsize=1)
def _base():
    """g = e(G1, G2) by the reference."""
    ref = rf.Ref()
    return ref, ref.pairing((rf.G1_GEN[0], rf.G1_GEN[1], 1), (rf.G2_GEN[0], rf.G2_GEN[1], rf.FQ2_ONE))


def gt_power(e: int, device) -> torch.Tensor:
    """g^e as a (2, 3, 2, 16, 1) int64 limb tensor."""
    ref, g = _base()
    return rl.fq12_from_ints(rf.fq12_ints(ref.f12_pow(g, e % rf.R)), device)


def _lane_ok(out: torch.Tensor) -> torch.Tensor:
    """Per lane: canonical and not zero."""
    flat = out.reshape(12, rl.NLIMBS, out.shape[-1])
    return rl.is_canonical(flat).all(dim=0) & (flat != 0).any(dim=1).any(dim=0)


def _equal(a, b) -> torch.Tensor:
    return (a == b).reshape(-1, a.shape[-1]).all(dim=0)


def lanes_failed(out: torch.Tensor, prog) -> int:
    """Lanes of one gt_per_pair output that fail the checks above."""
    n = out.shape[-1]
    out = out.to(torch.int64)
    ok = _lane_ok(out)
    t = prog.stride
    for i in range(min(n, 2 * t)):
        ok[i] &= bool(_equal(out[..., i : i + 1], gt_power(prog.exponent(i), out.device)).all())
    s = torch.cat([gt_power(prog.second_difference(c), out.device) for c in range(t)], dim=-1)
    for lo in range(t, n - t, BLOCK):
        hi = min(n - t, lo + BLOCK)
        cur = out[..., lo:hi]
        x = rl.fq12_mul(out[..., lo + t : hi + t], out[..., lo - t : hi - t])
        y = rl.fq12_mul(rl.fq12_mul(cur, cur), s[..., torch.arange(lo, hi, device=out.device) % t])
        ok[lo:hi] &= _equal(x, y)
    return int((~ok).sum())


def product_failed(product: torch.Tensor, prog) -> int:
    """1 unless one gt_product output equals the reference's product."""
    want = gt_power(prog.exponent_sum(), product.device)
    return 0 if bool(_equal(product.to(torch.int64), want).all()) else 1


JUDGES = {"gt_per_pair": lanes_failed, "gt_product": product_failed}
