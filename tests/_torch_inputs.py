"""Seeded numpy inputs shared by the tests of the PyTorch port."""

import numpy as np

from bn_tpu_torch import oracle as TO
from bn_tpu_torch import params as TP

def SPECIALS_FOR(m):
    return [0, 1, m - 1, TP.R_MONT % m]


def rand_field(seed: int, shape, modulus: int = TP.Q, specials: bool = True) -> np.ndarray:
    """A uint32 limb array (*shape[:-1], 16, shape[-1]) of values in [0, m):
    the first lanes of the flat batch hold 0, 1, m-1 and the Montgomery one
    (as far as they fit), the rest is uniform from numpy's seeded generator."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(40), "big") % modulus for _ in range(n)]
    if specials:
        for i, v in enumerate(SPECIALS_FOR(modulus)[:n]):
            vals[i] = v
    limbs = TP.ints_to_limbs(vals)  # (16, n)
    lead, b = tuple(shape[:-1]), shape[-1]
    return np.ascontiguousarray(np.moveaxis(limbs.reshape((16,) + lead + (b,)), 0, -2))


def _coord_array(group, values, shape):
    """Canonical coordinate values (ints for G1, (c0, c1) for G2), one per
    element of the flat batch -> Montgomery limbs (*lead, [2,] 16, B)."""
    def fq(vals):
        limbs = TP.ints_to_limbs([TP.to_mont(v, TP.Q) for v in vals])
        return np.moveaxis(limbs.reshape((16,) + tuple(shape)), 0, -2)

    if group == "G1":
        return np.ascontiguousarray(fq(values))
    return np.ascontiguousarray(np.stack([fq([v[0] for v in values]), fq([v[1] for v in values])], axis=-3))


def curve_points(group: str, seed: int, shape):
    """Two batches (p, q) of Jacobian points of G1 or G2 as coordinate arrays
    (x, y, z), each (*shape[:-1], [2,] 16, shape[-1]) uint32: multiples of the
    generator with seeded scalars and z != 1 on half of them.  At both ends of
    the flat batch lie the six degenerate pairs of the group law: P + inf,
    inf + Q, inf + inf, P + P, P + (-P), and the same point under two z."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    assert n >= 12
    if group == "G1":
        F, gen, gmul = TO.FQ_OPS, TO.G1_ONE, TO.g1_mul
    else:
        F, gen, gmul = TO.FQ2_OPS, TO.G2_ONE, TO.g2_mul

    def rand_point():
        pt = gmul(gen, int(rng.integers(2, 1 << 62)))
        return TO.g_double(F, pt) if rng.integers(2) else pt  # a doubling leaves z != 1

    ps = [rand_point() for _ in range(n)]
    qs = [rand_point() for _ in range(n)]
    inf = TO.g_zero(F)
    for base in (0, n - 6):
        qs[base] = inf
        ps[base + 1] = inf
        ps[base + 2] = qs[base + 2] = inf
        qs[base + 3] = ps[base + 3]
        qs[base + 4] = TO.g_neg(F, ps[base + 4])
        ps[base + 5] = gmul(gen, 14)
        qs[base + 5] = TO.g_double(F, gmul(gen, 7))
    return tuple(
        tuple(_coord_array(group, [pt[k] for pt in pts], shape) for k in range(3)) for pts in (ps, qs)
    )
