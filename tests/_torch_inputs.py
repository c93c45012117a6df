"""Seeded numpy inputs shared by the tests of the PyTorch port."""

import numpy as np

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
