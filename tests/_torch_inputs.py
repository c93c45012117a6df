"""Seeded numpy inputs shared by the tests of the PyTorch port."""

import numpy as np
import torch

from bn_tpu_torch import ate
from bn_tpu_torch import oracle as TO
from bn_tpu_torch import params as TP
from bn_tpu_torch.fields import tower as ttower
from bn_tpu_torch.ops import mont_cuda as mc
from bn_tpu_torch.ops import tower_cuda as tc

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


# mod_signed_sum's cases: the levels the main path runs, at B = 6 and lead 3,
# base-field levels and Fq2 levels with xi terms
SUM_B, SUM_LEAD = 6, 3


def sum_values(seed, shape, modulus):
    """(*shape[:-1], 16, SUM_B) int32 limbs: seeded values below m, the last
    three lanes of every row 0, 1, m - 1 in an order the seed rotates."""
    rng = np.random.default_rng(seed)
    rows = int(np.prod(shape[:-1], dtype=np.int64))
    edges = [0, 1, modulus - 1]
    vals = []
    for r in range(rows):
        row = [int.from_bytes(rng.bytes(40), "big") % modulus for _ in range(SUM_B - 3)]
        vals += row + [edges[(j + r + seed) % 3] for j in range(3)]
    limbs = TP.ints_to_limbs(vals).reshape(16, rows, SUM_B)
    return torch.from_numpy(np.moveaxis(limbs, 0, 1).reshape(tuple(shape[:-1]) + (16, SUM_B)).astype(np.int32))


def _poisoned(shape):
    """A destination filled with a pattern that is no field element."""
    return torch.full(shape, -1, dtype=torch.int32)


def _packed_results(lead):
    """A poisoned packed Fq6 (*lead, 3, 2, 16, SUM_B) and its three Fq2
    coefficients as the outputs of a level: (out argument, outputs read)."""
    packed = _poisoned(tuple(lead) + (3, 2, 16, SUM_B))
    return packed.movedim(-4, 0), list(packed.movedim(-4, 0))


def signed_sum_case(name, modulus):
    """(terms, sources, out argument or None, the outputs as read back or None:
    the result then, the Fq2 form or not) of case `name` of SIGNED_SUM_CASES."""
    XI = mc.XI
    if name == "negation":
        (x,) = [sum_values(1, (SUM_LEAD, 2, SUM_B), modulus)]
        return (((0, -1),),), [x], None, None, False
    if name == "difference":
        x, y = (sum_values(s, (SUM_LEAD, 2, SUM_B), modulus) for s in (2, 3))
        return (((0, 1), (1, -1)),), [x, y], None, None, False
    if name == "repeated-source":
        x, y = (sum_values(s, (SUM_LEAD, SUM_B), modulus) for s in (4, 5))
        terms = (((0, 1), (0, 1), (0, -1), (1, 1)), ((0, -1), (0, -1)), ((1, -1), (0, 1), (1, -1), (1, 1)), ((1, 1),))
        return terms, [x, y], None, None, False
    if name in ("conj-fq2-axis", "conj-fq12-halves"):
        a = sum_values(6, (SUM_LEAD, 2, 3, 2, SUM_B), modulus)
        axis = -3 if name == "conj-fq2-axis" else -5
        out = _poisoned(a.shape)
        return ttower.CONJ, [a.select(axis, 0), a.select(axis, 1)], out.movedim(axis, 0), list(out.movedim(axis, 0)), False
    if name in ("fq6_mul-operands", "fq6_mul-operands-broadcast"):
        a = sum_values(7, (SUM_LEAD, 3, 2, SUM_B), modulus)
        b = sum_values(8, ((1 if name.endswith("broadcast") else SUM_LEAD), 3, 2, SUM_B), modulus)
        srcs = [a[..., i, :, :, :] for i in range(3)] + [b[..., i, :, :, :] for i in range(3)]
        return tc.FQ6_MUL_OPERANDS, srcs, None, None, False
    # fq6_mul's results from its six products (its differences and its xi
    # products in one Fq2 level): at lead 1, as tower.fq6_mul has it; at lead
    # 2, as fq12_inv has it; and with half the products broadcast along the 2.
    # The lead-1 case keeps its id from the level of differences that
    # FQ6_MUL_RESULTS replaced, so the test ids stay stable
    if name == "fq6_mul-differences":
        out, read = _packed_results((SUM_LEAD,))
        return tc.FQ6_MUL_RESULTS, list(sum_values(9, (6, SUM_LEAD, 2, SUM_B), modulus)), out, read, True
    if name == "fq6_mul-results":
        out, read = _packed_results((2, SUM_LEAD))
        return tc.FQ6_MUL_RESULTS, list(sum_values(10, (6, 2, SUM_LEAD, 2, SUM_B), modulus)), out, read, True
    if name == "fq6_mul-results-broadcast":
        out, read = _packed_results((2, SUM_LEAD))
        srcs = list(sum_values(18, (3, 2, SUM_LEAD, 2, SUM_B), modulus)) + list(sum_values(19, (3, 1, SUM_LEAD, 2, SUM_B), modulus))
        return tc.FQ6_MUL_RESULTS, srcs, out, read, True
    if name == "fq6_inv-operands":
        a = sum_values(11, (SUM_LEAD, 3, 2, SUM_B), modulus)
        return ttower.FQ6_INV_OPERANDS, [a[..., i, :, :, :] for i in range(3)], None, None, True
    if name == "fq6_inv-norm-factors":
        return ttower.FQ6_INV_NORM_FACTORS, list(sum_values(13, (6, SUM_LEAD, 2, SUM_B), modulus)), None, None, True
    if name == "fq6_inv-norm":
        return ttower.FQ6_INV_NORM, list(sum_values(20, (3, SUM_LEAD, 2, SUM_B), modulus)), None, None, True
    if name == "fq12_inv-nonresidue":
        p = sum_values(14, (2, SUM_LEAD, 3, 2, SUM_B), modulus)
        out, read = _packed_results((SUM_LEAD,))
        return ttower.FQ6_SUB_NONRESIDUE, [p[k, ..., i, :, :, :] for k in range(2) for i in range(3)], out, read, True
    if name in ("mul_by_q-conj", "mul_by_q-conj-negated"):
        x, y = (sum_values(s, (SUM_LEAD, 2, SUM_B), modulus) for s in (16, 17))
        conj = _poisoned((2, SUM_LEAD, 2, 16, SUM_B))
        outs = [conj[k][..., c, :, :] for k in range(2) for c in range(2)]
        terms = ate.CONJ_X_NEG_Y if name.endswith("negated") else ate.CONJ_XY
        return terms, [x[..., 0, :, :], x[..., 1, :, :], y[..., 0, :, :], y[..., 1, :, :]], outs, outs, False
    if name == "xi-repeated-source":  # negated xi terms, first and later, and a source read as itself and times xi
        x, y = (sum_values(s, (SUM_LEAD, 2, SUM_B), modulus) for s in (21, 22))
        terms = (((0, -1, XI),), ((0, 1, XI), (0, -1), (1, 1, XI), (0, 1, XI)), ((1, -1), (1, -1, XI)), ((0, 1),))
        return terms, [x, y], None, None, True
    raise KeyError(name)


SIGNED_SUM_CASES = ["negation", "difference", "repeated-source", "conj-fq2-axis", "conj-fq12-halves", "fq6_mul-operands",
                    "fq6_mul-operands-broadcast", "fq6_mul-differences", "fq6_mul-results", "fq6_mul-results-broadcast",
                    "fq6_inv-operands", "fq6_inv-norm-factors", "fq6_inv-norm", "fq12_inv-nonresidue", "mul_by_q-conj",
                    "mul_by_q-conj-negated", "xi-repeated-source"]
