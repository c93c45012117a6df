"""bn_tpu_torch.parallel.dist on the CPU.

The fold functions against the JAX package's (bn_tpu.parallel.dist) and the
oracle; then four gloo ranks in one torch.multiprocessing spawn, one CPU
thread each, rendezvous through a file: the sharded pairing lane by lane, the
sharded Gt product on every rank, and the sharded MSM on the inputs of
tests/test_dist.py (seed 90, n = 21 over 4 ranks: shards of 5, 5, 5 and 6),
which must have the Jacobian limbs of the JAX package's sharded_msm on a
4-device mesh; and __graft_entry_torch__.dryrun_multichip(4) in the ranks'
group, whose product of the 8 pairings of __graft_entry__.py's dry run must
be the oracle's on every rank.  The ranks run tests/_torch_dist_worker.py, which imports no
JAX; the JAX side runs here, at the shapes tests/test_dist.py compiles, while
the ranks work.  Tolerance: none.
"""

import random

import jax
import numpy as np
import torch
import torch.multiprocessing as mp

from bn_tpu.fields import tower as jtower
from bn_tpu.parallel import dist as jdist
from bn_tpu_torch import ate, convert, curve, msm
from bn_tpu_torch import oracle as O
from bn_tpu_torch import params as P
from bn_tpu_torch.fields import tower as T
from bn_tpu_torch.parallel import dist

import _torch_dist_worker
from test_oracle import S1, S2

CPU = "cpu"


def _random_fq12(n):
    return [
        tuple(tuple((random.randrange(P.Q), random.randrange(P.Q)) for _ in range(3)) for _ in range(2))
        for _ in range(n)
    ]


def test_fq12_fold_product_equals_jax_on_an_odd_batch():
    """tests/test_dist.py's inputs (seed 89, batch 5): padded to 8 with Gt
    one; at width 1024 one row and a fold by 4, 2, 1, at width 2 four rows."""
    random.seed(89)
    vals = _random_fq12(5)
    want = np.asarray(jax.jit(jdist.fq12_fold_product)(jtower.fq12_to_device(vals)))
    a = T.fq12_to_device(vals, CPU)
    expect = O.FQ12_ONE
    for v in vals:
        expect = O.fq12_mul(expect, v)
    for width in (1024, 2):
        got = dist.fq12_fold_product(a, width)
        assert tuple(got.shape) == (2, 3, 2, 16, 1)
        assert np.array_equal(convert.to_numpy(got), want)
        assert T.fq12_from_device(got)[0] == expect


def test_point_fold_sum_on_odd_batches():
    """G1 and G2 points (multiples of the generator, one of them infinity)
    summed at widths 1024 and 2 equal the oracle's sum."""
    random.seed(91)
    for spec, F, gen, gmul, n in ((curve.g1_spec(), O.FQ_OPS, O.G1_ONE, O.g1_mul, 5),
                                  (curve.g2_spec(), O.FQ2_OPS, O.G2_ONE, O.g2_mul, 3)):
        pts = [gmul(gen, random.randrange(1, P.R_SCALAR)) for _ in range(n - 1)] + [O.g_zero(F)]
        expect = O.g_zero(F)
        for pt in pts:
            expect = O.g_add(F, expect, pt)
        for width in (1024, 2):
            got = dist.point_fold_sum(spec, curve.to_device(spec, pts, CPU), width)
            assert got[0].shape[-1] == 1
            assert O.g_eq(F, curve.from_device(spec, got)[0], expect)


def _four_pairs():
    """tests/test_torch_pairing.py's four pairs: the golden-vector pair, a
    random pair, and the two pairs with an infinite point."""
    g1, g2 = O.g1_mul(O.G1_ONE, S1), O.g2_mul(O.G2_ONE, S2)
    random.seed(77)
    p2 = O.g1_mul(O.G1_ONE, random.randrange(P.R_SCALAR))
    q2 = O.g2_mul(O.G2_ONE, random.randrange(P.R_SCALAR))
    return [g1, p2, O.g_zero(O.FQ_OPS), g1], [g2, q2, q2, O.g_zero(O.FQ2_OPS)]


def _msm_case():
    """tests/test_dist.py's sharded MSM inputs."""
    random.seed(90)
    n = 21
    points = [O.g1_mul(O.G1_ONE, random.randrange(1, P.R_SCALAR)) for _ in range(n)]
    scalars = [random.randrange(P.R_SCALAR) for _ in range(n)]
    return points, scalars, 5


def test_four_gloo_ranks(tmp_path):
    """One spawn of four ranks; the checks of all three sharded functions
    share it, because the ranks' pairings are the cost."""
    ps, qs = _four_pairs()
    points, scalars, c = _msm_case()
    ctx = mp.spawn(_torch_dist_worker.run, nprocs=4, join=False,
                   args=(4, str(tmp_path / "rendezvous"), str(tmp_path), (ps, qs), (points, scalars, c)))
    try:  # meanwhile, here: the single-process pairing, the oracle, the JAX package's sharded MSM
        single = ate.pairing_batch(curve.to_device(curve.g1_spec(), ps, CPU), curve.to_device(curve.g2_spec(), qs, CPU))
        want = [O.pairing(p, q) for p, q in zip(ps, qs)]
        jax_msm = tuple(np.asarray(t) for t in jdist.sharded_msm(jdist.make_mesh(4), points, scalars, c=c))
    finally:
        while not ctx.join():
            pass
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(4)]
    assert not any(bool(r["jax_loaded"]) for r in ranks)

    # sharded_pairing: rank r holds lane r
    assert T.fq12_from_device(np.concatenate([r["lanes"] for r in ranks], axis=-1)) == want
    assert np.array_equal(np.concatenate([r["lanes"] for r in ranks], axis=-1), single.numpy())

    # sharded_pairing_product: the whole product on every rank
    product = O.FQ12_ONE
    for w in want:
        product = O.fq12_mul(product, w)
    for r in ranks:
        assert r["product"].shape == (2, 3, 2, 16, 1) and T.fq12_from_device(r["product"])[0] == product

    # dryrun_multichip(4): the product of its 8 pairings on every rank
    dry = O.FQ12_ONE
    for k in range(1, 9):
        dry = O.fq12_mul(dry, O.pairing(O.g1_mul(O.G1_ONE, 10 + k), O.g2_mul(O.G2_ONE, 20 + k)))
    for r in ranks:
        assert r["dryrun"].shape == (2, 3, 2, 16, 1) and T.fq12_from_device(r["dryrun"])[0] == dry

    # sharded_msm: the oracle's sum, and the JAX package's Jacobian limbs, on every rank
    expect = msm.msm_oracle(points, scalars)
    for r in ranks:
        got = tuple(r[k] for k in ("msm_x", "msm_y", "msm_z"))
        assert O.g_eq(O.FQ_OPS, curve.from_device(curve.g1_spec(), tuple(torch.from_numpy(t) for t in got))[0], expect)
        for g, j in zip(got, jax_msm):
            assert np.array_equal(g.astype(np.uint32), j)
