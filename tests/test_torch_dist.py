"""bn_tpu_torch.parallel.dist on the CPU.

The fold functions against the JAX package's (bn_tpu.parallel.dist) and the
oracle; then four gloo ranks in one torch.multiprocessing spawn, one CPU
thread each, rendezvous through a file: the sharded pairing lane by lane, the
sharded Gt product on every rank, the sharded MSM on the inputs of
tests/test_dist.py (seed 90, n = 21 over 4 ranks: shards of 5, 5, 5 and 6)
against the oracle, and __graft_entry_torch__.dryrun_multichip(4) in the
ranks' group, whose product of the 8 pairings of __graft_entry__.py's dry run
must be the oracle's on every rank.  A second spawn of four ranks runs that
sharded MSM alone, whose Jacobian limbs must be those of the JAX package's
sharded_msm on a 4-device mesh: that compile is the cost of the second
test, the ranks' pairings that of the first.  The ranks
run tests/_torch_dist_worker.py, which imports no JAX; the JAX side runs
here, at the shapes tests/test_dist.py compiles, while the ranks work.
Tolerance: none.  The spawned ranks are joined against a deadline inside the
per-test limit: past it they are terminated, and the test fails with their
exit codes.
"""

import random
import time

import jax
import numpy as np
import pytest
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
from conftest import GRACE, LIMIT
from test_oracle import S1, S2

CPU = "cpu"
# seconds from the spawn to the ranks' deadline, inside the test's limit
RANKS_DEADLINE = LIMIT - GRACE


def join_by(ctx, deadline):
    """Join the processes of a torch.multiprocessing context by the time
    time.monotonic() reaches `deadline`; past it terminate every live one,
    join them, and fail with their exit codes.  A process that raised is
    reported by ctx.join as always."""
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
            pytest.fail(f"spawned processes ran past their deadline; exit codes {[p.exitcode for p in ctx.processes]}")


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


def _spawn_ranks(tmp_path, pairs, msm_case):
    """Four gloo ranks of _torch_dist_worker.run, not joined, and their
    deadline."""
    deadline = time.monotonic() + RANKS_DEADLINE
    ctx = mp.spawn(_torch_dist_worker.run, nprocs=4, join=False,
                   args=(4, str(tmp_path / "rendezvous"), str(tmp_path), pairs, msm_case))
    return ctx, deadline


def _rank_outputs(tmp_path):
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(4)]
    assert not any(bool(r["jax_loaded"]) for r in ranks)
    return ranks


def _rank_msm(rank):
    return tuple(rank[k] for k in ("msm_x", "msm_y", "msm_z"))


def test_four_gloo_ranks(tmp_path):
    """One spawn of four ranks; the checks of all three sharded functions
    against the oracle share it, because the ranks' pairings are the cost."""
    ps, qs = _four_pairs()
    points, scalars, c = _msm_case()
    ctx, deadline = _spawn_ranks(tmp_path, (ps, qs), (points, scalars, c))
    try:  # meanwhile, here: the single-process pairing and the oracle
        single = ate.pairing_batch(curve.to_device(curve.g1_spec(), ps, CPU), curve.to_device(curve.g2_spec(), qs, CPU))
        want = [O.pairing(p, q) for p, q in zip(ps, qs)]
    finally:
        join_by(ctx, deadline)
    ranks = _rank_outputs(tmp_path)

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

    # sharded_msm: the oracle's sum on every rank
    expect = msm.msm_oracle(points, scalars)
    for r in ranks:
        assert O.g_eq(O.FQ_OPS, curve.from_device(curve.g1_spec(), tuple(torch.from_numpy(t) for t in _rank_msm(r)))[0], expect)


def test_four_gloo_ranks_msm_has_the_limbs_of_the_jax_package(tmp_path):
    """A spawn of four ranks that run the sharded MSM alone: the oracle's
    sum, and the JAX package's Jacobian limbs, on every rank."""
    points, scalars, c = _msm_case()
    ctx, deadline = _spawn_ranks(tmp_path, None, (points, scalars, c))
    try:  # meanwhile, here: the JAX package's sharded MSM
        jax_msm = tuple(np.asarray(t) for t in jdist.sharded_msm(jdist.make_mesh(4), points, scalars, c=c))
    finally:
        join_by(ctx, deadline)
    expect = msm.msm_oracle(points, scalars)
    for r in _rank_outputs(tmp_path):
        got = _rank_msm(r)
        assert O.g_eq(O.FQ_OPS, curve.from_device(curve.g1_spec(), tuple(torch.from_numpy(t) for t in got))[0], expect)
        for g, j in zip(got, jax_msm):
            assert np.array_equal(g.astype(np.uint32), j)


def test_join_by_terminates_a_sleeping_child():
    """A spawned child that would sleep for ten minutes is terminated at a
    deadline 2 s away, and the join fails with its exit code (-SIGTERM)."""
    start = time.monotonic()
    ctx = mp.spawn(_torch_dist_worker.sleep, nprocs=1, join=False, args=(600,))
    with pytest.raises(pytest.fail.Exception, match=r"past their deadline; exit codes \[-15\]"):
        join_by(ctx, time.monotonic() + 2)
    assert not ctx.processes[0].is_alive()
    assert time.monotonic() - start < 60
