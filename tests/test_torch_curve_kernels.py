"""The two curve kernels' plain versions against the JAX package, and the
`curve_kernels` switch of ops/backend.py.

The same seeded points go through

  point_add_plain / point_double_plain   (bn_tpu_torch.ops.curve_cuda)

and through (a) bn_tpu.curve.add / double on the `jnp` backend, called
eagerly, and (b) the Pallas bodies curve_pallas._point_add / _point_double
(lazy reduction) run as register algebra on (8, 128) tiles, as
tests/test_curve_pallas.py runs them.  The batch is 1024 lanes, a full tile:
32 distinct point pairs repeated, so every block of 32 lanes begins and ends
with P + inf, inf + Q, inf + inf, P + P, P + (-P) and one point under two z.
Tolerance: none; the Jacobian limbs are compared as integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bn_tpu import curve as jcurve
from bn_tpu.fields import fp as jfp
from bn_tpu.ops import curve_pallas as cp
from bn_tpu_torch import convert, curve
from bn_tpu_torch.ops import backend, build
from bn_tpu_torch.ops import curve_cuda as cc

from _torch_inputs import curve_points

torch.set_num_threads(1)  # tiny tensors: threads only add overhead

B = 1024
Q_CONST = [np.uint32(int(v)) for v in jfp.FQ.m_limbs]
INV_CONST = np.uint32(int(jfp.FQ.inv))


def _spec(group):
    return curve.g1_spec() if group == "G1" else curve.g2_spec()


def _cpu(pt):
    return convert.from_jax(pt, device="cpu")


@pytest.fixture(scope="module", params=["G1", "G2"])
def tile(request):
    """(group, p, q, plain sum, plain double) at 1024 lanes."""
    group = request.param
    p, q = (tuple(np.tile(c, B // 32) for c in pt) for pt in curve_points(group, 500, (32,)))
    add = convert.to_numpy(cc.point_add_plain(group, _cpu(p), _cpu(q)))
    dbl = convert.to_numpy(cc.point_double_plain(group, _cpu(p)))
    return group, p, q, add, dbl


def test_plain_equals_jax_per_op_law(tile, monkeypatch):
    monkeypatch.setenv("BN_TPU_CURVE_KERNELS", "0")
    group, p, q, add, dbl = tile
    jspec = jcurve.g1_spec() if group == "G1" else jcurve.g2_spec()
    jp, jq = (tuple(jnp.asarray(c) for c in pt) for pt in (p, q))
    for got, want in zip(add, jcurve.add(jspec, jp, jq)):
        assert np.array_equal(got, np.asarray(want))
    for got, want in zip(dbl, jcurve.double(jspec, jp)):
        assert np.array_equal(got, np.asarray(want))


def _tiles(coord, fq2):
    arr = jnp.asarray(coord)
    if not fq2:
        return [arr[i].reshape(8, 128) for i in range(16)]
    return [[arr[j, i].reshape(8, 128) for i in range(16)] for j in range(2)]


def _untile(pt, fq2):
    if not fq2:
        return np.stack([np.asarray(t).reshape(B) for t in pt])
    return np.stack([np.stack([np.asarray(t).reshape(B) for t in comp]) for comp in pt])


def test_plain_equals_pallas_bodies(tile):
    """The TPU kernels' own formulas (curve_pallas.py:258-316), lazy
    reduction and all, on whole tiles."""
    group, p, q, add, dbl = tile
    fq2 = group == "G2"
    F = cp._Fq2K(Q_CONST, INV_CONST) if fq2 else cp._FqK(Q_CONST, INV_CONST)
    pt, qt = ([_tiles(c, fq2) for c in pt] for pt in (p, q))
    for got, want in zip(add, cp._point_add(F, pt, qt)):
        assert np.array_equal(got, _untile(want, fq2))
    for got, want in zip(dbl, cp._point_double(F, *pt)):
        assert np.array_equal(got, _untile(want, fq2))


def test_degenerate_lanes_follow_the_group_law(tile):
    group, p, q, add, _ = tile
    spec = _spec(group)
    inf = curve.is_zero(spec, _cpu(add))
    assert inf[:6].tolist() == [False, False, True, False, True, False]
    assert inf[26:32].tolist() == inf[:6].tolist()
    # P + inf and inf + Q hand the finite operand back limb for limb; P + P
    # and the same point under two z are the doubling
    for k in range(3):
        assert np.array_equal(add[k][..., 0], p[k][..., 0]) and np.array_equal(add[k][..., 1], q[k][..., 1])
        assert np.array_equal(add[k][..., 2], p[k][..., 2])  # inf + inf: p as it came
    dbl = convert.to_numpy(cc.point_double_plain(group, _cpu(p)))
    for k in range(3):
        assert np.array_equal(add[k][..., 3], dbl[k][..., 3]) and np.array_equal(add[k][..., 5], dbl[k][..., 5])


# ---------------------------------------------------------------------------
# the switch, the shapes, the results' storage
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["G1", "G2"])
def small(request):
    group = request.param
    p, q = (_cpu(pt) for pt in curve_points(group, 510, (3, 13)))
    return group, p, q


def test_switch_gives_the_same_limbs_on_cpu_tensors_and_launches_nothing(small):
    group, p, q = small
    spec = _spec(group)
    assert backend.curve_kernels is True and "curve_kernels" in backend.NAMES
    build.reset_counts()
    on = curve.add(spec, p, q) + curve.double(spec, p)
    with backend.fusions(curve_kernels=False):
        assert backend.curve_kernels is False
        off = curve.add(spec, p, q) + curve.double(spec, p)
    assert backend.curve_kernels is True
    assert sum(build.COUNTS.values()) == 0
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    with pytest.raises(TypeError):
        with backend.fusions(curve_kernels=0):
            pass


def test_lead_axes_batch_of_one_and_broadcast(small):
    group, p, q = small
    want = cc.point_add_plain(group, p, q)  # lead 3
    for row in range(3):
        got = cc.point_add(group, tuple(t[row] for t in p), tuple(t[row] for t in q))
        assert all(torch.equal(g, w[row]) for g, w in zip(got, want))
    one_p, one_q = (tuple(t[1, ..., 7:8] for t in pt) for pt in (p, q))
    got = cc.point_add(group, one_p, one_q) + cc.point_double(group, one_p)
    ref = tuple(w[1, ..., 7:8] for w in want) + tuple(w[1, ..., 7:8] for w in cc.point_double_plain(group, p))
    assert all(torch.equal(g, w) for g, w in zip(got, ref))
    # one point against a batch: the six coordinates are brought to one shape
    got = cc.point_add(group, p, one_q)
    wide = tuple(t.expand_as(p[0]) for t in one_q)
    assert all(torch.equal(g, w) for g, w in zip(got, cc.point_add_plain(group, p, wide)))
    assert got[0].shape == p[0].shape


def test_results_are_new_tensors_and_operands_stay(small):
    """acc = add(acc, g), as the MSM accumulates: the wrappers allocate their
    results, so no result shares storage with an operand."""
    group, p, q = small
    before = [t.clone() for t in p + q]
    acc = cc.point_add(group, p, q)
    assert all(torch.equal(t, b) for t, b in zip(p + q, before))
    assert not {t.data_ptr() for t in acc} & {t.data_ptr() for t in p + q}
    dbl = cc.point_double(group, p)
    assert not {t.data_ptr() for t in dbl} & {t.data_ptr() for t in p}


def test_wrappers_refuse_what_the_kernels_cannot_take(small):
    group, p, q = small
    with pytest.raises(ValueError):
        cc.point_add("G3", p, q)
    with pytest.raises(ValueError):
        cc.point_double("g1", p)
    with pytest.raises(ValueError):  # operands on two kinds of device
        cc.point_add(group, p, tuple(t.to("meta") for t in q))


@pytest.mark.parametrize("name", ["point_add", "point_double"])
@pytest.mark.parametrize("group", ["G1", "G2"])
def test_the_width_rule_picks_the_design_by_lanes(name, group):
    """The team below the measured crossover, the one-thread design from it
    on: the MSM's 2^20 lanes above it, curve.mul's 8192 and a batch of one
    below.  forced_design holds one design for the while, leaves the CPU's
    plain version as it is, and refuses an unknown design."""
    cut = cc.THREAD_FROM_LANES[name]
    assert 8192 < cut <= 1 << 20
    assert cc.design_for(name, cut - 1) == cc.design_for(name, 1) == "team"
    assert cc.design_for(name, cut) == cc.design_for(name, 1 << 20) == "thread"
    assert set(cc.DESIGNS) == {"team", "thread"}
    p = curve.one(curve.g1_spec() if group == "G1" else curve.g2_spec(), (2,), device="cpu")
    args = [p] * (2 if name == "point_add" else 1)
    with cc.forced_design("thread"):
        assert cc.design_for(name, 1) == "thread"
        got = getattr(cc, name)(group, *args)
    assert cc.design_for(name, 1) == "team"
    assert all(torch.equal(g, w) for g, w in zip(got, getattr(cc, name + "_plain")(group, *args)))
    with pytest.raises(ValueError), cc.forced_design("warp"):
        getattr(cc, name)(group, *args)


def test_every_kernel_has_a_count_and_a_plain_version():
    # the nineteen TPU kernels' entries and mod_signed_sum, the level of signed sums
    assert len(build.KERNELS) == 20 and {"point_add", "point_double"} <= set(build.COUNTS)
    assert build.ENTRIES["point_add"][0] == build.ENTRIES["point_double"][0] == "kernels_curve"
    assert "-DBN_MUL_OUT_OF_LINE" in build.SOURCE_FLAGS["kernels_curve"]
    for name in ("point_add", "point_double"):
        assert callable(getattr(cc, name)) and callable(getattr(cc, name + "_plain"))
