"""The last two kernels' plain versions — fq12_mul024 (the sparse line
multiply by an unscaled line) and miller_step (one whole Miller step) —
against the JAX package, and the `miller_step` switch of ops/backend.py.

The same seeded numpy limbs go through the JAX function on the `jnp` backend,
called eagerly, and through the port's plain version on CPU tensors:

  fq12_mul024_plain   bn_tpu.fields.tower.fq12_mul_by_024, and the Pallas
                      body _fq12_mul024_body
  miller_step_plain   fq12_mul_by_024(fq12_sq(f) or f, ell_0,
                      fq2_scale_fq(ell_vw, py), fq2_scale_fq(ell_vv, px)),
                      and the Pallas body _miller_step_body, both kinds

The Pallas bodies (lazy reduction) run on the reference shims of
tests/test_pallas_interpret.py, at the one batch they take (a full tile of
1024 lanes).  Tolerance: none; limbs are integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bn_tpu.fields import tower as jtower
from bn_tpu.ops import tower_pallas as twp
from bn_tpu_torch import ate, convert
from bn_tpu_torch import params as TP
from bn_tpu_torch.fields import tower as ttower
from bn_tpu_torch.ops import backend, build
from bn_tpu_torch.ops import tower_cuda as tc

import test_pallas_interpret as shims
from _torch_inputs import rand_field

B = 6


def _cpu(*arrays):
    return convert.from_jax(tuple(arrays), device="cpu")


def _line_inputs(batch, lead=()):
    """f, the line (ell_0, ell_vw, ell_vv) as one (3, 2) struct, and the G1
    point (px, py); lanes 0-3 of each hold 0, 1, q-1 and the Montgomery one."""
    return (rand_field(500, lead + (2, 3, 2, batch)), rand_field(501, lead + (3, 2, batch)),
            rand_field(502, lead + (batch,)), rand_field(503, lead + (batch,)))


def _jax_step(f, coeff, px, py, square):
    """The Miller step as the JAX package's hoisted loop computes it."""
    f, coeff, px, py = (jnp.asarray(x) for x in (f, coeff, px, py))
    g = jtower.fq12_sq(f) if square else f
    return jtower.fq12_mul_by_024(g, coeff[..., 0, :, :, :], jtower.fq2_scale_fq(coeff[..., 1, :, :, :], py),
                                  jtower.fq2_scale_fq(coeff[..., 2, :, :, :], px))


def test_fq12_mul024_plain_equals_jax_and_the_tower_function():
    f, coeff, _, _ = _line_inputs(B)
    want = np.asarray(jtower.fq12_mul_by_024(*(jnp.asarray(x) for x in (f, coeff[0], coeff[1], coeff[2]))))
    got = tc.fq12_mul024_plain(*_cpu(f, coeff), TP.Q)
    assert np.array_equal(convert.to_numpy(got), want)
    build.reset_counts()
    via_tower = ttower.fq12_mul_by_024(*_cpu(f, coeff[0], coeff[1], coeff[2]))
    assert sum(build.COUNTS.values()) == 0  # CPU tensors launch nothing
    assert np.array_equal(convert.to_numpy(via_tower), want)


def test_fq12_mul024_on_the_scaled_line_equals_fq12_mul024_pre():
    """The two sparse multiplies share one formula: the unscaled struct's
    (ell_vw, ell_vv) are slots 1 and 2, the pre-scaled pair's slots 0 and 1."""
    f, coeff, _, _ = _line_inputs(B)
    tf, tcoeff = _cpu(f, coeff)
    got = tc.fq12_mul024(tf, tcoeff, TP.Q)
    assert torch.equal(got, tc.fq12_mul024_pre(tf, tcoeff[0], tcoeff[1:], TP.Q))
    swapped = tc.fq12_mul024(tf, tcoeff[[0, 2, 1]], TP.Q)
    assert not torch.equal(got, swapped)


@pytest.mark.parametrize("square", [True, False], ids=["doubling-step", "addition-step"])
def test_miller_step_plain_equals_jax(square):
    f, coeff, px, py = _line_inputs(B)
    want = np.asarray(_jax_step(f, coeff, px, py, square))
    got = tc.miller_step_plain(*_cpu(f, coeff, px, py), square)
    assert np.array_equal(convert.to_numpy(got), want)


def test_fq12_mul024_plain_equals_pallas_body():
    f, coeff, _, _ = _line_inputs(shims.B)
    (want,) = shims._run_body(twp._fq12_mul024_body, [(f, (2, 3, 2)), (coeff, (3, 2))], [(2, 3, 2)],
                              q=shims.Q_CONST, inv=shims.INV_CONST)
    assert np.array_equal(convert.to_numpy(tc.fq12_mul024_plain(*_cpu(f, coeff), TP.Q)), np.asarray(want))


@pytest.mark.parametrize("square", [True, False], ids=["miller_sq_step", "miller_step"])
def test_miller_step_plain_equals_pallas_body(square):
    """Both kinds of the TPU kernel (tower_pallas.py builds them as
    miller_sq_step and miller_step) on the reference shims."""
    f, coeff, px, py = _line_inputs(shims.B)
    (want,) = shims._run_body(twp._miller_step_body, [(f, (2, 3, 2)), (coeff, (3, 2)), (px, ()), (py, ())],
                              [(2, 3, 2)], q=shims.Q_CONST, inv=shims.INV_CONST, do_sq=square)
    got = tc.miller_step_plain(*_cpu(f, coeff, px, py), square)
    assert np.array_equal(convert.to_numpy(got), np.asarray(want))


def test_leading_axes_and_broadcast():
    """Lead (2, 3) against the same lanes one lead row at a time; the line
    and the point broadcast from fewer leading axes."""
    f, coeff, px, py = _cpu(*_line_inputs(4, lead=(2, 3)))
    got = tc.fq12_mul024(f, coeff, TP.Q)
    step = tc.miller_step(f, coeff, px, py, True)
    assert tuple(got.shape) == tuple(step.shape) == (2, 3, 2, 3, 2, 16, 4)
    for i in range(2):
        for j in range(3):
            assert torch.equal(got[i, j], tc.fq12_mul024_plain(f[i, j], coeff[i, j], TP.Q))
            assert torch.equal(step[i, j], tc.miller_step_plain(f[i, j], coeff[i, j], px[i, j], py[i, j], True))
    # one line and one point for all six rows
    got_b = tc.fq12_mul024(f, coeff[1, 2], TP.Q)
    step_b = tc.miller_step(f, coeff[1, 2], px[1, 2], py[1, 2], False)
    for i in range(2):
        for j in range(3):
            assert torch.equal(got_b[i, j], tc.fq12_mul024_plain(f[i, j], coeff[1, 2], TP.Q))
            assert torch.equal(step_b[i, j], tc.miller_step_plain(f[i, j], coeff[1, 2], px[1, 2], py[1, 2], False))


def test_miller_step_writes_into_the_destination_it_is_given():
    f, coeff, px, py = _cpu(*_line_inputs(B))
    want = tc.miller_step(f, coeff, px, py, True)
    slab = torch.full((2, 2, 3, 2, 16, B), -1, dtype=torch.int32)
    got = tc.miller_step(f, coeff, px, py, True, out=slab[1])
    assert got.data_ptr() == slab[1].data_ptr() and torch.equal(slab[1], want)
    assert bool((slab[0] == -1).all())
    fresh = tc.miller_step(f, coeff, px, py, False)
    assert all(fresh.data_ptr() != t.data_ptr() for t in (f, coeff, px, py))
    with pytest.raises(ValueError):  # a destination may not be an operand
        tc.miller_step(f, coeff, px, py, True, out=f)
    with pytest.raises(ValueError):
        tc.miller_step(f, coeff, px, py, True, out=torch.empty((2, 3, 2, 16, B + 1), dtype=torch.int32))


def test_miller_loop_both_paths_with_leading_axes():
    """The switch on CPU tensors: random line coefficients of 102 steps with
    leading axes (2,) and batch 2 through the hoisted loop and the Miller-step
    loop equal the hoisted loop on the same lanes laid out flat (batch 4); no
    launch is counted."""
    coeffs = torch.from_numpy(rand_field(510, (102, 3, 2, 2, 2)).astype(np.int32))  # (102, 3, lead, 2, 16, B)
    px, py = (torch.from_numpy(rand_field(s, (2, 2)).astype(np.int32)) for s in (511, 512))
    flat = ate.miller_loop(coeffs.permute(0, 1, 3, 4, 2, 5).reshape(102, 3, 2, 16, 4),
                           tuple(t.permute(1, 0, 2).reshape(16, 4) for t in (px, py)))
    want = flat.reshape(2, 3, 2, 16, 2, 2).permute(4, 0, 1, 2, 3, 5)
    build.reset_counts()
    assert backend.miller_step is False
    hoisted = ate.miller_loop(coeffs, (px, py))
    with backend.fusions(miller_step=True):
        stepped = ate.miller_loop(coeffs, (px, py))
    assert sum(build.COUNTS.values()) == 0
    assert torch.equal(hoisted, want) and torch.equal(stepped, want)
