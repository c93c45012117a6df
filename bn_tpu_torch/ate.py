"""Batched optimal ate pairing: G2 precompute, Miller loop, final exponentiation.

Counterpart of the JAX package's ate.py (reference engine:
src/groups/mod.rs:441-771).  The 65-bit ate ladder's schedule is a fixed
property of 6z+2, so it is a static 102-slot step list
(params.miller_schedule) walked by a Python loop: no data-dependent control
flow ever reaches the device.

Everything operates on batches: precompute carries the running G2 point
through the ladder and emits the (102, 3, 2, L, B) line-coefficient tensor;
the Miller loop replays it against a batch of G1 points; infinite inputs are
masked to Gt one at the end (src/groups/mod.rs:764-771).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import curve
from . import oracle as O
from . import params as P
from .fields import tower
from .ops import backend
from .ops import mont_cuda as mc
from .ops import tower_cuda as tc


@functools.lru_cache(maxsize=None)
def _mulq_consts(device_str: str):
    """The twist-Frobenius coefficients of x and y stacked, (2, 2, L, 1), on
    one device."""
    mulq_x, mulq_y = O.twist_frob_coeffs()
    host = np.stack([tower._fq2_const(mulq_x), tower._fq2_const(mulq_y)])
    return torch.from_numpy(host.astype(np.int32)).to(torch.device(device_str))


def _doubling_step(r):
    """(src/groups/mod.rs:612-634) as a few dozen Fq2-sized kernel calls."""
    return tc.g2_double_step(tower._F, r, *tc.step_consts(str(r[0].device)))


def _mixed_addition_step(r, base):
    """(src/groups/mod.rs:591-610) as a few dozen Fq2-sized kernel calls."""
    return tc.g2_madd_step(tower._F, r, base)


# the conjugates of x and y from their coefficients x0 x1 y0 y1; with y's
# signs flipped, the conjugate of -y
CONJ_XY = (((0, 1),), ((1, -1),), ((2, 1),), ((3, -1),))
CONJ_X_NEG_Y = (((0, 1),), ((1, -1),), ((2, -1),), ((3, 1),))


def _mul_by_q(a, negate: bool = False):
    """Untwist-Frobenius-twist on affine G2 (src/groups/mod.rs:550-555): both
    conjugates in one launch, both products by the constants in one fq2_mul.
    With `negate` the point is negated too, -(conj(y) c) = (-conj(y)) c: a
    sign of the same launch.  Returns (x, y) stacked, (2, ..., 2, L, B)."""
    x, y = a
    conj = x.new_empty((2,) + tuple(x.shape))
    srcs = (tower.c2(x, 0), tower.c2(x, 1), tower.c2(y, 0), tower.c2(y, 1))
    outs = [tower.c2(conj[k], c) for k in range(2) for c in range(2)]
    mc.mod_signed_sum(CONJ_X_NEG_Y if negate else CONJ_XY, srcs, P.Q, out=outs)
    cs = _mulq_consts(str(x.device))
    return tower.fq2_mul(conj, cs.reshape((2,) + (1,) * (x.dim() - 3) + tuple(cs.shape[1:])))


def _ladder_inputs(q_affine):
    """Step flags, per-step base index, and the three base points (Q, q1, -q2),
    each stacked (..., 2, 2, L, B).

    The final two ladder slots add the Frobenius-twisted points q1 and -q2
    (src/groups/mod.rs:578-582): index 0 = Q for the ladder, 1 = q1, 2 = -q2."""
    flags = P.miller_schedule()
    bx, by = q_affine
    q1 = _mul_by_q((bx, by))
    q2 = _mul_by_q(tuple(q1), negate=True)
    bases = (torch.stack([bx, by], dim=-4), q1.movedim(0, -4), q2.movedim(0, -4))
    base_idx = [0] * len(flags)
    base_idx[-2], base_idx[-1] = 1, 2
    return flags, base_idx, bases


def _precompute_fused(q_affine):
    """The ladder with one `double_step` / `madd_step` kernel per step.  The
    result tensor is allocated once and each step writes its own slice; the
    running point goes back and forth between two buffers; the three base
    points come stacked from _ladder_inputs."""
    flags, base_idx, bases = _ladder_inputs(q_affine)
    bx, by = q_affine
    lead = bx.dim() - 3
    batch_shape = tuple(bx.shape[:-3]) + (bx.shape[-1],)
    r = torch.stack([bx, by, tower.ones2(batch_shape, bx.device)], dim=-4)  # (*lead, 3, 2, L, B)
    coeffs = torch.empty((len(flags),) + tuple(r.shape), dtype=r.dtype, device=r.device)
    spare = torch.empty_like(r)
    for k, (is_add, idx) in enumerate(zip(flags, base_idx)):
        if is_add:
            tc.madd_step(r, bases[idx], r_out=spare, coeffs_out=coeffs[k])
        else:
            tc.double_step(r, r_out=spare, coeffs_out=coeffs[k])
        r, spare = spare, r
    # the steps keep leading batch axes in front of the (3, 2) struct; the
    # result has them behind the coefficient axis, as the unfused ladder does
    return coeffs.movedim(lead + 1, 1) if lead else coeffs


def precompute(q_affine):
    """Line-coefficient precompute over a batch of affine G2 points.

    Returns a (102, 3, 2, L, B) tensor of EllCoeffs in ladder order
    (src/groups/mod.rs:557-588; count invariant asserted at :761).  With the
    `ladder` switch of ops/backend.py on (the default) every step is one
    kernel; otherwise a few dozen Fq2-sized ones.  Same limbs either way.
    """
    if backend.ladder:
        return _precompute_fused(q_affine)
    flags, base_idx, bases = _ladder_inputs(q_affine)
    bx, by = q_affine
    batch_shape = tuple(bx.shape[:-3]) + (bx.shape[-1],)
    r = (bx, by, tower.ones2(batch_shape, bx.device))
    coeffs = []
    for is_add, idx in zip(flags, base_idx):
        if is_add:
            r, c = _mixed_addition_step(r, (tower.c6(bases[idx], 0), tower.c6(bases[idx], 1)))
        else:
            r, c = _doubling_step(r)
        coeffs.append(c)
    return torch.stack(coeffs)


def miller_loop(coeffs, p_affine):
    """Replay coefficients against affine G1 points (src/groups/mod.rs:485-520).

    coeffs is precompute's (102, 3, ..., 2, L, B) tensor, p_affine (px, py)
    with px (..., L, B).  With the `miller_step` switch of ops/backend.py on,
    every ladder step is one `miller_step` kernel that squares (on a doubling
    step), scales the line by the G1 point and multiplies it in; otherwise
    (the default) the scaling is hoisted out of the loop and each step is an
    `fq12_sq` (doubling steps) and an `fq12_mul024_pre` launch.  Same limbs
    either way."""
    flags = P.miller_schedule()
    px, py = p_affine
    batch_shape = tuple(px.shape[:-2]) + (px.shape[-1],)
    f = tower.ones12(batch_shape, px.device)
    # a step's struct axis goes behind the leading batch axes, where the
    # kernels take it: (102, ..., 3, 2, L, B); a view when there are none
    steps = coeffs.movedim(1, -4).contiguous()

    if backend.miller_step:
        px, py = px.contiguous(), py.contiguous()
        spare = torch.empty_like(f)
        for k, is_add in enumerate(flags):
            tc.miller_step(f, steps[k], px, py, square=not is_add, out=spare)
            f, spare = spare, f
        return f

    # The G1 scaling is hoisted out of the loop: every step's (ell_vw, ell_vv)
    # is multiplied by (g1.y, g1.x) in one batched product over all 102 steps
    # (semantics per step identical to the reference, src/groups/mod.rs:500-508).
    yx = torch.stack([py, px], dim=-3)  # (..., 2, L, B)
    scaled = tower.fq2_scale_fq(steps[..., 1:3, :, :, :], yx)  # (102, ..., 2, 2, L, B)

    for k, is_add in enumerate(flags):
        if not is_add:
            f = tower.fq12_sq(f)
        f = tower.fq12_mul_by_024_prescaled(f, steps[k, ..., 0, :, :, :], scaled[k])
    return f


def pairing_batch(p_jac, q_jac):
    """Full reduced pairing over batches of Jacobian G1/G2 points; infinite
    inputs yield Gt one (src/groups/mod.rs:764-771)."""
    g1s, g2s = curve.g1_spec(), curve.g2_spec()
    p_inf = curve.is_zero(g1s, p_jac)
    q_inf = curve.is_zero(g2s, q_jac)
    pa = curve.to_affine(g1s, p_jac)
    qa = curve.to_affine(g2s, q_jac)
    coeffs = precompute(qa)
    f = miller_loop(coeffs, pa)
    out = tower.final_exponentiation(f)
    ones = tower.ones12(tuple(pa[0].shape[:-2]) + (pa[0].shape[-1],), pa[0].device)
    mask = (p_inf | q_inf)[..., None, None, None, None, :]
    return torch.where(mask, ones, out)


def miller_batch(p_jac, q_jac):
    """Miller loop without final exponentiation (for products of pairings:
    multiply Miller outputs, then one shared final exponentiation)."""
    g1s, g2s = curve.g1_spec(), curve.g2_spec()
    pa = curve.to_affine(g1s, p_jac)
    qa = curve.to_affine(g2s, q_jac)
    return miller_loop(precompute(qa), pa)
