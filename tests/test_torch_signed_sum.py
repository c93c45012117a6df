"""The port's level of signed sums against the JAX package's sums, term by term.

`mod_signed_sum` computes out[k] = sum_j s_kj * src[j] mod m in one launch
on the card, s_kj in {+1, -1} or, in its Fq2 form, also {+xi, -xi}; on CPU
tensors it runs its plain version, which composes fq2_xi_plain with
ops/limbs.py's mod_neg, mod_add and mod_sub.  Each case below is a level
the main path runs (its term table, and sources and destinations laid out
as the caller lays them out: slices of a tower element with leading axes,
stacked operands, packed results), or a table with a repeated source.  The
same values go term by term through the JAX package: a xi term through
bn_tpu/fields/tower.py's fq2_mul_by_xi (over Fr, whose xi the JAX tower
does not define, through the same doubling chain of bn_tpu/ops/limbs.py's
mod_add and mod_sub), then bn_tpu/ops/limbs.py's mod_neg, mod_add and
mod_sub on the `jnp` backend; the limbs must be equal.  Every source holds
0, 1 and m - 1 in the last lanes of every row, rotated from source to
source, so the edge values meet each other.  Both moduli.  Tolerance: none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bn_tpu.fields import tower as jtower
from bn_tpu.ops import limbs as jlb
from bn_tpu_torch import params as TP
from bn_tpu_torch.fields import tower as ttower
from bn_tpu_torch.ops import build
from bn_tpu_torch.ops import mont_cuda as mc

from _torch_inputs import SIGNED_SUM_CASES, SUM_B as B, SUM_LEAD as LEAD, signed_sum_case, sum_values

JAX_ROWS = 18  # every source is padded to this many rows: one shape, one compile an operation


def _jax_xi(x, modulus):
    """xi times the flat rows x, (JAX_ROWS, 16, B) read as Fq2 pairs."""
    pairs = x.reshape(JAX_ROWS // 2, 2, 16, B)
    if modulus == TP.Q:
        return jtower.fq2_mul_by_xi(pairs).reshape(x.shape)
    m = TP.int_to_limbs(modulus)
    nine = pairs
    for _ in range(3):
        nine = jlb.mod_add(nine, nine, m)
    nine = jlb.mod_add(nine, pairs, m)
    xi = (jlb.mod_sub(nine[:, 0], pairs[:, 1], m), jlb.mod_add(nine[:, 1], pairs[:, 0], m))
    return jnp.stack(xi, axis=1).reshape(x.shape)


def _jax_level(terms, sources, modulus):
    """The JAX package's xi, mod_neg, mod_add, mod_sub applied term by term."""
    m = TP.int_to_limbs(modulus)
    arrays = np.broadcast_arrays(*[s.numpy() for s in sources])
    shape = arrays[0].shape
    flat = [a.reshape(-1, 16, B).astype(np.uint32) for a in arrays]
    srcs = [jnp.asarray(np.concatenate([f, np.zeros((JAX_ROWS - len(f), 16, B), np.uint32)])) for f in flat]

    def value(i, xi):
        return _jax_xi(srcs[i], modulus) if xi else srcs[i]

    outs = []
    for (i, sign, *xi), *rest in terms:
        acc = value(i, xi) if sign > 0 else jlb.mod_neg(value(i, xi), m)
        for i, sign, *xi in rest:
            acc = (jlb.mod_add if sign > 0 else jlb.mod_sub)(acc, value(i, xi), m)
        outs.append(np.asarray(acc)[: len(flat[0])].reshape(shape))
    return outs


@pytest.mark.parametrize("modulus", [TP.Q, TP.R_SCALAR], ids=["Fq", "Fr"])
@pytest.mark.parametrize("case", SIGNED_SUM_CASES)
def test_signed_sum_equals_jax_term_by_term(case, modulus):
    terms, sources, out, read, fq2 = signed_sum_case(case, modulus)
    want = _jax_level(terms, sources, modulus)
    build.reset_counts()
    got = mc.mod_signed_sum(terms, sources, modulus, out=out, fq2=fq2)
    assert build.COUNTS["mod_signed_sum"] == 0  # a CPU tensor: the plain version
    got = list(got) if read is None else read
    assert len(got) == len(terms)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.uint32), w)
    plain = mc.mod_signed_sum_plain(terms, sources, modulus, fq2=fq2)
    assert all(torch.equal(p, g) for p, g in zip(plain, got))


def test_signed_sum_refuses_overlapping_or_malformed_levels():
    """A destination that overlaps a source or another destination (also as
    interleaved slices of one tensor), tables past the kernel's bounds, a xi
    term on a base-field level, a malformed xi term, and an Fq2 level on
    operands without a dense (2, 16, B) block."""
    a = sum_values(20, (LEAD, 2, 3, 2, B), TP.Q)
    halves = [a.select(-5, 0), a.select(-5, 1)]
    for out in (a.movedim(-5, 0), [halves[1], torch.empty_like(halves[0])], [halves[1], halves[1]]):
        with pytest.raises(ValueError):
            mc.mod_signed_sum(ttower.CONJ, halves, TP.Q, out=out)
    # interleaved but disjoint: each half of a fresh element, written in place
    fresh = torch.full(a.shape, -1, dtype=torch.int32)
    mc.mod_signed_sum(ttower.CONJ, halves, TP.Q, out=fresh.movedim(-5, 0))
    assert torch.equal(fresh, ttower.fq12_conj(a))
    XI = mc.XI
    for terms in ((((0, 1),),) * 17, (((0, 1),) * 5,), (((0, 2),),), (((16, 1),),), (((2, 1),),), (((0, 1, XI),),),
                  (((0, 1), (1, -1, XI)),)):
        with pytest.raises(ValueError):
            mc.mod_signed_sum(terms, halves, TP.Q)
    fq2 = [a[..., 0, :, :, :], a[..., 1, :, :, :]]  # Fq2 coefficients of each half
    for terms in ((((0, 1, "nine"),),), (((0, 2, XI),),), (((0, 1, XI, XI),),), (((16, 1, XI),),), (((2, -1, XI),),)):
        with pytest.raises(ValueError):
            mc.mod_signed_sum(terms, fq2, TP.Q, fq2=True)
    with pytest.raises(ValueError):  # no Fq2 axis before (16, B)
        mc.mod_signed_sum((((0, 1, XI),),), [a[..., 0, 0, 0, :, :]], TP.Q, fq2=True)
    with pytest.raises(ValueError):  # a destination whose coefficients are not one dense block
        mc.mod_signed_sum((((0, 1, XI),),), fq2[:1], TP.Q, out=[torch.empty(fq2[0].shape[:-2] + (B, 16), dtype=torch.int32).transpose(-1, -2)], fq2=True)
    want = mc.fq2_xi_plain(fq2[0], TP.Q)
    fresh = torch.full(fq2[0].shape, -1, dtype=torch.int32)
    mc.mod_signed_sum((((0, 1, XI),),), fq2[:1], TP.Q, out=[fresh], fq2=True)
    assert torch.equal(fresh, want) and torch.equal(ttower.fq2_mul_by_xi(fq2[0]), want)
