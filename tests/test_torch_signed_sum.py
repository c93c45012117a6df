"""The port's level of signed sums against the JAX package's sums, term by term.

`mod_signed_sum` computes out[k] = sum_j s_kj * src[j] mod m in one launch
on the card; on CPU tensors it runs its plain version, which composes
ops/limbs.py's mod_neg, mod_add and mod_sub.  Each case below is a level
the main path runs (its term table, and sources and destinations laid out
as the caller lays them out: slices of a tower element with leading axes,
stacked operands, packed results), or a table with a repeated source.  The
same values go term by term through bn_tpu/ops/limbs.py's mod_neg, mod_add
and mod_sub on the `jnp` backend; the limbs must be equal.  Every source
holds 0, 1 and m - 1 in the last lanes of every row, rotated from source to
source, so the edge values meet each other.  Both moduli.  Tolerance: none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bn_tpu.ops import limbs as jlb
from bn_tpu_torch import params as TP
from bn_tpu_torch.fields import tower as ttower
from bn_tpu_torch.ops import build
from bn_tpu_torch.ops import mont_cuda as mc

from _torch_inputs import SIGNED_SUM_CASES, SUM_B as B, SUM_LEAD as LEAD, signed_sum_case, sum_values

JAX_ROWS = 18  # every source is padded to this many rows: one shape, one compile an operation


def _jax_level(terms, sources, modulus):
    """The JAX package's mod_neg, mod_add, mod_sub applied term by term."""
    m = TP.int_to_limbs(modulus)
    arrays = np.broadcast_arrays(*[s.numpy() for s in sources])
    shape = arrays[0].shape
    flat = [a.reshape(-1, 16, B).astype(np.uint32) for a in arrays]
    srcs = [jnp.asarray(np.concatenate([f, np.zeros((JAX_ROWS - len(f), 16, B), np.uint32)])) for f in flat]
    outs = []
    for (i, sign), *rest in terms:
        acc = srcs[i] if sign > 0 else jlb.mod_neg(srcs[i], m)
        for i, sign in rest:
            acc = (jlb.mod_add if sign > 0 else jlb.mod_sub)(acc, srcs[i], m)
        outs.append(np.asarray(acc)[: len(flat[0])].reshape(shape))
    return outs


@pytest.mark.parametrize("modulus", [TP.Q, TP.R_SCALAR], ids=["Fq", "Fr"])
@pytest.mark.parametrize("case", SIGNED_SUM_CASES)
def test_signed_sum_equals_jax_term_by_term(case, modulus):
    terms, sources, out, read = signed_sum_case(case, modulus)
    want = _jax_level(terms, sources, modulus)
    build.reset_counts()
    got = mc.mod_signed_sum(terms, sources, modulus, out=out)
    assert build.COUNTS["mod_signed_sum"] == 0  # a CPU tensor: the plain version
    got = list(got) if read is None else read
    assert len(got) == len(terms)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.uint32), w)
    plain = mc.mod_signed_sum_plain(terms, sources, modulus)
    assert all(torch.equal(p, g) for p, g in zip(plain, got))


def test_signed_sum_refuses_overlapping_or_malformed_levels():
    """A destination that overlaps a source or another destination (also as
    interleaved slices of one tensor), and tables past the kernel's bounds."""
    a = sum_values(20, (LEAD, 2, 3, 2, B), TP.Q)
    halves = [a.select(-5, 0), a.select(-5, 1)]
    for out in (a.movedim(-5, 0), [halves[1], torch.empty_like(halves[0])], [halves[1], halves[1]]):
        with pytest.raises(ValueError):
            mc.mod_signed_sum(ttower.CONJ, halves, TP.Q, out=out)
    # interleaved but disjoint: each half of a fresh element, written in place
    fresh = torch.full(a.shape, -1, dtype=torch.int32)
    mc.mod_signed_sum(ttower.CONJ, halves, TP.Q, out=fresh.movedim(-5, 0))
    assert torch.equal(fresh, ttower.fq12_conj(a))
    for terms in ((((0, 1),),) * 17, (((0, 1),) * 5,), (((0, 2),),), (((16, 1),),), (((2, 1),),)):
        with pytest.raises(ValueError):
            mc.mod_signed_sum(terms, halves, TP.Q)
