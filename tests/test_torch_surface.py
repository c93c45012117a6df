"""The public field and tower functions of the JAX package that the port
defines beside its kernels: fp.mul_small, tower.fq2_mul_const, fq6_sq,
fq6_scale_fq2, fq6_neg, fq12_cyclotomic_pow_z and fq12_exp_by_neg_z.

Seeded numpy limbs (tests/_torch_inputs.py rand_field: 0, 1, m-1, the
Montgomery one, then random values) go through the JAX function on the `jnp`
backend (tests/conftest.py selects it) and through the port on CPU tensors, at B = 4 with no lead axis and B = 2 at lead (2,): the JAX
side gets the lead folded into its batch, so that both cases run on one
shape and an op compiles once for both.  mul_small runs eagerly; the tower
functions through jax.jit, as eagerly their primitives compile one by one
(fq6_sq 14 s on 8 cores, every run), jitted in 0.3-6 s once, which the
persistent compile cache keeps.  The two z-ladders are
held against the JAX package's oracle (bn_tpu.oracle.fq12_exp_by_neg_z) on
cyclotomic elements, which keeps the scan of bn_tpu.fields.tower out of an
XLA compile.  Tolerance: none; the limbs are integers, compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bn_tpu import oracle as JO
from bn_tpu.fields import fp as jfp
from bn_tpu.fields import tower as jtower
from bn_tpu_torch import convert
from bn_tpu_torch import params as TP
from bn_tpu_torch.fields import fp as tfp
from bn_tpu_torch.fields import tower as ttower
from bn_tpu_torch.ops import mont_cuda as mc

from _torch_inputs import rand_field

B = 4  # lanes of a lead-free case; a lead-2 case has B // 2 a row
LEADS = [(), (2,)]
FQ6 = (3, 2)
_SPECS = {"Fq": (jfp.FQ, tfp.FQ), "Fr": (jfp.FR, tfp.FR)}
_J_FQ2_MUL_CONST = jax.jit(jtower.fq2_mul_const)
_J_FQ6_SQ = jax.jit(jtower.fq6_sq)
_J_FQ6_SCALE_FQ2 = jax.jit(jtower.fq6_scale_fq2)
_J_FQ6_NEG = jax.jit(jtower.fq6_neg)


def _lanes(lead):
    return B // int(np.prod(lead, dtype=int))


def _fold(a):
    """(2, ..., 16, b) -> (..., 16, 2 b), lane l b + j from row l, lane j."""
    a = np.moveaxis(a, 0, -2)
    return a.reshape(a.shape[:-2] + (-1,))


def _unfold(a, rows):
    return np.moveaxis(a.reshape(a.shape[:-1] + (rows, -1)), -2, 0)


def _both(jax_fn, torch_fn, arrays, lead):
    got = convert.to_numpy(torch_fn(*convert.from_jax(tuple(arrays), device="cpu")))
    if lead:
        want = _unfold(np.asarray(jax_fn(*[jnp.asarray(_fold(a)) for a in arrays])), lead[0])
    else:
        want = np.asarray(jax_fn(*[jnp.asarray(a) for a in arrays]))
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("lead", LEADS, ids=["lead0", "lead2"])
@pytest.mark.parametrize("field", ["Fq", "Fr"])
def test_mul_small(field, lead):
    js, ts = _SPECS[field]
    a = rand_field(31, lead + (_lanes(lead),), ts.modulus)
    for k in (1, 2, 3, 8, 9):
        _both(lambda x: jfp.mul_small(js, x, k), lambda x: tfp.mul_small(ts, x, k), [a], lead)
    with pytest.raises(ValueError):
        tfp.mul_small(ts, convert.from_jax(a, device="cpu"), 0)


@pytest.mark.parametrize("lead", LEADS, ids=["lead0", "lead2"])
def test_fq2_mul_const_on_the_frobenius_constants(lead):
    a = rand_field(32, lead + (2, _lanes(lead)))
    tables, jtables = ttower._frob_consts(), jtower._frob_consts()
    for table, jtable in zip(tables, jtables):
        for c, jc in zip(table, jtable):
            assert c.shape == (2, TP.NLIMBS, 1) and np.array_equal(c, np.asarray(jc))
            _both(lambda x: _J_FQ2_MUL_CONST(x, jc), lambda x: ttower.fq2_mul_const(x, c), [a], lead)


@pytest.mark.parametrize("lead", LEADS, ids=["lead0", "lead2"])
def test_fq6_sq_scale_neg(lead):
    a = rand_field(33, lead + FQ6 + (_lanes(lead),))
    k = rand_field(34, lead + (2, _lanes(lead)))
    _both(_J_FQ6_SQ, ttower.fq6_sq, [a], lead)
    _both(_J_FQ6_SCALE_FQ2, ttower.fq6_scale_fq2, [a, k], lead)
    _both(_J_FQ6_NEG, ttower.fq6_neg, [a], lead)


def test_fq6_sq_is_three_levels_and_one_product(monkeypatch):
    """CH-SQR2's five products in one fq2_mul call; its sums in three levels,
    as r2 = s1 + s2 + s3 - s0 - s4 has seven terms and a level four."""
    calls = {"mod_signed_sum": 0, "fq2_mul": 0, "mod_add": 0, "mod_sub": 0, "mod_neg": 0, "fq2_xi": 0}
    for op in calls:
        def counted(*args, _op=op, _fn=getattr(mc, op), **kwargs):
            calls[_op] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mc, op, counted)
    ttower.fq6_sq(convert.from_jax(rand_field(35, FQ6 + (2,)), device="cpu"))
    assert calls == {"mod_signed_sum": 3, "fq2_mul": 1, "mod_add": 0, "mod_sub": 0, "mod_neg": 0, "fq2_xi": 0}


def _cyclotomic(seed, n):
    """n cyclotomic elements: the easy part f^((q^6 - 1)(q^2 + 1)) of random
    Fq12 elements f, by the JAX package's oracle."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        f = tuple(tuple(tuple(int.from_bytes(rng.bytes(40), "big") % TP.Q for _ in range(2))
                        for _ in range(3)) for _ in range(2))
        c = JO.fq12_mul(JO.fq12_conj(f), JO.fq12_inv(f))
        out.append(JO.fq12_mul(JO.fq12_frob(c, 2), c))
    return out


def _fq12_limbs(vals, lead):
    """The JAX package's limbs of B oracle Fq12 values, as lead rows."""
    a = np.asarray(jtower.fq12_to_device(vals))
    return _unfold(a, lead[0]) if lead else a


@pytest.mark.parametrize("name, lead", [("fq12_exp_by_neg_z", ()), ("fq12_cyclotomic_pow_z", (2,))],
                         ids=["exp_by_neg_z-lead0", "cyclotomic_pow_z-lead2"])
def test_z_ladders_equal_the_oracle(name, lead):
    """One ladder a function (4 s on the CPU), one lead shape each: the two
    share their ladder, fq12_exp_by_neg_z being the conjugate of the other."""
    vals = _cyclotomic(36, B)
    want = [JO.fq12_exp_by_neg_z(v) for v in vals]
    if name == "fq12_cyclotomic_pow_z":
        want = [JO.fq12_conj(v) for v in want]
    got = getattr(ttower, name)(convert.from_jax(_fq12_limbs(vals, lead), device="cpu"))
    assert np.array_equal(convert.to_numpy(got), _fq12_limbs(want, lead))
