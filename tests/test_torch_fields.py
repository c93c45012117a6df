"""Every kernel-holding function of the port against its JAX counterpart.

The same seeded numpy limbs (0, 1, m-1, the Montgomery one, then random
values) go through the JAX function on the `jnp` backend (tests/conftest.py
selects it) and through the port on CPU tensors, where each wrapper runs its
kernel's plain version.  Tolerance: none; the limbs are integers and are
compared with np.array_equal.  The JAX functions run eagerly, so no test here
starts a large compile.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bn_tpu.fields import fp as jfp
from bn_tpu.fields import tower as jtower
from bn_tpu_torch import convert
from bn_tpu_torch import params as TP
from bn_tpu_torch.fields import fp as tfp
from bn_tpu_torch.fields import tower as ttower
from bn_tpu_torch.ops import build
from bn_tpu_torch.ops import mont_cuda as mc
from bn_tpu_torch.ops import tower_cuda as tc

from _torch_inputs import rand_field

B = 6  # holds the four edge values and two random ones per row
FQ12 = (2, 3, 2)


def _both(jax_fn, torch_fn, arrays):
    want = np.asarray(jax_fn(*[jnp.asarray(a) for a in arrays]))
    got = torch_fn(*convert.from_jax(tuple(arrays), device="cpu"))
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    got = convert.to_numpy(got)
    assert got.dtype == np.uint32 and got.shape == want.shape
    assert np.array_equal(got, want)


_SPECS = {"Fq": (jfp.FQ, tfp.FQ), "Fr": (jfp.FR, tfp.FR)}


@pytest.mark.parametrize("field", ["Fq", "Fr"])
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_base_field_binary(field, op):
    js, ts = _SPECS[field]
    arrays = [rand_field(s, (3, B), ts.modulus) for s in (11, 12)]
    arrays[1] = arrays[1][:, :, ::-1].copy()  # pair 0 with random, m-1 with 1, ...
    _both(lambda a, b: getattr(jfp, op)(js, a, b), lambda a, b: getattr(tfp, op)(ts, a, b), arrays)


@pytest.mark.parametrize("field", ["Fq", "Fr"])
def test_base_field_neg(field):
    js, ts = _SPECS[field]
    _both(lambda a: jfp.neg(js, a), lambda a: tfp.neg(ts, a), [rand_field(13, (3, B), ts.modulus)])


@pytest.mark.parametrize("field", ["Fq", "Fr"])
def test_base_field_broadcast_against_constant(field):
    """(…, 16, B) against (16, 1): the wrappers broadcast as the JAX ones do."""
    js, ts = _SPECS[field]
    a = rand_field(14, (2, B), ts.modulus)
    k = rand_field(15, (1,), ts.modulus, specials=False)
    _both(lambda a, b: jfp.mul(js, a, b), lambda a, b: tfp.mul(ts, a, b), [a, k])


@pytest.mark.parametrize("field", ["Fq", "Fr"])
def test_inv(field):
    js, ts = _SPECS[field]
    _both(lambda a: jfp.inv(js, a), lambda a: tfp.inv(ts, a), [rand_field(16, (B,), ts.modulus)])


_TOWER_CASES = {
    "fq2_mul": (jtower.fq2_mul, ttower.fq2_mul, [(2,), (2,)]),
    "fq2_sq": (jtower.fq2_sq, ttower.fq2_sq, [(2,)]),
    "fq2_xi": (jtower.fq2_mul_by_xi, ttower.fq2_mul_by_xi, [(2,)]),
    "fq12_mul": (jtower.fq12_mul, ttower.fq12_mul, [FQ12, FQ12]),
    "fq12_sq": (jtower.fq12_sq, ttower.fq12_sq, [FQ12]),
    "fq12_mul024_pre": (
        jtower.fq12_mul_by_024_prescaled, ttower.fq12_mul_by_024_prescaled, [FQ12, (2,), (2, 2)],
    ),
    "fq12_cyclo_sq": (jtower.fq12_cyclotomic_sq, ttower.fq12_cyclotomic_sq, [FQ12]),
    "fq12_inv": (jtower.fq12_inv, ttower.fq12_inv, [FQ12]),
    "fq12_conj": (jtower.fq12_conj, ttower.fq12_conj, [FQ12]),
    "fq12_frob1": (lambda a: jtower.fq12_frob(a, 1), lambda a: ttower.fq12_frob(a, 1), [FQ12]),
    "fq12_frob2": (lambda a: jtower.fq12_frob(a, 2), lambda a: ttower.fq12_frob(a, 2), [FQ12]),
    "fq12_frob3": (lambda a: jtower.fq12_frob(a, 3), lambda a: ttower.fq12_frob(a, 3), [FQ12]),
    "fq6_mul": (jtower.fq6_mul, ttower.fq6_mul, [(3, 2), (3, 2)]),
    "fq6_inv": (jtower.fq6_inv, ttower.fq6_inv, [(3, 2)]),
    "fq2_inv": (jtower.fq2_inv, ttower.fq2_inv, [(2,)]),
}


@pytest.mark.parametrize("name", list(_TOWER_CASES))
def test_tower_function(name):
    jax_fn, torch_fn, structs = _TOWER_CASES[name]
    arrays = [rand_field(20 + k, st + (B,)) for k, st in enumerate(structs)]
    _both(jax_fn, torch_fn, arrays)


# Leading batch axes, where the signed sums' levels read slices with a row
# stride and write into packed results: case -> (the _TOWER_CASES function,
# lead, whether the last operand is given as x[None] and broadcast)
_LEAD_CASES = {
    "fq6_mul-lead2": ("fq6_mul", 2, False),
    "fq6_mul-lead2-broadcast": ("fq6_mul", 2, True),
    "fq6_inv-lead3": ("fq6_inv", 3, False),
    "fq2_inv-lead3": ("fq2_inv", 3, False),
    "fq12_inv-lead2": ("fq12_inv", 2, False),
    "fq12_conj-lead3": ("fq12_conj", 3, False),
    "fq12_frob1-lead2": ("fq12_frob1", 2, False),
    "fq12_frob3-lead2": ("fq12_frob3", 2, False),
}


def _fold_lead(x):
    """(lead, ..., 16, b) -> (..., 16, lead * b): the lead axis into the batch."""
    return np.moveaxis(x, 0, -2).reshape(x.shape[1:-1] + (x.shape[0] * x.shape[-1],))


@pytest.mark.parametrize("name", list(_LEAD_CASES))
def test_tower_function_with_leading_axis(name):
    """The port at (lead, ..., 16, B / lead) against the JAX function on the
    same values with the lead folded into the batch: the JAX call has the
    shapes of test_tower_function's, whose eager compiles it reuses."""
    base, lead, broadcast_last = _LEAD_CASES[name]
    jax_fn, torch_fn, structs = _TOWER_CASES[base]
    arrays = [rand_field(90 + k, (lead,) + st + (B // lead,)) for k, st in enumerate(structs)]
    if broadcast_last:
        arrays[-1] = arrays[-1][0]
    want = np.asarray(jax_fn(*[jnp.asarray(_fold_lead(np.broadcast_to(a, arrays[0].shape[:1] + a.shape[-a.ndim:])
                                                          if a.ndim < arrays[0].ndim else a)) for a in arrays]))
    ins = list(convert.from_jax(tuple(arrays), device="cpu"))
    if broadcast_last:
        ins[-1] = ins[-1][None]
    got = torch_fn(*ins)
    assert got.shape[0] == lead
    assert np.array_equal(_fold_lead(convert.to_numpy(got)), want)


def test_fq2_scale_fq_broadcast_of_the_miller_loop():
    """(n, 2, 2, 16, B) coefficients times a (1, 2, 1, 16, B) G1 pair."""
    coeffs = rand_field(30, (5, 2, 2, B))
    yx = rand_field(31, (2, B))
    _both(
        lambda c, k: jtower.fq2_scale_fq(c, k[None]),
        lambda c, k: ttower.fq2_scale_fq(c, k[None]),
        [coeffs, yx],
    )


@pytest.mark.parametrize(
    "name", ["mont_mul", "mod_add", "mod_sub", "mod_neg", "fq2_mul", "fq2_sq", "fq2_xi"]
)
def test_plain_version_is_what_a_cpu_tensor_gets(name):
    """On a CPU tensor a wrapper returns its plain version's result and counts
    no launch."""
    structs = [(2,), (2,)] if name.startswith("fq2") else [(), ()]
    if name in ("mod_neg", "fq2_sq", "fq2_xi"):
        structs = structs[:1]
    ins = convert.from_jax(tuple(rand_field(40 + k, st + (B,)) for k, st in enumerate(structs)), device="cpu")
    build.reset_counts()
    got = getattr(mc, name)(*ins, TP.Q)
    assert torch.equal(got, getattr(mc, name + "_plain")(*ins, TP.Q))
    assert build.COUNTS[name] == 0


@pytest.mark.parametrize("name", ["fq12_mul", "fq12_sq", "fq12_cyclo_sq"])
def test_plain_tower_version_is_what_a_cpu_tensor_gets(name):
    n_in = 2 if name == "fq12_mul" else 1
    ins = convert.from_jax(tuple(rand_field(50 + k, FQ12 + (B,)) for k in range(n_in)), device="cpu")
    build.reset_counts()
    assert torch.equal(getattr(tc, name)(*ins, TP.Q), getattr(tc, name + "_plain")(*ins, TP.Q))
    assert build.COUNTS[name] == 0


# wrapper calls of tower functions on the card: one signed-sum launch a
# level, the products by xi among its terms (no fq2_xi call of its own)
_SUM_OPS = ("mod_add", "mod_sub", "mod_neg", "mod_signed_sum", "fq2_xi")
_LEVEL_CALLS = {
    # fq6_mul twice (2 levels each), the v-multiple difference, fq6_inv (3
    # levels), fq2_inv (1 sum and the conjugate), the conjugate
    "fq12_inv": {"mod_add": 1, "mod_signed_sum": 10},
    "fq12_frob1": {"mod_signed_sum": 1},  # every Fq2 coefficient conjugated at once
    "fq12_conj": {"mod_signed_sum": 1},
}


@pytest.mark.parametrize("name", list(_LEVEL_CALLS))
def test_tower_sums_are_one_call_a_level(name, monkeypatch):
    """The sum wrappers a tower function calls on a B = 2 element: guards the
    launch count of the card's main path without a pairing run."""
    calls = dict.fromkeys(_SUM_OPS, 0)
    for op in _SUM_OPS:
        def counted(*args, _op=op, _fn=getattr(mc, op), **kwargs):
            calls[_op] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mc, op, counted)
    a = convert.from_jax(rand_field(80, FQ12 + (2,)), device="cpu")
    fn = {"fq12_inv": ttower.fq12_inv, "fq12_frob1": lambda x: ttower.fq12_frob(x, 1), "fq12_conj": ttower.fq12_conj}[name]
    fn(a)
    assert calls == {**dict.fromkeys(_SUM_OPS, 0), **_LEVEL_CALLS[name]}


def test_wrapper_refuses_mixed_or_foreign_devices():
    a = convert.from_jax(rand_field(60, (B,)), device="cpu")
    with pytest.raises(ValueError):
        mc.mont_mul(a, a.to("meta"), TP.Q)


def test_creating_functions_default_to_the_card():
    """Without `device` a creating function asks for the card and raises
    where there is none; the tests pass device="cpu"."""
    if torch.cuda.is_available():
        assert tfp.zeros(tfp.FQ, (2,)).device.type == "cuda"
    else:
        for make in (
            lambda: tfp.zeros(tfp.FQ, (2,)),
            lambda: tfp.ones(tfp.FQ, (2,)),
            lambda: tfp.to_device(tfp.FQ, [1, 2]),
            lambda: ttower.ones12((2,)),
            lambda: convert.from_jax(np.zeros((16, 2), np.uint32)),
        ):
            with pytest.raises((RuntimeError, AssertionError)):
                make()
    assert tfp.ones(tfp.FQ, (2,), device="cpu").device.type == "cpu"


def test_convert_roundtrip_over_tuples():
    arrs = (rand_field(70, (B,)), rand_field(71, (2, B)))
    back = convert.to_numpy(convert.from_jax(arrs, device="cpu"))
    assert all(np.array_equal(x, y) and y.dtype == np.uint32 for x, y in zip(arrs, back))
