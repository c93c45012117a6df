"""The four fused kernels' plain versions against the JAX package, and the
switch of ops/backend.py that chooses between the fused and the unfused path.

The same seeded numpy limbs go through the JAX function on the `jnp` backend
(called eagerly, the two unfused steps under a small jax.jit) and through the
port's plain version on CPU tensors:

  pow_fixed_plain            bn_tpu.fields.fp.pow_fixed and Python's pow
  fq12_cyclo_sq_chain_plain  bn_tpu.fields.tower._cyclo_sq_run
  double_step_plain          bn_tpu.ate._doubling_step, and the Pallas body
  madd_step_plain            bn_tpu.ate._mixed_addition_step, and the Pallas body

The Pallas bodies (lazy reduction) run on the reference-shims of
tests/test_pallas_interpret.py, at the one batch they take (a full tile of
1024 lanes).  Tolerance: none; limbs are integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bn_tpu import ate as jate
from bn_tpu.fields import fp as jfp
from bn_tpu.fields import tower as jtower
from bn_tpu.ops import tower_pallas as twp
from bn_tpu_torch import convert
from bn_tpu_torch import params as TP
from bn_tpu_torch.fields import fp as tfp
from bn_tpu_torch.fields import tower as ttower
from bn_tpu_torch.ops import backend, build
from bn_tpu_torch.ops import curve_cuda as cc
from bn_tpu_torch.ops import mont_cuda as mc
from bn_tpu_torch.ops import tower_cuda as tc

import test_pallas_interpret as shims
from _torch_inputs import rand_field

B = 6
_SPECS = {"Fq": (jfp.FQ, tfp.FQ), "Fr": (jfp.FR, tfp.FR)}


def _cpu(*arrays):
    return convert.from_jax(tuple(arrays), device="cpu")


@pytest.mark.parametrize("field", ["Fq", "Fr"])
@pytest.mark.parametrize("exponent", ["m-2", 0xA0B7F03], ids=["fermat", "interior-zero-digit"])
def test_pow_fixed_plain(field, exponent):
    js, ts = _SPECS[field]
    m = ts.modulus
    e = m - 2 if exponent == "m-2" else exponent
    a = rand_field(200, (2, B), m)  # lanes 0, 1, m-1, the Montgomery one, then random
    got = convert.to_numpy(mc.pow_fixed_plain(*_cpu(a), e, m))
    assert np.array_equal(got, np.asarray(jfp.pow_fixed(js, jnp.asarray(a), e)))
    vals = [TP.from_mont(v, m) for v in TP.limbs_to_ints(a[0])]
    assert TP.limbs_to_ints(got[0]) == [TP.to_mont(pow(v, e, m), m) for v in vals]
    assert TP.limbs_to_ints(got[0])[0] == 0  # 0 -> 0


def test_pow_fixed_refuses_what_the_kernel_cannot_take():
    a = _cpu(rand_field(201, (B,)))[0]
    for bad in (0, -3):
        with pytest.raises(ValueError):
            mc.pow_fixed(a, bad, TP.Q)
    with pytest.raises(ValueError):
        mc._pow_args(1 << 256, TP.Q)


def test_cyclo_sq_chain_plain():
    a = rand_field(210, (2, 3, 2, B))
    got = tc.fq12_cyclo_sq_chain_plain(*_cpu(a), 3, TP.Q)
    assert np.array_equal(convert.to_numpy(got), np.asarray(jtower._cyclo_sq_run(jnp.asarray(a), 3)))
    with pytest.raises(ValueError):
        tc.fq12_cyclo_sq_chain(*_cpu(a), 0, TP.Q)


def _step_inputs(batch):
    return rand_field(220, (3, 2, batch)), rand_field(221, (2, 2, batch))


def _jax_step(name, r, base):
    """The JAX package's unfused step under jax.jit: one small compile costs a
    quarter of what dispatching its few dozen operations one by one does."""
    r = tuple(jnp.asarray(r[i]) for i in range(3))
    if name == "double_step":
        return jax.jit(jate._doubling_step)(r)
    return jax.jit(jate._mixed_addition_step)(r, (jnp.asarray(base[0]), jnp.asarray(base[1])))


def _plain_step(name, r, base, **dst):
    if name == "double_step":
        return tc.double_step_plain(*_cpu(r), **dst)
    return tc.madd_step_plain(*_cpu(r, base), **dst)


@pytest.mark.parametrize("name", ["double_step", "madd_step"])
def test_step_plain_equals_jax_step(name):
    r, base = _step_inputs(B)
    (jx, jy, jz), jcoeffs = _jax_step(name, r, base)
    r_new, coeffs = _plain_step(name, r, base)
    assert np.array_equal(convert.to_numpy(r_new), np.stack([np.asarray(v) for v in (jx, jy, jz)]))
    assert np.array_equal(convert.to_numpy(coeffs), np.asarray(jcoeffs))


@pytest.mark.parametrize("name", ["double_step", "madd_step"])
def test_step_plain_equals_pallas_body(name):
    """The TPU kernel's own body (lazy reduction) on reference shims, as
    tests/test_pallas_interpret.py runs it."""
    r, base = _step_inputs(shims.B)
    if name == "double_step":
        two_inv, twist_b = shims._step_consts()
        ro, co = shims._run_body(
            twp._double_step_body, [(r, (3, 2))], [(3, 2), (3, 2)],
            q=shims.Q_CONST, inv=shims.INV_CONST, two_inv=two_inv, twist_b=twist_b,
        )
    else:
        ro, co = shims._run_body(
            twp._madd_step_body, [(r, (3, 2)), (base, (2, 2))], [(3, 2), (3, 2)],
            q=shims.Q_CONST, inv=shims.INV_CONST,
        )
    r_new, coeffs = _plain_step(name, r, base)
    assert np.array_equal(convert.to_numpy(r_new), np.asarray(ro))
    assert np.array_equal(convert.to_numpy(coeffs), np.asarray(co))


@pytest.mark.parametrize("name", ["double_step", "madd_step"])
def test_step_writes_into_the_destinations_it_is_given(name):
    r, base = _step_inputs(B)
    want = _plain_step(name, r, base)
    slab = torch.full((2, 3, 2, 16, B), -1, dtype=torch.int32)
    r_out = torch.empty((3, 2, 16, B), dtype=torch.int32)
    wrapper = tc.double_step if name == "double_step" else tc.madd_step
    ins = _cpu(r) if name == "double_step" else _cpu(r, base)
    got = wrapper(*ins, r_out=r_out, coeffs_out=slab[1])
    assert got[0] is r_out and torch.equal(r_out, want[0])
    assert torch.equal(slab[1], want[1]) and bool((slab[0] == -1).all())
    with pytest.raises(ValueError):  # a destination may not be the operand
        wrapper(*ins, r_out=ins[0])
    with pytest.raises(ValueError):
        wrapper(*ins, coeffs_out=torch.empty((3, 2, 16, B + 1), dtype=torch.int32))


# ---------------------------------------------------------------------------
# the switch
# ---------------------------------------------------------------------------


def test_fusions_are_on_by_default_and_restored():
    assert (backend.pow_fixed, backend.cyclo_chain, backend.ladder) == (True, True, True)
    assert backend.curve_kernels is True and backend.miller_step is False  # off, as in the JAX package
    with backend.fusions(miller_step=True):
        assert backend.miller_step is True
    assert backend.miller_step is False
    with backend.fusions(pow_fixed=False, ladder=False):
        assert (backend.pow_fixed, backend.cyclo_chain, backend.ladder) == (False, True, False)
        with backend.fusions(cyclo_chain=False, ladder=True):
            assert (backend.pow_fixed, backend.cyclo_chain, backend.ladder) == (False, False, True)
        assert (backend.pow_fixed, backend.cyclo_chain, backend.ladder) == (False, True, False)
    assert (backend.pow_fixed, backend.cyclo_chain, backend.ladder) == (True, True, True)
    with pytest.raises(RuntimeError):
        with backend.fusions(cyclo_chain=False):
            raise RuntimeError("inside")
    assert backend.cyclo_chain is True


def test_fusions_refuse_unknown_names_and_values():
    with pytest.raises(ValueError):
        with backend.fusions(miller=False):
            pass
    with pytest.raises(TypeError):
        with backend.fusions(ladder="0"):
            pass
    assert (backend.pow_fixed, backend.cyclo_chain, backend.ladder) == (True, True, True)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_switch_chooses_a_path_not_a_result_and_a_cpu_tensor_launches_nothing(fused):
    """Each dispatch site under both settings, on CPU tensors: same limbs as
    the JAX package, and no launch counted."""
    a = rand_field(230, (B,))
    f12 = rand_field(231, (2, 3, 2, B))
    build.reset_counts()
    with backend.fusions(pow_fixed=fused, cyclo_chain=fused, ladder=fused):
        inv = tfp.inv(tfp.FQ, *_cpu(a))
        run = ttower._cyclo_sq_run(*_cpu(f12), 2)
    assert sum(build.COUNTS.values()) == 0
    assert np.array_equal(convert.to_numpy(inv), np.asarray(jfp.inv(jfp.FQ, jnp.asarray(a))))
    assert np.array_equal(convert.to_numpy(run), np.asarray(jtower._cyclo_sq_run(jnp.asarray(f12), 2)))


def test_every_kernel_has_a_count_and_a_plain_version():
    # the nineteen TPU kernels' entries and the level of signed sums, whose
    # one-output cases are mod_sub and mod_neg
    new = ("pow_fixed", "fq12_cyclo_sq_chain", "double_step", "madd_step", "fq12_mul024", "miller_step",
           "mod_signed_sum")
    assert len(build.KERNELS) == 20 and set(new) <= set(build.COUNTS)
    for name in build.KERNELS:
        module = next(m for m in (mc, tc, cc) if hasattr(m, name))
        assert callable(getattr(module, name)) and callable(getattr(module, name + "_plain"))
