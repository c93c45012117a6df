"""The port's own copies of params.py and oracle.py against the JAX package's.

bn_tpu_torch imports nothing of bn_tpu, so it carries copies of the two
pure-Python modules; these tests hold every constant, the limb packing, the
Miller schedule and the oracle's pairing to the originals.
"""

import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bn_tpu import oracle as JO
from bn_tpu import params as JP
from bn_tpu_torch import oracle as TO
from bn_tpu_torch import params as TP

from test_oracle import PAIRING_VECTOR, S1, S2

_CONSTANTS = [
    "LIMB_BITS", "NLIMBS", "LIMB_MASK", "NLIMBS_512", "Q", "R_SCALAR", "Z_BN", "ATE_LOOP_COUNT",
    "R_MONT", "B_COEFF", "G1_GEN", "FQ_NON_RESIDUE", "XI", "G2_GEN_X", "G2_GEN_Y",
    "FQ_R1", "FQ_R2", "FQ_R3", "FQ_INV", "FQ_INV64", "FR_R1", "FR_R2", "FR_R3", "FR_INV", "FR_INV64",
    "TWO_INV",
]


@pytest.mark.parametrize("name", _CONSTANTS)
def test_constant_equals_jax_package(name):
    assert getattr(TP, name) == getattr(JP, name)


def test_every_public_constant_is_covered():
    public = {n for n in dir(JP) if n.isupper()}
    assert public <= set(_CONSTANTS), public - set(_CONSTANTS)


def test_limb_packing_equals_jax_package():
    random.seed(5)
    xs = [0, 1, JP.Q - 1, JP.R_MONT - 1] + [random.randrange(JP.R_MONT) for _ in range(12)]
    assert np.array_equal(TP.ints_to_limbs(xs), JP.ints_to_limbs(xs))
    assert TP.limbs_to_ints(TP.ints_to_limbs(xs)) == xs
    for x in xs:
        assert np.array_equal(TP.int_to_limbs(x), JP.int_to_limbs(x))
        assert TP.limbs_to_int(JP.int_to_limbs(x)) == x
        assert TP.to_mont(x % TP.Q, TP.Q) == JP.to_mont(x % JP.Q, JP.Q)
        assert TP.from_mont(x % TP.Q, TP.Q) == JP.from_mont(x % JP.Q, JP.Q)


def test_miller_schedule_equals_jax_package():
    assert TP.miller_schedule() == JP.miller_schedule()
    assert len(TP.miller_schedule()) == 102
    assert TP.bits_msb_first(TP.ATE_LOOP_COUNT) == JP.bits_msb_first(JP.ATE_LOOP_COUNT)


@pytest.mark.parametrize("modulus", [TP.Q, TP.R_SCALAR], ids=["Fq", "Fr"])
def test_word32_constants_are_derived(modulus):
    inv32 = TP.FQ_INV32 if modulus == TP.Q else TP.FR_INV32
    inv64 = TP.FQ_INV64 if modulus == TP.Q else TP.FR_INV64
    inv16 = TP.FQ_INV if modulus == TP.Q else TP.FR_INV
    assert (modulus * inv32) % (1 << 32) == (1 << 32) - 1
    assert inv32 == inv64 % (1 << 32) and inv16 == inv32 % (1 << 16)
    words = TP.int_to_words(modulus)
    assert len(words) == TP.NWORDS and sum(w << (32 * i) for i, w in enumerate(words)) == modulus


def test_oracle_tables_equal_jax_package():
    assert TO.frob_coeffs() == JO.frob_coeffs()
    assert TO.twist_frob_coeffs() == JO.twist_frob_coeffs()
    assert TO.twist_b() == JO.twist_b()
    assert (TO.G1_ONE, TO.G2_ONE) == (JO.G1_ONE, JO.G2_ONE)


def test_oracle_pairing_golden_vector():
    g1, g2 = TO.g1_mul(TO.G1_ONE, S1), TO.g2_mul(TO.G2_ONE, S2)
    assert (g1, g2) == (JO.g1_mul(JO.G1_ONE, S1), JO.g2_mul(JO.G2_ONE, S2))
    got = TO.pairing(g1, g2)
    assert got == PAIRING_VECTOR
    assert got == JO.pairing(g1, g2)


def test_oracle_precompute_and_miller_equal_jax_package():
    g1, g2 = TO.g1_mul(TO.G1_ONE, 1234567), TO.g2_mul(TO.G2_ONE, 7654321)
    pa, qa = TO.g_to_affine(TO.FQ_OPS, g1), TO.g_to_affine(TO.FQ2_OPS, g2)
    coeffs = TO.precompute_g2(qa)
    assert coeffs == JO.precompute_g2(qa)
    assert TO.miller_loop(coeffs, pa) == JO.miller_loop(coeffs, pa)


def test_port_imports_without_jax():
    """bn_tpu_torch, chip_smoke.py, the entry points and the trials tool
    import where jax cannot be imported, and pull in nothing of bn_tpu."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
        "sys.path.insert(0, 'tools')\n"
        "import bn_tpu_torch, chip_smoke, __graft_entry_torch__, torch_trials\n"
        "import bn_tpu_torch.ops.build, bn_tpu_torch.ops.tower_cuda\n"
        "assert not any(m == 'bn_tpu' or m.startswith('bn_tpu.') for m in sys.modules)\n"
    )
    root = Path(__file__).resolve().parent.parent
    done = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
