"""The CUDA headers of the port, compiled for the host and held against the
plain PyTorch versions.

bn_tpu_torch/csrc/fq.cuh and tower.cuh are plain C++ on uint32_t/uint64_t, so
g++ builds them with tests/torch_csrc_host.cpp standing in for the kernels
(same offsets, a loop instead of a grid).  This checks the formulas, the limb
packing and the memory layout of all eleven kernels without a GPU; that the
kernels build and launch is what chip_smoke.py checks on the card.
Tolerance: none, the limbs are compared exactly.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from bn_tpu_torch import params as TP
from bn_tpu_torch.ops import mont_cuda as mc
from bn_tpu_torch.ops import tower_cuda as tc

from _torch_inputs import rand_field

_ROOT = Path(__file__).resolve().parent.parent
_OPS = [
    "mont_mul", "mod_add", "mod_sub", "mod_neg", "fq2_mul", "fq2_sq", "fq2_xi",
    "fq12_mul", "fq12_sq", "fq12_mul024_pre", "fq12_cyclo_sq",
]
# name -> (plain version, struct of each operand)
_SPEC = {
    "mont_mul": (mc.mont_mul_plain, [(), ()]),
    "mod_add": (mc.mod_add_plain, [(), ()]),
    "mod_sub": (mc.mod_sub_plain, [(), ()]),
    "mod_neg": (mc.mod_neg_plain, [()]),
    "fq2_mul": (mc.fq2_mul_plain, [(2,), (2,)]),
    "fq2_sq": (mc.fq2_sq_plain, [(2,)]),
    "fq2_xi": (mc.fq2_xi_plain, [(2,)]),
    "fq12_mul": (tc.fq12_mul_plain, [(2, 3, 2), (2, 3, 2)]),
    "fq12_sq": (tc.fq12_sq_plain, [(2, 3, 2)]),
    "fq12_mul024_pre": (tc.fq12_mul024_pre_plain, [(2, 3, 2), (2,), (2, 2)]),
    "fq12_cyclo_sq": (tc.fq12_cyclo_sq_plain, [(2, 3, 2)]),
}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the host shim")
    so = tmp_path_factory.mktemp("csrc_host") / "libhost.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(_ROOT / "bn_tpu_torch" / "csrc"),
         "-o", str(so), "-x", "c++", str(_ROOT / "tests" / "torch_csrc_host.cpp")],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    lib.host_run.argtypes = [ctypes.c_int, p, p, p, p, ctypes.c_longlong, ctypes.c_longlong,
                             ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32]
    lib.host_run.restype = ctypes.c_int
    return lib


def _run_host(lib, name, ins, modulus):
    B = ins[0].shape[-1]
    rows = ins[0].shape[0]
    arrs = [np.ascontiguousarray(x.astype(np.int32)) for x in ins]
    out = np.empty_like(arrs[0])
    ptrs = [a.ctypes.data for a in arrs] + [None] * (3 - len(arrs))
    words, inv32 = mc._mod_args(modulus)
    assert lib.host_run(_OPS.index(name), *ptrs, out.ctypes.data, rows, B, words, inv32) == 0
    return out


@pytest.mark.parametrize("name", _OPS)
def test_header_formula_equals_plain(host_lib, name):
    plain, structs = _SPEC[name]
    moduli = (TP.Q, TP.R_SCALAR) if structs[0] == () else (TP.Q,)
    for modulus in moduli:
        # lead 3, batch 5: neither a power of two, the ragged shape of a card run
        ins = [rand_field(100 + k, (3,) + st + (5,), modulus) for k, st in enumerate(structs)]
        got = _run_host(host_lib, name, ins, modulus)
        want = plain(*[torch.from_numpy(x.astype(np.int32)) for x in ins], modulus)
        assert np.array_equal(got, want.numpy()), (name, modulus)


def test_inv32_matches_header_convention():
    # the headers reduce with mu = t0 * inv mod 2^32, so m * inv = -1 mod 2^32
    for m, inv32 in ((TP.Q, TP.FQ_INV32), (TP.R_SCALAR, TP.FR_INV32)):
        assert (m * inv32 + 1) % (1 << 32) == 0
        assert mc._mod_args(m)[1].value == inv32
        assert sum(w << (32 * i) for i, w in enumerate(mc._mod_args(m)[0])) == m
