"""The CUDA headers of the port, compiled for the host and held against the
plain PyTorch versions.

bn_tpu_torch/csrc/fq.cuh, tower.cuh and curve.cuh are plain C++ where no
CUDA compiler is at work (the PTX carry primitives of carry.cuh are C++ twins
there, each held against Python's integers below), so g++ builds them with
tests/torch_csrc_host.cpp standing in for the kernels (same offsets, a loop
instead of a grid).  This checks the
formulas, the limb packing and the memory layout of all nineteen kernels
without a GPU, and, for fq12_mul, the lazy team of csrc/fq12_mul_team.cuh
as its kernel schedules it (team_block: blocks of 32 elements, the operands
staged, 18 members' whole products into a scratch laid out as its shared
memory, 12 combines each with one reduction; its bound analysis redone
here in Python integers, and fq_dw.cuh's product and reduction against
Python's), for fq12_mul024_pre, fq12_mul024 and fq12_sq,
the teams of csrc/fq12_mul024_team.cuh and fq12_sq_team.cuh
as their kernels schedule them (fq12_team_block: blocks of 32 elements,
13 or 12 members into a scratch laid out as its shared memory, then 6
combines), for miller_step the team of csrc/miller_step_team.cuh in both
instances (the same skeleton, team_block of csrc/team.cuh, with three or
four phases: fq12_sq's members, its combines into a state while two warps
scale the line, the sparse multiply's members on the state, its combines),
and
for the squaring chain the team of csrc/fq12_cyclo_team.cuh as
kernel_fq12_cyclo_sq_chain.cu schedules it (the element in a state laid out
as its shared memory for the whole run, each squaring 6 members into a
scratch, then 6 combines in place), and for double_step and madd_step the
teams of csrc/g2_step_team.cuh as kernels_g2_step.cu schedules them (the
step's values in a state laid out as its shared memory, 4 members a level,
the outputs stored at the levels the schedule names), for the single
cyclotomic squaring the chain's members and combines on fq12_team_block
(kernel_fq12_cyclo_sq.cu), and for pow_fixed the group of csrc/fq_group.cuh
(one Montgomery product split over T = 4 or 8 lanes, the lanes run phase by
phase between their exchanges, in lane order and reversed, from poisoned
values), and for fq2_sq the team of two warps of csrc/team.cuh (Fq2SqTeam,
its warps in order and reversed); that the kernels build and launch is what
chip_smoke.py checks on the card.
Tolerance: none, the limbs are compared exactly.
"""

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from bn_tpu_torch import params as TP
from bn_tpu_torch.ops import curve_cuda as cc
from bn_tpu_torch.ops import mont_cuda as mc
from bn_tpu_torch.ops import tower_cuda as tc

from _torch_inputs import SIGNED_SUM_CASES, SPECIALS_FOR, curve_points, rand_field, signed_sum_case

_ROOT = Path(__file__).resolve().parent.parent
_OPS = [
    "mont_mul", "mod_add", "mod_sub", "mod_neg", "fq2_mul", "fq2_sq", "fq2_xi",
    "fq12_mul", "fq12_sq", "fq12_mul024_pre", "fq12_cyclo_sq",
    "pow_fixed", "fq12_cyclo_sq_chain", "double_step", "madd_step", "fq12_mul024",
    "fq12_mul_team", "fq12_mul_team_reverse", "fq12_cyclo_team", "fq12_cyclo_team_reverse",
    "fq12_mul024_team", "fq12_mul024_team_reverse", "fq12_sq_team", "fq12_sq_team_reverse",
    "double_step_team", "double_step_team_reverse", "madd_step_team", "madd_step_team_reverse",
    "fq12_cyclo_sq_team", "fq12_cyclo_sq_team_reverse",
    "group_mul_4", "group_mul_4_reverse", "group_mul_8", "group_mul_8_reverse",
    "group_pow_4", "group_pow_4_reverse", "group_pow_8", "group_pow_8_reverse",
    "fq12_mul024_line_team", "fq12_mul024_line_team_reverse", "fq2_sq_team", "fq2_sq_team_reverse",
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
    "fq12_mul024": (tc.fq12_mul024_plain, [(2, 3, 2), (3, 2)]),
    # kernel_fq12_mul.cu's team, members in order and last to first
    "fq12_mul_team": (tc.fq12_mul_plain, [(2, 3, 2), (2, 3, 2)]),
    "fq12_mul_team_reverse": (tc.fq12_mul_plain, [(2, 3, 2), (2, 3, 2)]),
}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the host shim")
    so = tmp_path_factory.mktemp("csrc_host") / "libhost.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(_ROOT / "bn_tpu_torch" / "csrc"),
         "-o", str(so), "-x", "c++", str(_ROOT / "tests" / "torch_csrc_host.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.host_run.argtypes = [ctypes.c_int, p, p, p, p, p, ctypes.c_longlong, ctypes.c_longlong,
                             ctypes.c_int, u32p, u32p, ctypes.c_uint32]
    lib.host_run.restype = ctypes.c_int
    pp = ctypes.POINTER(ctypes.c_void_p)
    lib.host_curve.argtypes = [ctypes.c_int, ctypes.c_int, pp, pp, ctypes.c_longlong, ctypes.c_longlong,
                               u32p, ctypes.c_uint32]
    lib.host_curve.restype = ctypes.c_int
    lib.host_curve_team.argtypes = [ctypes.c_int] * 3 + [pp, pp, ctypes.c_longlong, ctypes.c_longlong, u32p, ctypes.c_uint32]
    lib.host_curve_team.restype = ctypes.c_int
    lib.host_miller_step.argtypes = [ctypes.c_int] + [p] * 5 + [ctypes.c_longlong, ctypes.c_longlong, u32p, ctypes.c_uint32]
    lib.host_miller_step.restype = ctypes.c_int
    lib.host_miller_team.argtypes = [ctypes.c_int] * 2 + [p] * 5 + [ctypes.c_longlong, ctypes.c_longlong, u32p, ctypes.c_uint32]
    lib.host_miller_team.restype = ctypes.c_int
    lib.host_carry.argtypes = [ctypes.c_int, ctypes.c_longlong] + [u32p] * 6
    lib.host_carry.restype = ctypes.c_int
    lib.host_signed_sum.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int8)] + [ctypes.c_int] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, u32p, ctypes.c_uint32]
    lib.host_signed_sum.restype = ctypes.c_int
    lib.host_fq12_mul_plan.argtypes = [ctypes.POINTER(ctypes.c_int8)] * 2 + [u32p]
    lib.host_fq12_mul_plan.restype = ctypes.c_int
    lib.host_dw.argtypes = [ctypes.c_int, ctypes.c_longlong, u32p, u32p, u32p]
    lib.host_dw.restype = ctypes.c_int
    return lib


def _run_host(lib, name, ins, modulus, n=0, extra=(), two_outputs=False):
    """Run operation `name` of the shim; `n` and `extra` (32-bit words) are
    the kernel's own arguments.  Returns the output, or both of them."""
    B = ins[0].shape[-1]
    rows = ins[0].shape[0]
    arrs = [np.ascontiguousarray(x.astype(np.int32)) for x in ins]
    out, out2 = np.empty_like(arrs[0]), np.empty_like(arrs[0])
    ptrs = [a.ctypes.data for a in arrs] + [None] * (3 - len(arrs))
    words, inv32 = mc._mod_args(modulus)
    extra_c = (ctypes.c_uint32 * max(len(extra), 1))(*extra)
    rc = lib.host_run(_OPS.index(name), *ptrs, out.ctypes.data, out2.ctypes.data, rows, B, n, extra_c, words, inv32)
    assert rc == 0
    return (out, out2) if two_outputs else out


def _tensors(ins):
    return [torch.from_numpy(x.astype(np.int32)) for x in ins]


@pytest.mark.parametrize("name", list(_SPEC))
def test_header_formula_equals_plain(host_lib, name):
    plain, structs = _SPEC[name]
    moduli = (TP.Q, TP.R_SCALAR) if structs[0] == () else (TP.Q,)
    for modulus in moduli:
        # lead 3, batch 5: neither a power of two, the ragged shape of a card run
        ins = [rand_field(100 + k, (3,) + st + (5,), modulus) for k, st in enumerate(structs)]
        got = _run_host(host_lib, name, ins, modulus)
        want = plain(*_tensors(ins), modulus)
        assert np.array_equal(got, want.numpy()), (name, modulus)


@pytest.mark.parametrize("modulus", [TP.Q, TP.R_SCALAR], ids=["Fq", "Fr"])
@pytest.mark.parametrize("exponent", ["m-2", 0xA0B7F03], ids=["fermat", "interior-zero-digit"])
def test_header_pow_fixed_equals_plain_and_python_pow(host_lib, modulus, exponent):
    """fq_pow_fixed with its table in a plain array: the Fermat exponent and a
    short one with a zero digit inside; lanes 0, 1, m-1 and the Montgomery one
    lead each row (rand_field)."""
    e = modulus - 2 if exponent == "m-2" else exponent
    a = rand_field(300, (2, 5), modulus)
    extra = TP.int_to_words(e) + TP.int_to_words(TP.R_MONT % modulus)
    got = _run_host(host_lib, "pow_fixed", [a], modulus, n=len(mc.digit_schedule(e)), extra=extra)
    want = mc.pow_fixed_plain(*_tensors([a]), e, modulus)
    assert np.array_equal(got, want.numpy())
    # Montgomery domain: the stored value v stands for v/R, the result for (v/R)^e
    vals = [TP.from_mont(v, modulus) for v in TP.limbs_to_ints(a[0])]
    assert vals[:3] == [0, TP.from_mont(1, modulus), TP.from_mont(modulus - 1, modulus)]
    assert TP.limbs_to_ints(got[0]) == [TP.to_mont(pow(v, e, modulus), modulus) for v in vals]
    assert TP.limbs_to_ints(got[0])[0] == 0  # 0 -> 0, the contract of fp.inv


@pytest.mark.parametrize("n", [1, 3])
def test_header_cyclo_sq_chain_equals_plain(host_lib, n):
    a = rand_field(310, (3, 2, 3, 2, 5))
    got = _run_host(host_lib, "fq12_cyclo_sq_chain", [a], TP.Q, n=n)
    assert np.array_equal(got, tc.fq12_cyclo_sq_chain_plain(*_tensors([a]), n, TP.Q).numpy())


def test_header_double_step_equals_plain(host_lib):
    """tower.cuh's one-thread formula, which multiplies by 1/2."""
    r = rand_field(320, (3, 3, 2, 5))
    (twist_b,) = tc._step_const_args()
    two_inv = TP.int_to_words(tc._step_const_monts()[0])
    got = _run_host(host_lib, "double_step", [r], TP.Q, extra=list(two_inv) + list(twist_b), two_outputs=True)
    want = tc.double_step_plain(*_tensors([r]))
    assert np.array_equal(got[0], want[0].numpy()) and np.array_equal(got[1], want[1].numpy())


def test_header_madd_step_equals_plain(host_lib):
    r, base = rand_field(330, (3, 3, 2, 5)), rand_field(331, (3, 2, 2, 5))
    got = _run_host(host_lib, "madd_step", [r, base], TP.Q, two_outputs=True)
    want = tc.madd_step_plain(*_tensors([r, base]))
    assert np.array_equal(got[0], want[0].numpy()) and np.array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("square", [True, False], ids=["doubling-step", "addition-step"])
def test_header_miller_step_equals_plain(host_lib, square):
    """fq12_miller_step at lead 3, batch 5; lanes 0-3 of every operand hold
    0, 1, q-1 and the Montgomery one (rand_field)."""
    f, coeff = rand_field(340, (3, 2, 3, 2, 5)), rand_field(341, (3, 3, 2, 5))
    px, py = rand_field(342, (3, 5)), rand_field(343, (3, 5))
    arrs = [np.ascontiguousarray(x.astype(np.int32)) for x in (f, coeff, px, py)]
    out = np.empty_like(arrs[0])
    words, inv32 = mc._mod_args(TP.Q)
    assert host_lib.host_miller_step(int(square), *(a.ctypes.data for a in arrs), out.ctypes.data, 3, 5, words, inv32) == 0
    assert np.array_equal(out, tc.miller_step_plain(*_tensors([f, coeff, px, py]), square).numpy())


def _with_edge_tail(x, modulus=TP.Q):
    """x with every coefficient of the flat batch's last four elements set to
    0, 1, m-1 and the Montgomery one: the lanes of a ragged last block."""
    x = x.copy()
    edges = TP.ints_to_limbs(SPECIALS_FOR(modulus)).astype(x.dtype)  # (16, 4)
    x[-1, ..., -4:] = edges
    return x


@pytest.mark.parametrize("order", ["fq12_mul_team", "fq12_mul_team_reverse"], ids=["in-order", "reverse"])
@pytest.mark.parametrize("batch", [37, 64])
def test_header_fq12_mul_team_equals_plain(host_lib, order, batch):
    """The team at lead 3: with B = 37 the blocks of 32 straddle the row
    boundaries and the last block is ragged (111 = 3 * 32 + 15); with B = 64
    a block straddles none.  Edge values lead the first row (rand_field) and
    end the last."""
    a = _with_edge_tail(rand_field(350, (3, 2, 3, 2, batch)))
    b = _with_edge_tail(rand_field(351, (3, 2, 3, 2, batch)))
    got = _run_host(host_lib, order, [a, b], TP.Q)
    assert np.array_equal(got, tc.fq12_mul_plain(*_tensors([a, b]), TP.Q).numpy())


# ---- kernel_fq12_mul.cu's team: lazy reduction (csrc/fq12_mul_team.cuh) ----

_XI = ((9, -1), (1, 9))  # xi = 9 + u on (x0, x1): (9 x0 - x1, x0 + 9 x1)


def _lazy_weights():
    """The 12 output base-field coefficients of the Fq12 product, each as
    weights over the team's 36 scratch entries (member w's X0 at 2w, X1 at
    2w + 1), derived here on formal member products along the oracle's
    Karatsuba tree (bn_tpu_torch/oracle.py, fq6_mul and fq12_mul): an Fq2
    value is {(w, p): n}, the sum of n xi^p P_w, and P_w = (X0 - q^2, X1)."""
    def lin(*terms):
        out = {}
        for sign, x in terms:
            for key, n in x.items():
                out[key] = out.get(key, 0) + sign * n
        return {key: n for key, n in out.items() if n}

    def xi(x):
        return {(w, p + 1): n for (w, p), n in x.items()}

    def fq6(k):  # Fq6 product k from its members 6k .. 6k + 5
        aa, bb, cc, t12, t01, t02 = ({(6 * k + j, 0): 1} for j in range(6))
        return [lin((1, xi(lin((1, t12), (-1, bb), (-1, cc)))), (1, aa)),
                lin((1, t01), (-1, aa), (-1, bb), (1, xi(cc))),
                lin((1, t02), (-1, aa), (1, bb), (-1, cc))]

    A, B, C = fq6(0), fq6(1), fq6(2)
    out = [lin((1, A[0]), (1, xi(B[2]))), lin((1, A[1]), (1, B[0])), lin((1, A[2]), (1, B[1]))]
    out += [lin((1, C[s]), (-1, A[s]), (-1, B[s])) for s in range(3)]
    weights = []
    for c in range(6):
        for comp in range(2):
            wt = [0] * 36
            for (w, p), n in out[c].items():
                mat = ((1, 0), (0, 1))
                for _ in range(p):
                    mat = tuple(tuple(sum(_XI[i][k] * mat[k][j] for k in range(2)) for j in range(2)) for i in range(2))
                for s in range(2):
                    wt[2 * w + s] += n * mat[comp][s]
            weights.append(wt)
    return weights


def _lazy_plan(lib):
    """The header's plan as weights, and its constants (K, BN_DW_SUM_BITS,
    BN_DW_REDC_BITS, BN_DW_EST_LOW, BN_DW_EST_SHIFT, est)."""
    terms, counts = (ctypes.c_int8 * (12 * 24))(), (ctypes.c_int8 * 12)()
    consts = (ctypes.c_uint32 * 7)()
    assert lib.host_fq12_mul_plan(terms, counts, consts) == 0
    nine = consts[6]
    weights = []
    for i in range(12):
        wt = [0] * 36
        for t in range(counts[i]):
            code = terms[24 * i + t]
            wt[(abs(code) & (nine - 1)) - 1] = (9 if abs(code) & nine else 1) * (1 if code > 0 else -1)
        weights.append(wt)
    return weights, list(consts)[:6]


_ENTRY_MIN = (TP.Q ** 2 - (TP.Q - 1) ** 2, 0)  # X0, X1: each scratch entry's range
_ENTRY_MAX = (TP.Q ** 2 + (TP.Q - 1) ** 2, 2 * (TP.Q - 1) ** 2)


def test_header_fq12_mul_lazy_bounds(host_lib):
    """The bound analysis, redone with Python integers: the header's
    combine table equals this file's own derivation, and each combine's worst
    case over the entries' ranges, plus K q^2, is non-negative and below
    2^BN_DW_SUM_BITS, its REDC below 2^BN_DW_REDC_BITS; dw_canonical's
    quotient estimate is floor(r / q) or one less for every r in that range
    (checked on each interval of t = r >> BN_DW_EST_LOW where the estimate
    is constant)."""
    q, R = TP.Q, 1 << 256
    weights, (K, sum_bits, redc_bits, est_low, est_shift, est) = _lazy_plan(host_lib)
    assert weights == _lazy_weights()
    assert sum(w != 0 for wt in weights for w in wt) == 168
    for i, wt in enumerate(weights):
        lo = K * q * q + sum(w * (_ENTRY_MIN[e % 2] if w > 0 else _ENTRY_MAX[e % 2]) for e, w in enumerate(wt))
        hi = K * q * q + sum(w * (_ENTRY_MAX[e % 2] if w > 0 else _ENTRY_MIN[e % 2]) for e, w in enumerate(wt))
        assert 0 <= lo and hi < 1 << sum_bits, i
        assert (hi + (R - 1) * q) >> 256 < 1 << redc_bits, i
    assert max(_ENTRY_MAX) < 1 << 512 and (2 * q - 2) ** 2 < 1 << 512 and 2 * q < R
    shift = 32 + est_shift
    assert est == (1 << shift) // ((q >> est_low) + 1) < 1 << 32
    t_end = 1 << (redc_bits - est_low)
    k, t = 0, 0
    while t < t_end:  # the estimate is k for t in [t, t_next)
        t_next = min(t_end, -(-((k + 1) << shift) // est))
        r_lo, r_hi = t << est_low, (t_next << est_low) - 1
        assert r_lo // q >= k and r_hi // q <= k + 1, (k, t)
        k, t = k + 1, t_next


def _lazy_entries(a, b):
    """The members' 36 scratch values for one element, a and b its 12 raw
    coefficients each (base-field index 6i + 2s + c of c{i}.c{s}.{c})."""
    q = TP.Q

    def add2(x, y):
        return ((x[0] + y[0]) % q, (x[1] + y[1]) % q)

    def operands(v):
        c0 = [(v[2 * s], v[2 * s + 1]) for s in range(3)]
        c1 = [(v[6 + 2 * s], v[7 + 2 * s]) for s in range(3)]
        return [[x[0], x[1], x[2], add2(x[1], x[2]), add2(x[0], x[1]), add2(x[0], x[2])]
                for x in (c0, c1, [add2(c0[s], c1[s]) for s in range(3)])]

    xa, xb = operands(a), operands(b)
    out = []
    for w in range(18):
        x, y = xa[w // 6][w % 6], xb[w // 6][w % 6]
        p0, p1 = x[0] * y[0], x[1] * y[1]
        out += [p0 - p1 + q * q, (x[0] + x[1]) * (y[0] + y[1]) - p0 - p1]
    return out


def _lazy_extremal_lanes(weights, K, n=37, draws=1500):
    """n elements (pairs of 12 raw coefficients) for the team: every
    coefficient q - 1, then a zero operand against q - 1, then among `draws`
    elements whose coefficients are drawn from 0, 1 and q - 1 those that give
    each combine's sum its largest and its least value, then random field
    elements."""
    q = TP.Q
    rng = np.random.default_rng(360)
    edge = (0, 1, q - 1)
    cands = [([edge[i] for i in rng.integers(0, 3, 12)], [edge[i] for i in rng.integers(0, 3, 12)])
             for _ in range(draws)]
    sums = []
    for a, b in cands:
        x = _lazy_entries(a, b)
        sums.append([K * q * q + sum(w * v for w, v in zip(wt, x) if w) for wt in weights])
    lanes = [([q - 1] * 12, [q - 1] * 12), ([0] * 12, [q - 1] * 12)]
    for i in range(12):
        col = [s[i] for s in sums]
        lanes += [cands[col.index(max(col))], cands[col.index(min(col))]]
    while len(lanes) < n:
        lanes.append(([int.from_bytes(rng.bytes(40), "big") % q for _ in range(12)],
                      [int.from_bytes(rng.bytes(40), "big") % q for _ in range(12)]))
    return lanes[:n]


@pytest.mark.parametrize("order", ["fq12_mul_team", "fq12_mul_team_reverse"], ids=["in-order", "reverse"])
def test_header_fq12_mul_team_extremal_operands(host_lib, order):
    """The lazy team, members in order and reversed, its scratch poisoned
    before every block (team_run), on a ragged batch of 37 elements whose
    operands reach the combines' bounds: every coefficient q - 1, and the
    0 / 1 / q - 1 mixes that maximise and minimise each combine's signed
    sum; bit for bit equal to the plain version and to the oracle."""
    from bn_tpu_torch import oracle as O

    weights, consts = _lazy_plan(host_lib)
    lanes = _lazy_extremal_lanes(weights, consts[0])

    def limbs(side):  # (1, 2, 3, 2, 16, 37): coefficient k of lane l is lanes[l][side][k]
        x = TP.ints_to_limbs([lanes[l][side][k] for k in range(12) for l in range(37)])  # (16, 12 * 37)
        return np.ascontiguousarray(np.moveaxis(x.reshape(16, 12, 37), 0, 1).reshape(1, 2, 3, 2, 16, 37))

    a, b = limbs(0), limbs(1)
    got = _run_host(host_lib, order, [a, b], TP.Q)
    assert np.array_equal(got, tc.fq12_mul_plain(*_tensors([a, b]), TP.Q).numpy())

    def oracle_value(v):
        m = [TP.from_mont(x, TP.Q) for x in v]
        return tuple(tuple((m[6 * i + 2 * s], m[6 * i + 2 * s + 1]) for s in range(3)) for i in range(2))

    flat = got.reshape(12, 16, 37)
    for lane, (x, y) in enumerate(lanes):
        want = O.fq12_mul(oracle_value(x), oracle_value(y))
        want = [TP.to_mont(want[i][s][c], TP.Q) for i in range(2) for s in range(3) for c in range(2)]
        assert TP.limbs_to_ints(flat[:, :, lane].T) == want, lane


def test_header_dw_product_and_reduction_equal_python(host_lib):
    """fq_dw.cuh's whole product on edge words and random values, and its
    REDC with dw_canonical on sums from 0 to the largest its contract takes
    (t + (2^256 - 1) q < 2^515, so that the REDC is below 2^259), at q^2
    multiples, and
    at t = (j q + d) 2^256, whose reduction sits at each quotient's edge
    (j < 37, d = -1, 0, 1): against Python's a b and t 2^-256 mod q."""
    q, R = TP.Q, 1 << 256
    rng = np.random.default_rng(370)

    def big(bits):
        return int.from_bytes(rng.bytes(bits // 8 + 1), "big") % (1 << bits)

    def words(v, n):
        return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)]

    def u32(vals):
        return (ctypes.c_uint32 * max(len(vals), 1))(*vals)

    ops = [0, 1, (1 << 32) - 1, R - 1, q - 1, 2 * q - 2, sum(0xFFFFFFFF << (64 * i) for i in range(4))]
    pairs = [(x, y) for x in ops for y in ops] + [(big(256), big(256)) for _ in range(30)]
    out = (ctypes.c_uint32 * (16 * len(pairs)))()
    assert host_lib.host_dw(0, len(pairs), u32([w for x, _ in pairs for w in words(x, 8)]),
                            u32([w for _, y in pairs for w in words(y, 8)]), out) == 0
    assert [sum(out[16 * i + j] << (32 * j) for j in range(16)) for i in range(len(pairs))] == [x * y for x, y in pairs]

    top = (1 << 515) - (R - 1) * q - 1
    sums = [0, 1, top, top - 1, top - R, 86 * q * q, 86 * q * q - 1, q * R, q * R - 1]
    sums += [(j * q + d) * R for j in range(37) for d in (-1, 0, 1) if j * q + d >= 0]
    sums += [big(515) % top for _ in range(40)]
    out = (ctypes.c_uint32 * (8 * len(sums)))()
    assert host_lib.host_dw(1, len(sums), u32([w for t in sums for w in words(t, 17)]), u32([]), out) == 0
    r_inv = pow(R, -1, q)
    got = [sum(out[8 * i + j] << (32 * j) for j in range(8)) for i in range(len(sums))]
    assert got == [t * r_inv % q for t in sums]


@pytest.mark.parametrize("order", ["in-order", "reverse"])
@pytest.mark.parametrize("batch", [5, 37, 64])
@pytest.mark.parametrize("kernel", ["fq12_mul024", "fq12_sq", "fq12_mul024_line", "miller_step_square",
                                    "miller_step_no_square"])
def test_header_mul024_and_sq_teams_equal_plain(host_lib, kernel, batch, order):
    """The teams of fq12_mul024_pre (the id fq12_mul024; 13 members),
    fq12_sq (12), fq12_mul024 (fq12_mul024_line: fq12_mul024_pre's members
    reading the precompute's unscaled (3, 2) struct) and miller_step (both
    instances: fq12_sq's members, its combines into the state while two warps
    scale the line, the sparse multiply's members on the state, its
    combines; csrc/miller_step_team.cuh) at lead 3: with B = 5 one ragged
    block holds all 15 elements; with B = 37 the blocks of 32 straddle the
    row boundaries and the last is ragged; with B = 64 a block straddles
    none.  Members and combines in order and last to first, the shared
    memory poisoned every block and the scratch again before the sparse
    multiply's members; edge values at both ends of the flat batch.  The
    line's entries are drawn apart, so a swap of the slots x2 and x4 would
    show."""
    f = _with_edge_tail(rand_field(370, (3, 2, 3, 2, batch)))
    reverse = order == "reverse"
    if kernel == "fq12_sq":
        got = _run_host(host_lib, "fq12_sq_team" + ("_reverse" if reverse else ""), [f], TP.Q)
        assert np.array_equal(got, tc.fq12_sq_plain(*_tensors([f]), TP.Q).numpy())
        return
    if kernel.startswith("miller_step"):
        square = kernel == "miller_step_square"
        coeff = _with_edge_tail(rand_field(373, (3, 3, 2, batch)))
        px, py = (_with_edge_tail(rand_field(seed, (3, batch))) for seed in (374, 375))
        arrs = [np.ascontiguousarray(x.astype(np.int32)) for x in (f, coeff, px, py)]
        got = np.empty_like(arrs[0])
        words, inv32 = mc._mod_args(TP.Q)
        assert host_lib.host_miller_team(int(square), int(reverse), *(a.ctypes.data for a in arrs), got.ctypes.data,
                                         3, batch, words, inv32) == 0
        assert np.array_equal(got, tc.miller_step_plain(*_tensors([f, coeff, px, py]), square).numpy())
        swapped = tc.miller_step_plain(*_tensors([f, coeff, py, px]), square).numpy()
        assert not np.array_equal(swapped, got)
        return
    if kernel == "fq12_mul024_line":
        coeff = _with_edge_tail(rand_field(373, (3, 3, 2, batch)))
        got = _run_host(host_lib, "fq12_mul024_line_team" + ("_reverse" if reverse else ""), [f, coeff], TP.Q)
        want = tc.fq12_mul024_plain(*_tensors([f, coeff]), TP.Q).numpy()
        assert np.array_equal(got, want)
        swapped = tc.fq12_mul024_plain(*_tensors([f, coeff[:, [0, 2, 1]]]), TP.Q).numpy()
        assert not np.array_equal(swapped, want)
        return
    ell0 = _with_edge_tail(rand_field(371, (3, 2, batch)))
    scaled = _with_edge_tail(rand_field(372, (3, 2, 2, batch)))
    got = _run_host(host_lib, "fq12_mul024_team" + ("_reverse" if reverse else ""), [f, ell0, scaled], TP.Q)
    want = tc.fq12_mul024_pre_plain(*_tensors([f, ell0, scaled]), TP.Q).numpy()
    assert np.array_equal(got, want)
    swapped = tc.fq12_mul024_pre_plain(*_tensors([f, ell0, scaled[:, ::-1]]), TP.Q).numpy()
    assert not np.array_equal(swapped, want)


@functools.lru_cache(maxsize=None)
def _cyclo_chain_case(n, batch):
    """The chain's operand at lead 3 and batch `batch`, edge values at both
    ends of the flat batch, and the plain version's result after n squarings."""
    a = _with_edge_tail(rand_field(360, (3, 2, 3, 2, batch)))
    return a, tc.fq12_cyclo_sq_chain_plain(*_tensors([a]), n, TP.Q).numpy()


@pytest.mark.parametrize("order", ["fq12_cyclo_team", "fq12_cyclo_team_reverse"], ids=["in-order", "reverse"])
@pytest.mark.parametrize("batch", [5, 37, 64])
@pytest.mark.parametrize("n", [1, 2, 5])
def test_header_cyclo_chain_team_equals_plain(host_lib, n, batch, order):
    """The chain's team at lead 3: with B = 5 one ragged block holds all 15
    elements; with B = 37 the blocks of 32 straddle the row boundaries and the
    last is ragged (111 = 3 * 32 + 15); with B = 64 a block straddles none.
    Members and combines in order and last to first, the scratch poisoned
    before every squaring."""
    a, want = _cyclo_chain_case(n, batch)
    got = _run_host(host_lib, order, [a], TP.Q, n=n)
    assert np.array_equal(got, want)


@functools.lru_cache(maxsize=None)
def _step_case(kernel, batch):
    """A step's operands at lead 3 and batch `batch` (the running point, and
    for madd_step the affine base), edge values at both ends of the flat
    batch, and the plain version's two outputs."""
    ins = [_with_edge_tail(rand_field(380, (3, 3, 2, batch)))]
    if kernel == "madd_step":
        ins.append(_with_edge_tail(rand_field(381, (3, 2, 2, batch))))
        want = tc.madd_step_plain(*_tensors(ins))
    else:
        want = tc.double_step_plain(*_tensors(ins))
    return ins, tuple(w.numpy() for w in want)


@pytest.mark.parametrize("order", ["in-order", "reverse"])
@pytest.mark.parametrize("batch", [5, 37, 64])
@pytest.mark.parametrize("kernel", ["double_step", "madd_step"])
def test_header_step_teams_equal_plain(host_lib, kernel, batch, order):
    """The teams of double_step (3 levels) and madd_step (4 levels) at lead 3:
    with B = 5 one ragged block holds all 15 elements; with B = 37 the blocks
    of 32 straddle the row boundaries and the last is ragged; with B = 64 a
    block straddles none.  Members and stores in order and last to first (a
    level's stores before its members), the state poisoned every block; edge
    values at both ends of the flat batch.  Both outputs, the new point and
    the line's coefficients, limb for limb."""
    ins, want = _step_case(kernel, batch)
    name = kernel + "_team" + ("_reverse" if order == "reverse" else "")
    extra = list(tc._step_const_args()[0]) if kernel == "double_step" else ()
    got = _run_host(host_lib, name, ins, TP.Q, extra=extra, two_outputs=True)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@functools.lru_cache(maxsize=None)
def _cyclo_sq_case(batch):
    """The single squaring's operand at lead 3 and batch `batch`, edge values
    at both ends of the flat batch, and the plain version's result."""
    a = _with_edge_tail(rand_field(365, (3, 2, 3, 2, batch)))
    return a, tc.fq12_cyclo_sq_plain(*_tensors([a]), TP.Q).numpy()


@pytest.mark.parametrize("order", ["in-order", "reverse"])
@pytest.mark.parametrize("batch", [5, 37, 64])
def test_header_cyclo_sq_team_equals_plain(host_lib, batch, order):
    """kernel_fq12_cyclo_sq.cu's team at lead 3: the chain's 6 members and
    combines on fq12_team_block, the members reading their pair and the
    combines their old slot from the operand itself.  B = 5: one ragged block
    holds all 15 elements; B = 37: blocks straddle the rows; B = 64: none
    does.  Members and combines in order and last to first, the scratch
    poisoned every block; equal to the plain version and to tower.cuh's
    one-thread formula."""
    a, want = _cyclo_sq_case(batch)
    name = "fq12_cyclo_sq_team" + ("_reverse" if order == "reverse" else "")
    got = _run_host(host_lib, name, [a], TP.Q)
    assert np.array_equal(got, want)
    assert np.array_equal(got, _run_host(host_lib, "fq12_cyclo_sq", [a], TP.Q))


@pytest.mark.parametrize("order", ["in-order", "reverse"])
@pytest.mark.parametrize("batch", [5, 37, 64])
def test_header_fq2_sq_team_equals_plain(host_lib, batch, order):
    """kernels_fq.cu's fq2_sq team (Fq2SqTeam of team.cuh on team_block) at
    lead 3: B = 5, one ragged block holds all 15 elements; B = 37, blocks
    straddle the rows and the last is ragged; B = 64, none does.  Its two
    warps in order and last to first, from poisoned shared state; equal to
    the plain version, to tower.cuh's fq2_sq (one thread an element) and to
    the Karatsuba product a a; edge values at both ends of the flat batch."""
    a = _with_edge_tail(rand_field(368, (3, 2, batch)))
    got = _run_host(host_lib, "fq2_sq_team" + ("_reverse" if order == "reverse" else ""), [a], TP.Q)
    assert np.array_equal(got, mc.fq2_sq_plain(*_tensors([a]), TP.Q).numpy())
    assert np.array_equal(got, _run_host(host_lib, "fq2_sq", [a], TP.Q))
    assert np.array_equal(got, _run_host(host_lib, "fq2_mul", [a, a], TP.Q))


ZERO_DIGIT_EXPONENT = 0xA0B7F03  # chip_smoke.py's: a short exponent with a zero digit inside
FOUR_DIGIT_EXPONENT = 0xB0F1


def _limbs(vals):
    """Values as a (1, 16, n) limb array, one element a lane."""
    return TP.ints_to_limbs(vals).astype(np.int64)[None]


def _cios_t(a, b, modulus):
    """What CIOS holds before its final subtraction, (ab + mu m) / R with
    mu = -ab / m mod R: in [0, 2m)."""
    mu = (-a * b * pow(modulus, -1, TP.R_MONT)) % TP.R_MONT
    return (a * b + mu * modulus) // TP.R_MONT


@functools.lru_cache(maxsize=None)
def _group_mul_pairs(modulus):
    """Operand pairs for the group product, as two (1, 16, n) limb arrays:
    (1) every pair of the edge values 0, 1, 2, R mod m, m-1, m-2, values
    whose low k words are 0xffffffff (2^32k - 1, and m's top words less one
    above them) and values with one 0xffffffff word elsewhere; (2) for
    results r with runs of 0xffffffff or zero words, and each of three b,
    a = r R / b, so that t or t - m carries or borrows through whole lanes;
    (3) the 64 pairs of a seeded search with the largest t, where the final
    subtraction is taken and t is close to 2m, and 16 with t just below m.
    t < 2m < 2^255, so no pair takes t to 2^256."""
    m, R = modulus, TP.R_MONT
    edges = [0, 1, 2, R % m, m - 1, m - 2]
    edges += [(1 << (32 * k)) - 1 for k in range(1, 8)]
    edges += [((m >> (32 * k)) << (32 * k)) - 1 for k in range(1, 8)]
    edges += [0xFFFFFFFF << (32 * j) for j in range(1, 7)]
    pairs = [(x, y) for x in edges for y in edges]
    results = [(1 << (32 * k)) - 1 for k in range(1, 8)] + [(m >> (32 * k)) << (32 * k) for k in range(1, 8)]
    results += [m - (1 << (32 * k)) for k in range(1, 8)] + [1 << (32 * k) for k in range(1, 8)]
    for r in results:
        for b in (1, m - 1, 0xFFFFFFFF << 96):
            pairs.append((r * R * pow(b, -1, m) % m, b))
    rng = np.random.default_rng(395)
    found = []
    for _ in range(20000):
        x, y = (int.from_bytes(rng.bytes(40), "big") % m for _ in range(2))
        found.append((_cios_t(x, y, m), x, y))
    found.sort()
    below_m = [f for f in found if f[0] < m][-16:]
    pairs += [(x, y) for _, x, y in found[-64:] + below_m]
    assert max(_cios_t(x, y, m) for x, y in pairs) >= m
    a, b = zip(*pairs)
    return _limbs(list(a)), _limbs(list(b))


@pytest.mark.parametrize("order", ["in-order", "reverse"])
@pytest.mark.parametrize("lanes", [4, 8])
@pytest.mark.parametrize("modulus", [TP.Q, TP.R_SCALAR], ids=["Fq", "Fr"])
def test_header_group_mul_equals_one_thread_product_and_python(host_lib, modulus, lanes, order):
    """fq_group_mul on a group of 4 or 8 lanes, lanes run in order and last
    to first from poisoned values, against fq_mont_mul_inline and against
    Python's integers on the pairs of _group_mul_pairs."""
    a, b = _group_mul_pairs(modulus)
    name = f"group_mul_{lanes}" + ("_reverse" if order == "reverse" else "")
    got = _run_host(host_lib, name, [a, b], modulus)
    assert np.array_equal(got, _run_host(host_lib, "mont_mul", [a, b], modulus))
    r_inv = pow(TP.R_MONT, -1, modulus)
    want = [x * y * r_inv % modulus for x, y in zip(TP.limbs_to_ints(a[0]), TP.limbs_to_ints(b[0]))]
    assert TP.limbs_to_ints(got[0]) == want


def _sum_edge_pairs(modulus):
    """Operand pairs for the modular sums: a + b = m - 1, m and m + 1, a = b
    and a = b - 1 for edge values a (0, 1, 2, m - 1, m - 2, halves of m, R mod
    m, values whose low k words are all ones), and every pair of the
    all-ones values, so that carries and borrows run through whole words."""
    m = modulus
    ones = [(1 << (32 * k)) - 1 for k in range(1, 8)]
    pairs = [(x, y) for x in ones for y in ones]
    for x in [0, 1, 2, m - 1, m - 2, (m - 1) // 2, (m + 1) // 2, TP.R_MONT % m] + ones:
        pairs += [(x, s - x) for s in (m - 1, m, m + 1) if 0 <= s - x < m]
        pairs += [(x, x)] + ([(x, x + 1)] if x + 1 < m else [])
    return pairs


# carry.cuh's primitives in the order of host_carry's op numbers:
# name -> (takes an addend c, reads the flag, writes the flag, result before wrapping)
_W32 = 1 << 32
CARRY_OPS = {
    "add_cc": (False, False, True, lambda a, b, c, f: a + b),
    "addc_cc": (False, True, True, lambda a, b, c, f: a + b + f),
    "addc": (False, True, False, lambda a, b, c, f: a + b + f),
    "sub_cc": (False, False, True, lambda a, b, c, f: a - b),
    "subc_cc": (False, True, True, lambda a, b, c, f: a - b - f),
    "subc": (False, True, False, lambda a, b, c, f: a - b - f),
    "mad_lo_cc": (True, False, True, lambda a, b, c, f: a * b % _W32 + c),
    "madc_lo_cc": (True, True, True, lambda a, b, c, f: a * b % _W32 + c + f),
    "mad_hi_cc": (True, False, True, lambda a, b, c, f: a * b // _W32 + c),
    "madc_hi_cc": (True, True, True, lambda a, b, c, f: a * b // _W32 + c + f),
    "madc_hi": (True, True, False, lambda a, b, c, f: a * b // _W32 + c + f),
}
EDGE_WORDS = (0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF)


@pytest.mark.parametrize("name", list(CARRY_OPS))
def test_carry_primitive_twin_equals_python(host_lib, name):
    """Each primitive's C++ twin on every pair (for the multiply-adds every
    triple) of the edge words, the flag in at 0 and 1, against Python's
    integers: the result mod 2^32, and the flag after it (the carry or the
    borrow out for a .cc primitive, the flag in, untouched, for the others).
    A primitive that does not read the flag gives the same for both."""
    takes_c, reads, writes, value = CARRY_OPS[name]
    cases = [(a, b, c, f) for a in EDGE_WORDS for b in EDGE_WORDS
             for c in (EDGE_WORDS if takes_c else (0,)) for f in (0, 1)]
    a, b, c, f = (np.array(col, dtype=np.uint32) for col in zip(*cases))
    d, cout = np.empty_like(a), np.empty_like(a)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    args = [x.ctypes.data_as(u32p) for x in (a, b, c, f, d, cout)]
    assert host_lib.host_carry(list(CARRY_OPS).index(name), len(cases), *args) == 0
    for k, (x, y, z, fl) in enumerate(cases):
        full = value(x, y, z, fl if reads else 0)
        assert int(d[k]) == full % _W32, (name, x, y, z, fl)
        assert int(cout[k]) == (int(full < 0 or full >= _W32) if writes else fl), (name, x, y, z, fl)


_FIELD_OPS = {  # the one-thread kernels of kernels_fq.cu -> Python's value
    "mont_mul": lambda x, y, m: x * y * pow(TP.R_MONT, -1, m) % m,
    "mod_add": lambda x, y, m: (x + y) % m,
    "mod_sub": lambda x, y, m: (x - y) % m,
    "mod_neg": lambda x, y, m: -x % m,
}


@pytest.mark.parametrize("name", list(_FIELD_OPS))
@pytest.mark.parametrize("modulus", [TP.Q, TP.R_SCALAR], ids=["Fq", "Fr"])
def test_header_field_op_carry_chains_equal_python(host_lib, modulus, name):
    """fq.cuh's product, sum, difference and negation, carry chains of
    carry.cuh's twins, as kernels_fq.cu's one-thread kernels run them, on the
    pairs of _group_mul_pairs (carries and borrows through whole words, t
    near 2m and just below m) and, for the three sums, _sum_edge_pairs;
    against Python's integers."""
    a, b = (TP.limbs_to_ints(x[0]) for x in _group_mul_pairs(modulus))
    pairs = list(zip(a, b)) + ([] if name == "mont_mul" else _sum_edge_pairs(modulus))
    ins = [_limbs([x for x, _ in pairs]), _limbs([y for _, y in pairs])]
    got = _run_host(host_lib, name, ins[:1] if name == "mod_neg" else ins, modulus)
    assert TP.limbs_to_ints(got[0]) == [_FIELD_OPS[name](x, y, modulus) for x, y in pairs]


def _host_signed_sum(lib, terms, sources, modulus, out=None, fq2=False):
    """signed_sum.cuh's per-thread body over every (output, row, lane), on the
    table bn_mod_signed_sum would get: the wrapper's own checks and operand
    descriptors, pointing into the CPU tensors' memory."""
    codes, srcs, outs, result = mc._sum_setup(terms, sources, out, fq2)
    srcs = [v if mc._dense_tail(v, fq2) else mc._view(v[0].contiguous()) for v in srcs]
    shape = srcs[0][2]
    rows_shape = shape[: -mc._tail(fq2)]
    n1, n2, desc = mc._sum_operands(srcs + outs, rows_shape)
    words, inv32 = mc._mod_args(modulus)
    rows = int(np.prod(rows_shape, dtype=np.int64))
    assert lib.host_signed_sum(desc, codes, len(srcs), len(outs), n1, n2, rows, shape[-1], int(fq2), words, inv32) == 0
    return result


# the edge pairs' level: x - y, -x, x + y, y - x - x - y, from the two halves
# of a lead-3 Fq12 into the halves of two others
_EDGE_LEVEL = (((0, 1), (1, -1)), ((0, -1),), ((0, 1), (1, 1)), ((1, 1), (0, -1), (0, -1), (1, -1)))
_EDGE_VALUES = (lambda x, y: x - y, lambda x, y: -x, lambda x, y: x + y, lambda x, y: -2 * x)
# the edge pairs fed to xi: an Fq2 level on s0 = (x, y) and s1 = (y, x), an
# Fq2 coefficient of each half: xi s0, -xi s0, xi s0 - xi s1, s1 - xi s0 +
# xi s1 + s0; each output's two coefficients as Python's values of (x, y)
_XI_EDGE_LEVEL = (((0, 1, mc.XI),), ((0, -1, mc.XI),), ((0, 1, mc.XI), (1, -1, mc.XI)),
                  ((1, 1), (0, -1, mc.XI), (1, 1, mc.XI), (0, 1)))
_XI_EDGE_VALUES = (
    (lambda x, y: 9 * x - y, lambda x, y: x + 9 * y),
    (lambda x, y: y - 9 * x, lambda x, y: -x - 9 * y),
    (lambda x, y: 10 * (x - y), lambda x, y: 8 * (y - x)),
    (lambda x, y: (y + x) + (9 * y - x) - (9 * x - y), lambda x, y: (x + y) + (y + 9 * x) - (x + 9 * y)),
)


def _edge_level_case(modulus):
    """The carry and borrow edge pairs (_group_mul_pairs, _sum_edge_pairs) as
    the two halves of a (3, 2, 3, 2, 16, b) Fq12: x in half 0, y in half 1."""
    a, b = (TP.limbs_to_ints(x[0]) for x in _group_mul_pairs(modulus))
    pairs = list(zip(a, b)) + _sum_edge_pairs(modulus)
    lanes = -(-len(pairs) // 18)
    pairs += [(0, 0)] * (18 * lanes - len(pairs))
    halves = [TP.ints_to_limbs([p[h] for p in pairs]).reshape(16, 3, 3, 2, lanes) for h in range(2)]
    fq12 = np.stack([np.moveaxis(x, 0, -2) for x in halves], axis=1)  # (3, 2, 3, 2, 16, lanes)
    return torch.from_numpy(fq12.astype(np.int32)), pairs


@pytest.mark.parametrize("modulus", [TP.Q, TP.R_SCALAR], ids=["Fq", "Fr"])
@pytest.mark.parametrize("case", SIGNED_SUM_CASES + ["edge-pairs", "xi-edge-pairs"])
def test_header_signed_sum_equals_plain(host_lib, case, modulus):
    """k_signed_sum's body (signed_sum.cuh) on the main path's levels at lead
    3, base-field and Fq2 levels, sources read and results written through
    the wrappers' row strides (slices of Fq12 and Fq6 elements, stacked
    operands, packed results), and on the carry and borrow edge pairs as the
    halves of a lead-3 Fq12, also fed to xi as the Fq2 coefficients of the
    halves (9 (m - 1) spans several multiples of m), against Python's
    integers too: equal to the plain signed sum."""
    fq2 = case == "xi-edge-pairs"
    if case in ("edge-pairs", "xi-edge-pairs"):
        a, pairs = _edge_level_case(modulus)
        if fq2:  # s0 = (x, y) and s1 = (y, x): the halves as an Fq2's coefficients, read through a copy
            terms, sources = _XI_EDGE_LEVEL, [a.movedim(-5, -3), a.flip(-5).movedim(-5, -3)]
            out = read = None
        else:
            outs = [torch.full(a.shape, -1, dtype=torch.int32) for _ in range(2)]
            terms, sources = _EDGE_LEVEL, [a.select(-5, 0), a.select(-5, 1)]
            out = read = [o.select(-5, h) for o in outs for h in range(2)]
    else:
        terms, sources, out, read, fq2 = signed_sum_case(case, modulus)
    want = mc.mod_signed_sum_plain(terms, sources, modulus, fq2=fq2)
    got = _host_signed_sum(host_lib, terms, sources, modulus, out, fq2)
    got = list(got) if read is None else read
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if case == "edge-pairs":
        for k, value in enumerate(_EDGE_VALUES):
            lanes = np.moveaxis(got[k].numpy(), -2, 0).reshape(16, -1)
            assert TP.limbs_to_ints(lanes) == [value(x, y) % modulus for x, y in pairs], k
    if case == "xi-edge-pairs":
        for k, values in enumerate(_XI_EDGE_VALUES):
            for c, value in enumerate(values):
                lanes = np.moveaxis(got[k].select(-3, c).numpy(), -2, 0).reshape(16, -1)
                assert TP.limbs_to_ints(lanes) == [value(x, y) % modulus for x, y in pairs], (k, c)


@functools.lru_cache(maxsize=None)
def _group_pow_case(modulus, exponent, batch):
    """The ladder's operand at lead 3 and batch `batch`, 0, 1, m-1 and the
    Montgomery one at both ends of the flat batch, its exponent, and the
    plain version's result."""
    e = modulus - 2 if exponent == "m-2" else exponent
    a = _with_edge_tail(rand_field(390, (3, batch), modulus), modulus)
    return a, e, mc.pow_fixed_plain(*_tensors([a]), e, modulus).numpy()


@pytest.mark.parametrize("order", ["in-order", "reverse"])
@pytest.mark.parametrize("lanes", [4, 8])
@pytest.mark.parametrize("batch", [5, 37])
@pytest.mark.parametrize("exponent", ["m-2", ZERO_DIGIT_EXPONENT, FOUR_DIGIT_EXPONENT],
                         ids=["fermat", "interior-zero-digit", "four-digits"])
@pytest.mark.parametrize("modulus", [TP.Q, TP.R_SCALAR], ids=["Fq", "Fr"])
def test_header_group_pow_equals_plain_and_python_pow(host_lib, modulus, exponent, batch, lanes, order):
    """fq_group_pow, kernel_pow_fixed.cu's ladder, on groups of 4 or 8 lanes
    with the table laid out as the kernel's shared memory, at lead 3: q - 2
    or r - 2, a short exponent with a zero digit inside and one of four
    digits; against the plain version and Python's pow on every lane."""
    a, e, want = _group_pow_case(modulus, exponent, batch)
    name = f"group_pow_{lanes}" + ("_reverse" if order == "reverse" else "")
    extra = TP.int_to_words(e) + TP.int_to_words(TP.R_MONT % modulus)
    got = _run_host(host_lib, name, [a], modulus, n=len(mc.digit_schedule(e)), extra=extra)
    assert np.array_equal(got, want)
    for row_in, row_out in zip(a, got):  # Montgomery domain: v stands for v/R
        vals = [TP.from_mont(v, modulus) for v in TP.limbs_to_ints(row_in)]
        assert TP.limbs_to_ints(row_out) == [TP.to_mont(pow(v, e, modulus), modulus) for v in vals]
    assert TP.limbs_to_ints(got[0])[0] == 0 and TP.limbs_to_ints(got[-1])[-4] == 0  # 0 -> 0


def _run_host_curve(lib, group, coords, reverse=None):
    """jac_add (six coordinate arrays) or jac_double (three) of curve.cuh, or
    with `reverse` set kernels_curve.cu's team of curve_team.cuh (reverse:
    each phase's warps last to first)."""
    arrs = [np.ascontiguousarray(c.astype(np.int32)) for c in coords]
    outs = [np.full_like(arrs[0], -1) for _ in range(3)]
    rows = int(np.prod(arrs[0].shape[: arrs[0].ndim - 2 - len(cc.STRUCTS[group])], dtype=np.int64))
    words, inv32 = mc._mod_args(TP.Q)
    ins_c = (ctypes.c_void_p * len(arrs))(*(a.ctypes.data for a in arrs))
    outs_c = (ctypes.c_void_p * 3)(*(o.ctypes.data for o in outs))
    args = (ins_c, outs_c, rows, arrs[0].shape[-1], words, inv32)
    if reverse is None:
        rc = lib.host_curve(int(len(arrs) == 6), len(cc.STRUCTS[group]), *args)
    else:
        rc = lib.host_curve_team(int(len(arrs) == 6), len(cc.STRUCTS[group]), int(reverse), *args)
    assert rc == 0
    return outs


@pytest.mark.parametrize("group", ["G1", "G2"])
@pytest.mark.parametrize("lead", [(), (3,)], ids=["flat", "lead3"])
def test_header_point_add_and_double_equal_plain(host_lib, group, lead):
    """Random points with, at both ends of the flat batch, P + inf, inf + Q,
    inf + inf, P + P, P + (-P) and one point under two z (curve_points)."""
    p, q = curve_points(group, 400, lead + (29,))
    got = _run_host_curve(host_lib, group, p + q)
    want = cc.point_add_plain(group, _tensors(p), _tensors(q))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    got = _run_host_curve(host_lib, group, p)
    want = cc.point_double_plain(group, _tensors(p))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())


@functools.lru_cache(maxsize=None)
def _curve_team_case(group, case):
    """Points at lead 3 from curve_points (the degenerate pairs at both ends
    of the flat batch: lane 3 adds a point to itself and lane 5 a point under
    two z, so block 0 has lanes that take the doubling and lanes that do
    not), and the plain version's sum and double.  "B1": B = 1, the MSM's
    Horner width, at lead 12 (curve_points needs 12 points), one block
    across the rows.  "B64-infinite-block": B = 64 with every lane of flat
    block 2 (row 1, lanes 0-31) holding an infinite operand, q, p or both in
    turn."""
    batch = int(case[1:].split("-")[0])
    p, q = curve_points(group, 410, (12, 1) if batch == 1 else (3, batch))
    if case.endswith("infinite-block"):
        p, q = [list(c.copy() for c in pt) for pt in (p, q)]
        inf = [c[0, ..., 2] for c in p]  # flat lane 2 is infinity + infinity
        for lane in range(32):
            for k, c in enumerate(q if lane % 3 == 0 else p):
                c[1, ..., lane] = inf[k]
            if lane % 3 == 2:
                for k, c in enumerate(q):
                    c[1, ..., lane] = inf[k]
        p, q = tuple(p), tuple(q)
    want_add = tuple(w.numpy() for w in cc.point_add_plain(group, _tensors(p), _tensors(q)))
    want_double = tuple(w.numpy() for w in cc.point_double_plain(group, _tensors(p)))
    return p, q, want_add, want_double


@pytest.mark.parametrize("order", ["in-order", "reverse"])
@pytest.mark.parametrize("case", ["B1", "B5", "B37", "B64", "B64-infinite-block"])
@pytest.mark.parametrize("law", ["add", "double"])
@pytest.mark.parametrize("group", ["G1", "G2"])
def test_header_curve_teams_equal_one_thread_and_plain(host_lib, group, law, case, order):
    """kernels_curve.cu's teams (curve_team.cuh on team_block_on) at lead 3:
    B = 5, one ragged block of 15 elements; B = 37, blocks of 32 that straddle
    the rows, the last ragged; B = 64, blocks within rows, and once with a
    block in which every lane has an infinite operand; and B = 1 at lead 12,
    one ragged block across the rows.  One base-field product a warp: a
    Montgomery product for G1, an Fq2 product for G2.  Warps of each phase in
    order and last to first, the state poisoned at every block.  Equal, limb
    for limb, to curve.cuh's one-thread jac_add / jac_double and to the plain
    version, degenerate lanes included."""
    p, q, want_add, want_double = _curve_team_case(group, case)
    coords = p + q if law == "add" else p
    got = _run_host_curve(host_lib, group, coords, reverse=order == "reverse")
    one_thread = _run_host_curve(host_lib, group, coords)
    for g, t, w in zip(got, one_thread, want_add if law == "add" else want_double):
        assert np.array_equal(g, w) and np.array_equal(t, w)
    if law == "add" and case.endswith("infinite-block"):  # q, p, or p = infinity itself, in turn
        assert all(np.array_equal(got[k][1, ..., :32:3], p[k][1, ..., :32:3]) for k in range(3))
        assert all(np.array_equal(got[k][1, ..., 1:32:3], q[k][1, ..., 1:32:3]) for k in range(3))


def test_inv32_matches_header_convention():
    # the headers reduce with mu = t0 * inv mod 2^32, so m * inv = -1 mod 2^32
    for m, inv32 in ((TP.Q, TP.FQ_INV32), (TP.R_SCALAR, TP.FR_INV32)):
        assert (m * inv32 + 1) % (1 << 32) == 0
        assert mc._mod_args(m)[1].value == inv32
        assert sum(w << (32 * i) for i, w in enumerate(mc._mod_args(m)[0])) == m
