#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run `python3 chip_smoke.py` from the repository root on a machine with one
NVIDIA H100 (or another sm_90a card) and the CUDA toolkit.  It

 1. builds the kernels under bn_tpu_torch/csrc/ with nvcc (all sources at
    once) and prints the card's name and power limit and the build time;
 2. makes the main path's inputs: 8192 (G1, G2) pairs on the card by scalar
    multiplication of the generators with seeded scalars (two ladders of 256
    `point_double` and 256 `point_add` launches);
 3. calls each of the nineteen kernel wrappers on CUDA tensors — at a ragged
    batch of 1000 with the edge values 0, 1, m-1 and the Montgomery one, for
    both moduli where the kernel takes one, and at the shape the main path
    gives it at B = 8192 — and holds each result against the kernel's plain
    PyTorch version on the same inputs (`mont_mul`, `mod_add`, `mod_sub`,
    `mod_neg`, `fq2_sq` and `fq2_xi` for both moduli and `fq2_mul` also on
    edge_pairs(), whose carries and borrows run through whole words, all but
    `fq2_mul` against Python's integers too; `fq2_sq`, a team of two warps,
    also at B = 1, 37, 8192 and 2^16 to 2^20 lanes, each width timed;
    `fq12_mul`, with lazy reduction, also at 1024 lanes (the dist fold's
    width) and 65536 (the benchmark's), that width timed too, its bound kept
    on the reference's 54 reduced products with the lazy count of
    multiply-adds beside it; `pow_fixed` also against Python's
    pow, with the Fermat exponent and one with a zero digit inside; the
    squaring chain at n = 1, 2, 5; the precompute steps on both outputs;
    `miller_step` in both instantiations, with and without the square;
    `point_add` and `point_double` for G1 and G2 in each of their two
    designs, the team of csrc/curve_team.cuh and one thread a point, on
    points that hold, at both ends of the batch, P + inf, inf + Q, inf +
    inf, P + P, P + (-P) and one point under two z, at B = 37, lead 3, at
    B = 1 and at B = 8192, each design timed for G1 and G2 at B = 8192 and
    for G1 at 2^20; the wrapper's own pick by width at the ragged batch).
    Tolerance: none, the limbs are integers and `max_abs_err` must be 0.  It
    times both (the kernel by replaying a CUDA graph of 50 launches, so `ms`
    is the card's time; the eager call, host included, is `wrapper_ms`),
    measures the card's 32x32->64-bit multiply-add rate with a register-only
    probe and the launch floor with an empty kernel (the same graph replay,
    at one block and at the grids rows 1-7 launch), and from that rate and
    the published memory rate computes each
    kernel's bound at the timed shape; the eleven kernels that give 32
    elements to a block, the teams `fq12_mul`, `fq12_sq`, `fq12_mul024_pre`,
    the chain, `fq12_cyclo_sq`, `double_step`, `madd_step`, `fq12_mul024`,
    `miller_step` (both instances) and `fq2_sq` and the group kernel `pow_fixed`, are also
    held at B = 37, lead 3 (blocks of 32 that straddle the rows; `pow_fixed`
    for both moduli and both exponents, against Python's pow too), and their
    rows give the block of their launch at the
    timed shape (threads, elements) and the loaded kernel's static shared
    memory (cudaFuncGetAttributes); the chain's row its time at n = 1 and 5
    beside n = 2.  mod_sub, mod_neg and fq2_xi are the two- and one-term
    cases of k_signed_sum; `mod_signed_sum` launches it on a whole level of
    signed sums, of field elements or of Fq2 elements whose terms may
    multiply by xi, and each level the main path runs (SUM_LEVELS:
    conjugations, fq6_mul's two levels, fq6_inv's three, fq12_inv's
    difference, the twisted bases' conjugates; the Fq2 ones those with a xi term)
    is held against the plain signed sum at a ragged batch of 1000, lead 3,
    for both moduli, and at the main path's shape, where it is timed (its
    row: `levels`); and on the edge pairs as the halves of a lead-3 Fq12 and
    as the coefficients of Fq2 elements fed to xi, also against Python's
    integers;
 4. drives the main path once: `pairing_batch` as a caller gets it, every
    switch of ops/backend.py at its default (the four fusions on,
    `miller_step` off).  Launch counts are set to 0 just before that call and
    read just after it; each of the pairing's thirteen kernels must have been
    launched, neither curve kernel nor `fq12_mul024` nor `miller_step`,
    `pow_fixed` 3, `fq12_cyclo_sq_chain` 69, `double_step` 64 and
    `madd_step` 38 times, and the sums SUM_LAUNCHES times (`mod_add` 2,
    `mod_signed_sum` 25, `mod_sub`, `mod_neg` and `fq2_xi` alone never),
    LAUNCHES_TOTAL["fused"] launches in all.
    Lanes 0, 1, B/2 and B-1 must equal the pure-Python oracle bit for bit,
    the two lanes with an infinite input must give Gt one, and the
    bilinearity pair e(sP, Q) = e(P, sQ) must agree;
 5. drives the unfused path (every fusion off) on the first 1024 lanes of the
    same inputs: it must launch each of the ten unfused kernels and `mod_sub`,
    `mod_neg` and `fq2_xi` alone (whose path it is), none of the four fused
    ones, LAUNCHES_TOTAL["unfused"] in all, and return the fused run's lanes bit for bit;
    likewise the precompute alone, whole tensor;
 6. times both paths at B = 8192 in turns, three runs each;
 6b. `miller_path`: the main path's inputs with the `miller_step` switch on:
    exactly 102 `miller_step` launches (64 of them the squaring instance),
    none of `fq12_sq`, `fq12_mul024_pre` or `fq2_xi`, LAUNCHES_TOTAL["miller_step"]
    in all, and all 8192 lanes equal to the
    main path's result; both configurations timed in turns, the pairing and
    the Miller loop alone, three runs each; `tower.fq12_mul_by_024` on the
    run's own line coefficients and points (one `fq12_mul024` launch) equal
    to `fq12_mul024_pre` on the scaled line and to `miller_step` without the
    square; and, on the easy part of the final exponentiation of the run's
    Miller loop (a cyclotomic element, all 8192 lanes), `fq12_cyclo_sq` and
    the chain at n = 1 equal to the `fq12_sq` team, and the chain at n = 2 to
    two of its squares: the Karatsuba members share nothing with the
    Granger-Scott members that the fused and the unfused paths both run;
 7. `curve_path`: `curve.mul` for G1 and G2 on 1024 lanes with the
    `curve_kernels` switch on and off: the same limbs, with it on exactly 256
    `point_double` and 256 `point_add` launches a ladder and no `mod_add`
    (of the design the wrapper picks at that width, counted by design);
    both timed at B = 8192 in turns;
 8. `api_path` at B = 8192 through bn_tpu_torch.api only: random Fr, G1, G2
    from seeds, byte round trips (the G2 decode runs the batched subgroup
    check on 8192 lanes), refusal of a batch with one on-curve point outside
    the r-order subgroup (DecodeError naming its index), of an off-curve
    point and of a coordinate >= q, bilinearity through `pairing` and
    `Gt.pow`, lanes against the oracle, and the two examples dh_torch and
    joux_torch at batch 8192, with the seconds of each step;
 9. `msm_path`: the Pippenger MSM at n = 2^20, c = 16 — points k_i G made on
    the card by one ladder, seeded scalars, the host schedule, `msm_run`, the
    result equal to (sum s_i k_i mod r) G from the oracle, launch counts
    equal to what the schedule implies (and counted by design: the
    one-thread design at the rounds' 2^20 lanes, the team below) — then a
    small skewed case that forces
    window-local spill rounds, and the MSM at n = 2^12 with `curve_kernels`
    off, equal limbs;
 9b. `dist_path`: bn_tpu_torch.parallel.dist in one process, an NCCL group
    of world size 1 on the card (file rendezvous in a temporary directory):
    `sharded_pairing_product` of the main path's 8192 pairs equal to
    `fq12_fold_product` of the main path's result, `sharded_msm` of the
    first 2^12 points and scalars of `msm_path` equal to the oracle's sum, a
    CUDA tensor under a gloo group refused; the seconds of each; and the
    dry run of __graft_entry_torch__ (dryrun_multichip(1)) in that
    group, its rank's product equal to the oracle's product of its two
    pairings, then once more on its spawn path (one rank, its own process,
    NCCL) after the group is destroyed;
 9c. `trials`: the reference's field and group property trials
    (tools/torch_trials.py, the seeds and draws of tests/test_field_trials.py
    and tests/test_group_trials.py) at N_TRIALS = 10,000 lanes, not a
    multiple of 32: for Fr, Fq, Fq2, Fq6 and Fq12 the inversion walk, 0^-1 =
    0, random inversions and cancellations, associativity, squaring,
    distributivity, the add / neg walk and a + (-a) = 0, for Fq2 the spot
    inversion, for G1 and G2 addition, doubling, Diffie-Hellman and the
    do / undo walk (ladders of 10,000 lanes); one product a field and one
    point a group against the oracle at lanes 0, 5,000 and 9,999; every
    lane must pass.  The seconds of each trial, and the launches of one
    `curve.mul` at this width by design: `point_double` one thread a point,
    `point_add` the team (THREAD_FROM_LANES);
 9d. `entry`: __graft_entry_torch__.entry()'s function on its arguments on
    the card, all 8 lanes equal to the oracle's pairings;
10. prints one JSON line per phase, the card line, the `kernels` line and the
    last line {"ok": true, "device": {...}}.

Any failure — no CUDA device, a build error, a kernel that differs from its
plain version, a lane that differs from the oracle — ends the run with a
non-zero exit code and no result line.
"""

import contextlib
import ctypes
import functools
import json
import math
import re
import statistics
import subprocess
import sys

B_MAIN = 8192  # the main path's batch
B_RAGGED = 1000  # not a multiple of any block size
HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet
MADDS_PER_PRODUCT = 2 * 8 * 8 + 8  # 32x32->64 multiply-adds of one Montgomery product

B_UNFUSED = 1024  # lanes of the same inputs the unfused path is driven on
ZERO_DIGIT_EXPONENT = 0xA0B7F03  # a short exponent with a zero digit inside

# kernel -> (C source, TPU kernel it replaces, operand structs at the timed
#            shape, base-field products per element, word adds per element;
#            the adds set the bound only where a kernel has no products).
# pow_fixed's products are per product of its ladder and the chain's per
# squaring: products_of() multiplies them out.
KERNEL_TABLE = {
    "mont_mul": ("kernels_fq.cu", "bn_tpu/ops/mont_pallas.py:366", [(), ()], 1, 16),
    "mod_add": ("kernels_fq.cu", "bn_tpu/ops/mont_pallas.py:371", [(2,), (2,)], 0, 2 * 16),
    "mod_sub": ("kernels_fq.cu", "bn_tpu/ops/mont_pallas.py:375", [(2,), (2,)], 0, 2 * 16),
    "mod_neg": ("kernels_fq.cu", "bn_tpu/ops/mont_pallas.py:379", [(2,)], 0, 2 * 8),
    "fq2_mul": ("kernels_fq.cu", "bn_tpu/ops/mont_pallas.py:383", [(5, 2), (5, 2)], 5 * 3, 5 * 5 * 16),
    "fq2_sq": ("kernels_fq.cu", "bn_tpu/ops/mont_pallas.py:388", [(2,)], 2, 3 * 16),
    "fq2_xi": ("kernels_fq.cu", "bn_tpu/ops/mont_pallas.py:394", [(2,)], 0, 10 * 16),
    "pow_fixed": ("kernel_pow_fixed.cu", "bn_tpu/ops/mont_pallas.py:523", [()], 1, 0),
    "fq12_mul": ("kernel_fq12_mul.cu", "bn_tpu/ops/tower_pallas.py:1002", [(2, 3, 2), (2, 3, 2)], 54, 0),
    "fq12_sq": ("kernel_fq12_sq.cu", "bn_tpu/ops/tower_pallas.py:1010", [(2, 3, 2)], 36, 0),
    "fq12_mul024_pre": ("kernel_fq12_mul024_pre.cu", "bn_tpu/ops/tower_pallas.py:1047", [(2, 3, 2), (2,), (2, 2)], 39, 0),
    "fq12_cyclo_sq": ("kernel_fq12_cyclo_sq.cu", "bn_tpu/ops/tower_pallas.py:1015", [(2, 3, 2)], 18, 0),
    "fq12_cyclo_sq_chain": ("kernel_fq12_cyclo_sq_chain.cu", "bn_tpu/ops/tower_pallas.py:1020", [(2, 3, 2)], 18, 0),
    # the two products by 1/2 of the formula are halvings: 2 Fq2 halvings as 64 word adds
    "double_step": ("kernels_g2_step.cu", "bn_tpu/ops/tower_pallas.py:1068", [(3, 2)], 24, 64),
    "madd_step": ("kernels_g2_step.cu", "bn_tpu/ops/tower_pallas.py:1077", [(3, 2), (2, 2)], 37, 0),
    "fq12_mul024": ("kernel_fq12_mul024.cu", "bn_tpu/ops/tower_pallas.py:1039", [(2, 3, 2), (3, 2)], 39, 0),
    # products with the square; 43 without (products_of)
    "miller_step": ("kernel_miller_step.cu", "bn_tpu/ops/tower_pallas.py:1059", [(2, 3, 2), (3, 2), (), ()], 79, 0),
}
# the two curve kernels: (TPU kernel, products per point over Fq, over Fq2);
# an addition's count is the chord's, which is what generic points need (the
# kernel computes the doubling only where both operands are one finite point)
CURVE_KERNELS = {
    "point_add": ("bn_tpu/ops/curve_pallas.py:410", 16, 43),
    "point_double": ("bn_tpu/ops/curve_pallas.py:417", 7, 16),
}
# kernels whose C source also has bn_<name>_launch: the block of a launch.
# These give 32 elements to a block, so they are also held at B_STRADDLE.
TEAM_KERNELS = ("fq12_mul", "fq12_sq", "fq12_mul024_pre", "fq12_cyclo_sq", "fq12_cyclo_sq_chain",
                "double_step", "madd_step", "pow_fixed", "fq12_mul024", "miller_step", "fq2_sq")
# fq2_sq's team, also held and timed at these widths (lanes of one Fq2 row):
# one lane, a ragged block, the main path, and from 2^16 to 2^20, where the
# bytes take over
FQ2_SQ_WIDTHS = (1, 37, 8192, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20)
# fq12_mul's team, also held at the dist fold's width and the benchmark's,
# the latter timed; its row keeps the bound of 54 reduced products
# (KERNEL_TABLE) and gives the multiply-adds the lazy team does beside it:
# 54 whole products of 128 and 12 reductions of 136
FQ12_MUL_WIDTHS = (1024, 1 << 16)
FQ12_MUL_LAZY_MADDS = 54 * 2 * 8 * 8 + 12 * MADDS_PER_PRODUCT
# kernels held against their plain version for Fr as well as Fq
BOTH_MODULI = ("mont_mul", "mod_add", "mod_sub", "mod_neg", "pow_fixed", "fq2_sq", "fq2_xi")
B_STRADDLE = 37  # at lead 3: blocks of 32 straddle the rows, the last one ragged
MILLER_KERNELS = ("fq12_mul024", "miller_step")  # not on the default path
# mod_sub, mod_neg and fq2_xi are the two- and one-term cases of
# k_signed_sum: the fused path runs its levels through mod_signed_sum and
# calls none of them alone; the unfused path does (its precompute's sums and
# products by xi), so that is their path
SUM_SINGLE_OPS = ("mod_sub", "mod_neg", "fq2_xi")
# the thirteen kernels pairing_batch launches
PAIRING_KERNELS = tuple(k for k in KERNEL_TABLE if k not in MILLER_KERNELS + SUM_SINGLE_OPS) + ("mod_signed_sum",)
# launches of the sums in one fused pairing_batch: fq2_inv's add alone (twice);
# every other sum, difference, negation, conjugation and product by xi is one
# mod_signed_sum launch a level (fq12_conj 10, fq12_inv 10, to_affine's
# fq2_inv 1, the odd Frobenius maps 2, the twisted bases 2)
SUM_LAUNCHES = {"mod_add": 2, "mod_sub": 0, "mod_neg": 0, "fq2_xi": 0, "mod_signed_sum": 25}
# the port's launches of one pairing_batch in each configuration (the
# unfused one on B_UNFUSED lanes: the count does not depend on the batch)
LAUNCHES_TOTAL = {"fused": 489, "miller_step": 424, "unfused": 3367}
# mod_signed_sum's levels on the main path, with the leading axes they have
# there at B = 8192 (fq12_inv's Fq6 products run on the pair (a0, a1))
SUM_LEVELS = {
    "fq12_conj": (),  # the halves of an Fq12: fq12_conj, fq12_inv's result
    "fq2_conj_fq12": (),  # every Fq2 coefficient of an Fq12: the odd Frobenius maps
    "fq2_conj": (),  # fq2_inv's result
    "fq6_mul_operands": (2,),
    "fq6_mul_operands_broadcast": (2,),  # fq6_mul(both, t[None])
    "fq6_mul_results": (2,),
    "fq6_inv_operands": (),
    "fq6_inv_norm_factors": (),
    "fq6_inv_norm": (),
    "fq6_sub_nonresidue": (),  # fq12_inv's p0 - v p1
    "mul_by_q_conj": (),
    "mul_by_q_conj_negated": (),
}
SUM_ROW_LEVEL = "fq6_mul_operands"  # the largest level: the row's own time and bound
# the edge pairs' level: x - y, -x, x + y, y - x - x - y from the halves of a
# lead-3 Fq12 into the halves of two others
EDGE_SUM_TERMS = (((0, 1), (1, -1)), ((0, -1),), ((0, 1), (1, 1)), ((1, 1), (0, -1), (0, -1), (1, -1)))
EDGE_SUM_VALUES = (lambda x, y: x - y, lambda x, y: -x, lambda x, y: x + y, lambda x, y: -2 * x)
# the edge pairs fed to xi: an Fq2 level on s0 = (x, y) and s1 = (y, x):
# xi s0, -xi s0, xi s0 - xi s1, s1 - xi s0 + xi s1 + s0, each output's two
# coefficients as values of (x, y) (terms built in main(): the XI marker)
XI_EDGE_SUM_VALUES = (
    (lambda x, y: 9 * x - y, lambda x, y: x + 9 * y),
    (lambda x, y: y - 9 * x, lambda x, y: -x - 9 * y),
    (lambda x, y: 10 * (x - y), lambda x, y: 8 * (y - x)),
    (lambda x, y: (y + x) + (9 * y - x) - (9 * x - y), lambda x, y: (x + y) + (y + 9 * x) - (x + 9 * y)),
)
MILLER_STEPS = {"square": 64, "no_square": 38}  # miller_step launches of one pairing_batch, by instance
LOG2_MSM = 20  # the MSM's size: 2^20 points
MSM_C = 16  # its window
N_TRIALS = 10000  # the reference's field trial width; 312 blocks of 32 and 16 lanes
B_CURVE_CHECK = 1024  # lanes of the curve.mul comparison, switch on against off
FUSED_KERNELS = {"pow_fixed": 3, "fq12_cyclo_sq_chain": 69, "double_step": 64, "madd_step": 38}  # launches per pairing_batch
UNFUSED = dict(pow_fixed=False, cyclo_chain=False, ladder=False)
# mangled-name fragments of the __global__ functions, to read `ptxas -v`
PTXAS_NAMES = {
    "mont_mul": "8k_binaryILi0E", "mod_add": "8k_binaryILi1E", "mod_sub": "12k_signed_sumI8SumDenseILi1ELin2ELi1EEE",
    "mod_neg": "12k_signed_sumI8SumDenseILin1ELi0ELi1EEE", "mod_signed_sum": "12k_signed_sumI8SumTableE",
    "fq2_mul": "9k_fq2_mul", "fq2_sq": "8k_fq2_sq",
    "fq2_xi": "12k_signed_sumI8SumDenseILi33ELi0ELi2EEE", "fq12_mul": "10k_fq12_mul", "fq12_sq": "9k_fq12_sq",
    "fq12_mul024_pre": "17k_fq12_mul024_pre", "fq12_cyclo_sq": "15k_fq12_cyclo_sq",
    "pow_fixed": "11k_pow_fixed", "fq12_cyclo_sq_chain": "21k_fq12_cyclo_sq_chain",
    "double_step": "13k_double_step", "madd_step": "11k_madd_step",
    "point_add": "11k_point_addI2FqE", "point_double": "14k_point_doubleI2FqE",
    "fq12_mul024": "13k_fq12_mul024", "miller_step": "13k_miller_stepILb1E",
}
PTXAS_NAMES_G2 = {"point_add": "11k_point_addI3Fq2E", "point_double": "14k_point_doubleI3Fq2E"}
# the curve kernels' team design (k_curve_team<CurveTeam<F, add>>), G1 and G2
PTXAS_NAMES_TEAM = {"point_add": "12k_curve_teamI9CurveTeamI2FqLb1EEE",
                    "point_double": "12k_curve_teamI9CurveTeamI2FqLb0EEE"}
PTXAS_NAMES_TEAM_G2 = {"point_add": "12k_curve_teamI9CurveTeamI3Fq2Lb1EEE",
                       "point_double": "12k_curve_teamI9CurveTeamI3Fq2Lb0EEE"}
PTXAS_NAMES_NO_SQ = {"miller_step": "13k_miller_stepILb0E"}
PTXAS_NAMES_FQ2 = {"mod_signed_sum": "12k_signed_sumI11Fq2SumTableE"}  # the Fq2 form of the level


# kernels also fed edge_pairs(): fq.cuh's carry chains with carries and
# borrows through whole words (fq2_mul's Karatsuba sums and products too; for
# fq2_sq and fq2_xi a pair is an Fq2, xi's 9 x crossing several multiples of m)
EDGE_KERNELS = ("mont_mul", "mod_add", "mod_sub", "mod_neg", "fq2_mul", "fq2_sq", "fq2_xi")


@functools.lru_cache(maxsize=None)
def edge_pairs(modulus, r_mont):
    """Operand pairs (ints below the modulus m) that drive fq.cuh's carry
    chains through whole words, as tests/test_torch_csrc_host.py's
    _group_mul_pairs and _sum_edge_pairs make them (this script keeps its own
    copy).  For the product: every pair of the edge values 0, 1, 2, R mod m,
    m - 1, m - 2, values whose low k words are all ones (2^32k - 1, and m's
    top words less one above them) and values with one all-ones word
    elsewhere; a = r R / b for results r with runs of all-ones or zero words
    and three b; and the pairs of a seeded search whose CIOS accumulator t
    before the final subtraction is largest (near 2m) or just below m.  For
    the sums: a + b = m - 1, m and m + 1, a = b and a = b - 1 for edge values
    a, and every pair of the all-ones values."""
    import numpy as np

    m, R = modulus, r_mont

    def cios_t(a, b):
        mu = (-a * b * pow(m, -1, R)) % R
        return (a * b + mu * m) // R

    ones = [(1 << (32 * k)) - 1 for k in range(1, 8)]
    edges = [0, 1, 2, R % m, m - 1, m - 2] + ones
    edges += [((m >> (32 * k)) << (32 * k)) - 1 for k in range(1, 8)]
    edges += [0xFFFFFFFF << (32 * j) for j in range(1, 7)]
    pairs = [(x, y) for x in edges for y in edges]
    results = ones + [(m >> (32 * k)) << (32 * k) for k in range(1, 8)]
    results += [m - (1 << (32 * k)) for k in range(1, 8)] + [1 << (32 * k) for k in range(1, 8)]
    pairs += [(r * R * pow(b, -1, m) % m, b) for r in results for b in (1, m - 1, 0xFFFFFFFF << 96)]
    rng = np.random.default_rng(395)
    found = []
    for _ in range(20000):
        x, y = (int.from_bytes(rng.bytes(40), "big") % m for _ in range(2))
        found.append((cios_t(x, y), x, y))
    found.sort()
    pairs += [(x, y) for _, x, y in found[-64:] + [f for f in found if f[0] < m][-16:]]
    pairs += [(x, y) for x in ones for y in ones]
    for x in [0, 1, 2, m - 1, m - 2, (m - 1) // 2, (m + 1) // 2, R % m] + ones:
        pairs += [(x, s - x) for s in (m - 1, m, m + 1) if 0 <= s - x < m]
        pairs += [(x, x)] + ([(x, x + 1)] if x + 1 < m else [])
    return pairs


def statics(name, modulus):
    """The static arguments a kernel is tried with at the ragged batch: the
    exponents of pow_fixed, the chain's lengths, None for the rest."""
    if name == "pow_fixed":
        return [modulus - 2, ZERO_DIGIT_EXPONENT]
    if name == "fq12_cyclo_sq_chain":
        return [1, 2, 5]
    if name == "miller_step":
        return [True, False]
    return [None]


def products_of(name, static):
    """Base-field products per element, with the kernel's static argument."""
    per = KERNEL_TABLE[name][3]
    if name == "pow_fixed":  # the table, then 4 squarings and a product per further digit
        digits = (static.bit_length() + 3) // 4
        return per * (15 + 5 * (digits - 1))
    if name == "fq12_cyclo_sq_chain":
        return per * static
    if name == "miller_step" and not static:  # no square: 4 scaling + 39 products
        return per - 36
    return per


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def ptxas_stats(log: str, fragment: str):
    """registers / stack / spill bytes of the entry whose mangled name
    contains `fragment`, from the text `nvcc -Xptxas -v` printed."""
    blocks = re.split(r"(?=ptxas info\s+: Compiling entry function)", log)
    for blk in blocks:
        head = re.match(r"ptxas info\s+: Compiling entry function '([^']+)'", blk)
        if not head or f"_Z{fragment}" not in head.group(1):
            continue
        regs = re.search(r"Used (\d+) registers", blk)
        # the entry's own line follows "Function properties for <entry>"
        own = re.search(
            re.escape(head.group(1)) + r"\s*\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
            blk,
        )
        return {
            "registers": int(regs.group(1)) if regs else None,
            "stack_bytes": int(own.group(1)) if own else None,
            "spill_store_bytes": int(own.group(2)) if own else None,
            "spill_load_bytes": int(own.group(3)) if own else None,
        }
    return None


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")

    import os
    import time

    import numpy as np

    import bn_tpu_torch  # noqa: F401
    from bn_tpu_torch import Fr, G1, G2, Gt, ate, curve, msm, pairing
    from bn_tpu_torch import serialization as S
    from bn_tpu_torch import oracle as O
    from bn_tpu_torch import params as P
    from bn_tpu_torch.fields import fp, tower
    from bn_tpu_torch.ops import backend, build
    from bn_tpu_torch.ops import curve_cuda as cc
    from bn_tpu_torch.ops import mont_cuda as mc
    from bn_tpu_torch.ops import tower_cuda as tc

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]

    # ---- phase 1: device and build ------------------------------------------
    build_s = build.build_all()
    ptxas = {}
    for name, frag in PTXAS_NAMES.items():
        ptxas[name] = ptxas_stats(build.ptxas_log(build.ENTRIES[name][0]), frag)
    for name, frag in PTXAS_NAMES_G2.items():
        ptxas[name + "_g2"] = ptxas_stats(build.ptxas_log(build.ENTRIES[name][0]), frag)
    for name, frag in PTXAS_NAMES_NO_SQ.items():
        ptxas[name + "_no_sq"] = ptxas_stats(build.ptxas_log(build.ENTRIES[name][0]), frag)
    for name, frag in PTXAS_NAMES_FQ2.items():
        ptxas[name + "_fq2"] = ptxas_stats(build.ptxas_log(build.ENTRIES[name][0]), frag)
    for suffix, names in (("_team", PTXAS_NAMES_TEAM), ("_team_g2", PTXAS_NAMES_TEAM_G2)):
        for name, frag in names.items():
            ptxas[name + suffix] = ptxas_stats(build.ptxas_log(build.ENTRIES[name][0]), frag)
            if ptxas[name + suffix] is None:
                fail(f"ptxas -v reported no entry {frag}: the team of {name} was not built")
    emit({"phase": "device", "card": smi, "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(build_s, 2), "sources": build.sources(), "ptxas": ptxas})

    def timed_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    def device_ms(fn, reps):
        """Time of one call on the card alone: `reps` calls recorded into a
        CUDA graph and replayed, so that the host's time to start a launch
        (tens of microseconds in Python) is not in the number."""
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        return timed_ms(graph.replay, 5) / reps

    # ---- multiply-add rate probe --------------------------------------------
    blocks, threads, iters, chains = 132 * 8, 256, 4096, 8
    probe_out = torch.empty(blocks * threads, dtype=torch.int64, device=dev)
    probe_ms = min(
        timed_ms(lambda: build.launch("imad_probe", dev, probe_out.data_ptr(), blocks, threads, iters), 3)
        for _ in range(3)
    )
    madd_per_s = blocks * threads * iters * chains / (probe_ms * 1e-3)
    # the launch floor: an empty kernel, timed as every kernel row is (graph
    # replay of 50 launches), at one block and at each grid of 128-thread
    # blocks that rows 1-7 launch at B = 8192
    floor_cache = {}

    def launch_floor_ms(n_blocks, n_threads=128):
        if (n_blocks, n_threads) not in floor_cache:
            floor_cache[n_blocks, n_threads] = device_ms(
                lambda: build.launch("empty_probe", dev, n_blocks, n_threads), 50)
        return floor_cache[n_blocks, n_threads]

    floor_one_block = launch_floor_ms(1, 32)
    emit({"phase": "probe", "what": "32x32->64-bit multiply-add with 64-bit addend, register only",
          "madds": blocks * threads * iters * chains, "ms": probe_ms, "madd_per_s": madd_per_s,
          "launch_floor_ms": {"1 block of 32 threads": floor_one_block,
                              **{f"{b} blocks of 128 threads": launch_floor_ms(b) for b in (64, 128, 320)}},
          "card": smi})

    # ---- phase 2: the main path's inputs --------------------------------------
    B = B_MAIN
    rng = np.random.default_rng(42)
    ks1 = [int.from_bytes(rng.bytes(64), "big") % P.R_SCALAR for _ in range(B)]
    ks2 = [int.from_bytes(rng.bytes(64), "big") % P.R_SCALAR for _ in range(B)]
    lane_g1_inf, lane_g2_inf, lane_sp, lane_sq = 2, 3, 4, 5
    ks1[lane_g1_inf] = 0  # 0 * G1 = infinity
    ks2[lane_g2_inf] = 0  # 0 * G2 = infinity
    s = int.from_bytes(rng.bytes(64), "big") % P.R_SCALAR
    ks1[lane_sp] = ks1[lane_sq] * s % P.R_SCALAR  # lane_sp: (s a) G1, b G2
    ks2[lane_sp] = ks2[lane_sq]
    ks2[lane_sq] = ks2[lane_sq] * s % P.R_SCALAR  # lane_sq: a G1, (s b) G2
    k1 = fp.to_device(fp.FR, ks1)
    k2 = fp.to_device(fp.FR, ks2)
    g1s, g2s = curve.g1_spec(), curve.g2_spec()
    if not backend.curve_kernels:
        fail("the curve kernels are not the default")
    build.reset_counts()
    p = curve.mul(g1s, curve.one(g1s, (B,)), k1)
    q = curve.mul(g2s, curve.one(g2s, (B,)), k2)
    torch.cuda.synchronize()
    if (build.COUNTS["point_double"], build.COUNTS["point_add"], build.COUNTS["mod_add"]) != (512, 512, 0):
        fail(f"the two input ladders did not run on the curve kernels: {dict(build.COUNTS)}")

    # ---- phase 3: every kernel against its plain version ---------------------
    def static_last(fn):
        """fn(*ins, modulus) as a call that also takes (and drops) a static."""
        return lambda ins, modulus, static: fn(*ins, modulus)

    wrappers = {name: (static_last(getattr(mod, name)), static_last(getattr(mod, name + "_plain")))
                for mod, names in ((mc, ("mont_mul", "mod_add", "mod_sub", "mod_neg", "fq2_mul", "fq2_sq", "fq2_xi")),
                                   (tc, ("fq12_mul", "fq12_sq", "fq12_mul024_pre", "fq12_cyclo_sq", "fq12_mul024")))
                for name in names}
    wrappers["pow_fixed"] = (lambda ins, m, e: mc.pow_fixed(*ins, e, m), lambda ins, m, e: mc.pow_fixed_plain(*ins, e, m))
    wrappers["fq12_cyclo_sq_chain"] = (lambda ins, m, n: tc.fq12_cyclo_sq_chain(*ins, n, m),
                                       lambda ins, m, n: tc.fq12_cyclo_sq_chain_plain(*ins, n, m))
    wrappers["double_step"] = (lambda ins, m, _: tc.double_step(*ins), lambda ins, m, _: tc.double_step_plain(*ins))
    wrappers["madd_step"] = (lambda ins, m, _: tc.madd_step(*ins), lambda ins, m, _: tc.madd_step_plain(*ins))
    wrappers["miller_step"] = (lambda ins, m, sq: tc.miller_step(*ins, sq), lambda ins, m, sq: tc.miller_step_plain(*ins, sq))

    def rand_field(rng, lead, batch, modulus, specials):
        """(*lead, 16, batch) int32 limbs of values in [0, m) on the card."""
        n = int(np.prod(lead, dtype=np.int64)) * batch
        vals = [int.from_bytes(rng.bytes(40), "big") % modulus for _ in range(n)]
        if specials:
            for i, v in enumerate([0, 1, modulus - 1, P.R_MONT % modulus][:n]):
                vals[i] = v
                vals[n - 1 - i] = v  # the ragged edge too
        limbs = P.ints_to_limbs(vals).astype(np.int32)  # (16, n)
        arr = np.moveaxis(limbs.reshape((16,) + tuple(lead) + (batch,)), 0, -2)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    def limbs_on_card(vals):
        """Python ints (a list, or a list of lists for a leading axis) as
        (..., 16, n) int32 limbs on the card."""
        rows = [P.ints_to_limbs(v) for v in vals] if isinstance(vals[0], list) else P.ints_to_limbs(vals)
        return torch.from_numpy(np.ascontiguousarray(np.asarray(rows).astype(np.int32))).to(dev)

    def outputs(x):
        return x if isinstance(x, tuple) else (x,)

    def compare(name, got, want, where):
        """Largest absolute difference over every output; fails unless 0."""
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) for g, w in zip(outputs(got), outputs(want)))
        if len(outputs(got)) != len(outputs(want)) or not all(torch.equal(g, w) for g, w in zip(outputs(got), outputs(want))):
            fail(f"kernel {name} differs from its plain version {where} (max abs err {err})")
        return err

    def timed_inputs(name, structs):
        """Operands at the main path's shape: for the precompute steps the
        run's own Jacobian G2 points and, as bases, the affine points of the
        neighbouring lanes; seeded field elements for the rest."""
        if name in ("double_step", "madd_step"):
            r = torch.stack(q)  # (3, 2, 16, B)
            base = torch.roll(torch.stack(curve.to_affine(g2s, q)), 1, dims=-1)  # (2, 2, 16, B)
            return [r, base][: len(structs)]
        return [rand_field(rng, st, B_MAIN, P.Q, specials=False) for st in structs]

    rng = np.random.default_rng(2024)
    kernel_rows = []
    for name, (source, replaces, structs, _, adds) in KERNEL_TABLE.items():
        kernel, plain = wrappers[name]
        max_err = 0
        calls = 0
        build.reset_counts()
        # (a) ragged batch with edge values, lead 3; both moduli where the
        #     kernel takes one
        moduli = (P.Q, P.R_SCALAR) if name in BOTH_MODULI else (P.Q,)
        unit_structs = [tuple(st[1:]) if name == "fq2_mul" else tuple(st) for st in structs]
        batches = (B_RAGGED, B_STRADDLE) if name in TEAM_KERNELS else (B_RAGGED,)
        for modulus, batch in ((mod_, b_) for mod_ in moduli for b_ in batches):
            for static in statics(name, modulus):
                ins = [rand_field(rng, (3,) + st, batch, modulus, specials=True) for st in unit_structs]
                got = kernel(ins, modulus, static)
                torch.cuda.synchronize()
                calls += 1
                where = f"at B={batch}, modulus {modulus:#x}, static argument {static}"
                max_err = max(max_err, compare(name, got, plain(ins, modulus, static), where))
                if name == "pow_fixed":  # lanes 0, 1, m-1 (and the next) against Python's pow
                    lanes = P.limbs_to_ints(got[0, :, :4].cpu().numpy())
                    vals = [P.from_mont(v, modulus) for v in P.limbs_to_ints(ins[0][0, :, :4].cpu().numpy())]
                    if vals[0] != 0 or lanes != [P.to_mont(pow(v, static, modulus), modulus) for v in vals]:
                        fail(f"pow_fixed differs from Python's pow, modulus {modulus:#x}, exponent {static:#x}")
        # (a2) the edge pairs of the carry chains, one lane a pair; the Fq
        #      kernels also against Python's integers
        for modulus in moduli if name in EDGE_KERNELS else ():
            pairs = edge_pairs(modulus, P.R_MONT)
            xs, ys = [x for x, _ in pairs], [y for _, y in pairs]
            if name == "fq2_mul":  # (x, y) (y, x) and (x, x) (y, y)
                ins = [limbs_on_card([[*xs, *xs], [*ys, *xs]]), limbs_on_card([[*ys, *ys], [*xs, *ys]])]
            elif name in ("fq2_sq", "fq2_xi"):  # the Fq2 x + y u
                ins = [limbs_on_card([xs, ys])]
            else:
                ins = [limbs_on_card(xs), limbs_on_card(ys)][: len(structs)]
            got = kernel(ins, modulus, None)
            torch.cuda.synchronize()
            calls += 1
            max_err = max(max_err, compare(name, got, plain(ins, modulus, None),
                                           f"on {len(pairs)} edge pairs, modulus {modulus:#x}"))
            if name != "fq2_mul":
                r_inv = pow(P.R_MONT, -1, modulus)
                want = {"mont_mul": [lambda x, y: x * y * r_inv], "mod_add": [lambda x, y: x + y],
                        "mod_sub": [lambda x, y: x - y], "mod_neg": [lambda x, y: -x],
                        "fq2_sq": [lambda x, y: (x + y) * (x - y) * r_inv, lambda x, y: 2 * x * y * r_inv],
                        "fq2_xi": [lambda x, y: 9 * x - y, lambda x, y: x + 9 * y]}[name]
                coefficients = [got] if len(want) == 1 else list(got)
                if any(P.limbs_to_ints(c.cpu().numpy()) != [w(x, y) % modulus for x, y in pairs]
                       for c, w in zip(coefficients, want)):
                    fail(f"kernel {name} differs from Python's integers on the edge pairs, modulus {modulus:#x}")
        if build.COUNTS[name] != calls:
            fail(f"wrapper {name} counted {build.COUNTS[name]} launches for {calls} calls")
        # (b) the main path's shape at B = 8192
        static = {"pow_fixed": P.Q - 2, "fq12_cyclo_sq_chain": 2, "miller_step": True}.get(name)
        ins = timed_inputs(name, structs)
        got = kernel(ins, P.Q, static)
        want = plain(ins, P.Q, static)
        torch.cuda.synchronize()
        max_err = max(max_err, compare(name, got, want, "at the main path's shape"))
        if name == "miller_step":  # the other instance at the same shape
            max_err = max(max_err, compare(name, kernel(ins, P.Q, False), plain(ins, P.Q, False),
                                           "at the main path's shape, without the square"))
        ms = device_ms(lambda: kernel(ins, P.Q, static), 50)
        wrapper_ms = timed_ms(lambda: kernel(ins, P.Q, static), 50)  # eager: host time included
        plain_ms = timed_ms(lambda: plain(ins, P.Q, static), 3)
        # bound: bytes each operand and each result must move once, against the
        # multiply-adds (or word adds) the formula needs at the probed rate
        n_bytes = 4 * (sum(t.numel() for t in ins) + sum(t.numel() for t in outputs(got)))
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3

        def ops_ms(static):
            products = products_of(name, static)
            return B_MAIN * (products * MADDS_PER_PRODUCT if products else adds) / madd_per_s * 1e3

        row = {
            "name": name, "route": "cuda", "source": f"bn_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": None, "max_abs_err": max_err, "equal": True, "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms(static)), "bound_by": "bytes" if bytes_ms >= ops_ms(static) else "operations",
            "library_ms": None, "shape": [list(t.shape) for t in ins], "static": static, "bytes": n_bytes,
            "products_per_element": products_of(name, static),
            "registers": (ptxas[name] or {}).get("registers"),
            "spill_store_bytes": (ptxas[name] or {}).get("spill_store_bytes"),
            "spill_load_bytes": (ptxas[name] or {}).get("spill_load_bytes"),
            "stack_bytes": (ptxas[name] or {}).get("stack_bytes"),
        }
        if name in TEAM_KERNELS:  # the launch at this shape, from the loaded library
            dims = (ctypes.c_longlong * 3)()
            rows, batch = math.prod(ins[0].shape[:-(len(structs[0]) + 2)]), ins[0].shape[-1]
            if getattr(ctypes.CDLL(str(build.lib_path(source[:-3]))), f"bn_{name}_launch")(
                    ctypes.c_longlong(rows), ctypes.c_longlong(batch), dims) != 0:
                fail(f"cudaFuncGetAttributes refused k_{name}")
            row.update({
                "block_threads": dims[1],
                "elements_per_block": math.ceil(rows * batch / dims[0]),
                "shared_bytes_static": dims[2],
            })
        if source == "kernels_fq.cu":  # the floor of its grid: one element a thread in blocks of 128, or the team's
            elements = ins[0].numel() // P.NLIMBS // (2 if name.startswith("fq2_") else 1)
            grid = (dims[0], dims[1]) if name in TEAM_KERNELS else (math.ceil(elements / 128), 128)
            row["launch_floor_ms"] = launch_floor_ms(*grid)
            row["above_floor_plus_bound_ms"] = ms - row["launch_floor_ms"] - row["bound_ms"]
        if name == "fq2_sq":  # the team at every width, against the plain version, and timed
            row["widths"] = {}
            for lanes in FQ2_SQ_WIDTHS:  # above the main path's width, its lanes repeated
                x = rand_field(rng, (2,), min(lanes, B_MAIN), P.Q, specials=True)
                x = x.repeat(1, 1, -(-lanes // x.shape[-1]))[..., :lanes].contiguous()
                want_x = plain([x], P.Q, None)
                width_bytes = 2 * 4 * x.numel()
                max_err = max(max_err, compare(name, kernel([x], P.Q, None), want_x, f"at B={lanes}"))
                row["widths"][lanes] = {"ms": device_ms(lambda: kernel([x], P.Q, None), 50), "bound_ms": max(
                    width_bytes / HBM_BYTES_PER_S * 1e3, lanes * 2 * MADDS_PER_PRODUCT / madd_per_s * 1e3)}
            del x, want_x  # 268 MB at 2^20 lanes: not held while the main path's peak memory is read
            row["max_abs_err"] = max_err
        if name == "fq12_mul":  # the fold's width and the benchmark's, against the plain version
            row["lazy_madds_per_element"] = FQ12_MUL_LAZY_MADDS
            row["widths"] = {}
            for lanes in FQ12_MUL_WIDTHS:
                xs = [rand_field(rng, st, lanes, P.Q, specials=True) for st in structs]
                max_err = max(max_err, compare(name, kernel(xs, P.Q, None), plain(xs, P.Q, None), f"at B={lanes}"))
                if lanes > B_MAIN:
                    width_bytes = 3 * 4 * xs[0].numel()
                    row["widths"][lanes] = {"ms": device_ms(lambda: kernel(xs, P.Q, None), 50), "bound_ms": max(
                        width_bytes / HBM_BYTES_PER_S * 1e3, lanes * 54 * MADDS_PER_PRODUCT / madd_per_s * 1e3)}
            del xs
            row["max_abs_err"] = max_err
        if name == "fq12_cyclo_sq_chain":  # the shortest and the longest run of the main path too
            for n in (1, 5):
                row[f"ms_n{n}"] = device_ms(lambda n=n: kernel(ins, P.Q, n), 50)
                row[f"bound_ms_n{n}"] = max(bytes_ms, ops_ms(n))
        if name == "miller_step":  # the instance of the addition steps
            row.update({
                "ms_no_sq": device_ms(lambda: kernel(ins, P.Q, False), 50),
                "wrapper_ms_no_sq": timed_ms(lambda: kernel(ins, P.Q, False), 50),
                "plain_ms_no_sq": timed_ms(lambda: plain(ins, P.Q, False), 3),
                "bound_ms_no_sq": max(bytes_ms, ops_ms(False)),
                "bound_by_no_sq": "bytes" if bytes_ms >= ops_ms(False) else "operations",
                "products_per_element_no_sq": products_of(name, False),
                **{k + "_no_sq": (ptxas["miller_step_no_sq"] or {}).get(k)
                   for k in ("registers", "spill_store_bytes", "spill_load_bytes", "stack_bytes")},
            })
        kernel_rows.append(row)

    # mod_signed_sum: each of the main path's levels, its sources read and its
    # results written in place, against the plain signed sum
    def sum_level(name, lead, batch, modulus, specials):
        """(terms, sources, make_out) of a main-path level on the card, the
        operands laid out as its caller lays them out; make_out() gives (the
        out argument, the outputs as read back), both None for a new result."""
        def fe(*struct):
            return rand_field(rng, tuple(lead) + struct, batch, modulus, specials)

        def fresh(shape, axis):
            """A new destination, its outputs the slices along `axis`."""
            def make():
                t = torch.full(shape, -1, dtype=torch.int32, device=dev).movedim(axis, 0)
                return t, list(t)
            return make

        none = lambda: (None, None)  # noqa: E731
        if name in ("fq12_conj", "fq2_conj_fq12", "fq2_conj"):
            a = fe(2, 3, 2) if name != "fq2_conj" else fe(2)
            axis = -5 if name == "fq12_conj" else -3
            return tower.CONJ, [a.select(axis, 0), a.select(axis, 1)], fresh(a.shape, axis)
        if name.startswith("fq6_mul_operands"):
            a, b = fe(3, 2), (rand_field(rng, (1, 3, 2), batch, modulus, specials) if name.endswith("broadcast") else fe(3, 2))
            return tc.FQ6_MUL_OPERANDS, [a[..., i, :, :, :] for i in range(3)] + [b[..., i, :, :, :] for i in range(3)], none

        def packed():
            """A new packed Fq6 (*lead, 3, 2, 16, batch), its Fq2 coefficients the outputs."""
            return fresh(tuple(lead) + (3, 2, 16, batch), -4)

        if name == "fq6_mul_results":  # the six products aa bb cc t12 t01 t02 into the packed result
            return tc.FQ6_MUL_RESULTS, list(rand_field(rng, (6,) + tuple(lead) + (2,), batch, modulus, specials)), packed()
        if name == "fq6_inv_operands":
            a = fe(3, 2)
            return tower.FQ6_INV_OPERANDS, [a[..., i, :, :, :] for i in range(3)], none
        if name == "fq6_inv_norm_factors":
            return tower.FQ6_INV_NORM_FACTORS, list(rand_field(rng, (6,) + tuple(lead) + (2,), batch, modulus, specials)), none
        if name == "fq6_inv_norm":
            return tower.FQ6_INV_NORM, list(rand_field(rng, (3,) + tuple(lead) + (2,), batch, modulus, specials)), none
        if name == "fq6_sub_nonresidue":
            p2 = rand_field(rng, (2,) + tuple(lead) + (3, 2), batch, modulus, specials)
            return tower.FQ6_SUB_NONRESIDUE, [p2[k, ..., i, :, :, :] for k in range(2) for i in range(3)], packed()
        if name.startswith("mul_by_q_conj"):
            x, y = fe(2), fe(2)

            def make():
                conj = torch.full((2,) + tuple(lead) + (2, 16, batch), -1, dtype=torch.int32, device=dev)
                outs = [conj[k][..., c, :, :] for k in range(2) for c in range(2)]
                return outs, outs
            terms = ate.CONJ_X_NEG_Y if name.endswith("negated") else ate.CONJ_XY
            return terms, [x[..., 0, :, :], x[..., 1, :, :], y[..., 0, :, :], y[..., 1, :, :]], make
        raise KeyError(name)

    def sum_call(terms, srcs, make, modulus, plain=False, fq2=False):
        """The outputs of one call of the level, kernel or plain version."""
        out, views = make()
        fn = mc.mod_signed_sum_plain if plain else mc.mod_signed_sum
        res = fn(terms, srcs, modulus, out=out, fq2=fq2)
        return tuple(views if views is not None else res)

    def unique_elements(t):
        return math.prod(n for n, st in zip(t.shape, t.stride()) if st != 0)

    def signed_sum_row():
        """The mod_signed_sum checks and timings; its kernels line row.  The
        levels' tensors at B = 8192 are freed on return, before the main path
        runs and its peak memory is read."""
        build.reset_counts()
        sum_calls, sum_err, sum_patterns, timed_levels = 0, 0, {}, {}
        for name, main_lead in SUM_LEVELS.items():
            # (a) a ragged batch with the edge values at lead 3, both moduli
            for modulus in (P.Q, P.R_SCALAR):
                terms, srcs, make = sum_level(name, (3,), B_RAGGED, modulus, specials=True)
                fq2 = any(len(term) == 3 for out_terms in terms for term in out_terms)  # a xi term: an Fq2 level
                got = sum_call(terms, srcs, make, modulus, fq2=fq2)
                torch.cuda.synchronize()
                sum_calls += 1
                sum_err = max(sum_err, compare("mod_signed_sum", got, sum_call(terms, srcs, make, modulus, True, fq2),
                                               f"on level {name} at B={B_RAGGED}, lead 3, modulus {modulus:#x}"))
            # (b) the main path's shape at B = 8192 (timed below)
            terms, srcs, make = sum_level(name, main_lead, B_MAIN, P.Q, specials=False)
            got = sum_call(terms, srcs, make, P.Q, fq2=fq2)
            torch.cuda.synchronize()
            sum_calls += 1
            sum_err = max(sum_err, compare("mod_signed_sum", got, sum_call(terms, srcs, make, P.Q, True, fq2),
                                           f"on level {name} at the main path's shape"))
            timed_levels[name] = (terms, srcs, make, got, fq2)
        # (c) the carry and borrow edge pairs as the halves of a lead-3 Fq12, both
        #     moduli, against the plain version and Python's integers
        for modulus in (P.Q, P.R_SCALAR):
            pairs = list(edge_pairs(modulus, P.R_MONT))
            lanes = -(-len(pairs) // 18)
            pairs += [(0, 0)] * (18 * lanes - len(pairs))
            halves = [np.moveaxis(P.ints_to_limbs([pr[h] for pr in pairs]).reshape(16, 3, 3, 2, lanes), 0, -2)
                      for h in range(2)]
            a = torch.from_numpy(np.ascontiguousarray(np.stack(halves, axis=1).astype(np.int32))).to(dev)
            srcs = [a.select(-5, 0), a.select(-5, 1)]

            def make_edge(shape=a.shape):
                outs = [torch.full(shape, -1, dtype=torch.int32, device=dev) for _ in range(2)]
                views = [o.select(-5, h) for o in outs for h in range(2)]
                return views, views
            got = sum_call(EDGE_SUM_TERMS, srcs, make_edge, modulus)
            torch.cuda.synchronize()
            sum_calls += 1
            sum_err = max(sum_err, compare("mod_signed_sum", got, sum_call(EDGE_SUM_TERMS, srcs, make_edge, modulus, plain=True),
                                           f"on {len(pairs)} edge pairs, modulus {modulus:#x}"))
            for k, value in enumerate(EDGE_SUM_VALUES):
                lanes_k = np.moveaxis(got[k].cpu().numpy(), -2, 0).reshape(16, -1)
                if P.limbs_to_ints(lanes_k) != [value(x, y) % modulus for x, y in pairs]:
                    fail(f"mod_signed_sum differs from Python's integers on the edge pairs, output {k}, modulus {modulus:#x}")
            # the same pairs fed to xi: s0 = (x, y) and s1 = (y, x), the halves
            # as an Fq2's coefficients (sources read through a copy)
            xi = mc.XI
            xi_terms = (((0, 1, xi),), ((0, -1, xi),), ((0, 1, xi), (1, -1, xi)), ((1, 1), (0, -1, xi), (1, 1, xi), (0, 1)))
            xi_srcs = [a.movedim(-5, -3), a.flip(-5).movedim(-5, -3)]
            got = sum_call(xi_terms, xi_srcs, lambda: (None, None), modulus, fq2=True)
            torch.cuda.synchronize()
            sum_calls += 1
            sum_err = max(sum_err, compare("mod_signed_sum", got, sum_call(xi_terms, xi_srcs, lambda: (None, None), modulus, True, True),
                                           f"on {len(pairs)} edge pairs fed to xi, modulus {modulus:#x}"))
            for k, values in enumerate(XI_EDGE_SUM_VALUES):
                for c, value in enumerate(values):
                    lanes_k = np.moveaxis(got[k].select(-3, c).cpu().numpy(), -2, 0).reshape(16, -1)
                    if P.limbs_to_ints(lanes_k) != [value(x, y) % modulus for x, y in pairs]:
                        fail(f"mod_signed_sum differs from Python's integers on the edge pairs fed to xi, output {k}, "
                             f"coefficient {c}, modulus {modulus:#x}")
        if build.COUNTS["mod_signed_sum"] != sum_calls:
            fail(f"wrapper mod_signed_sum counted {build.COUNTS['mod_signed_sum']} launches for {sum_calls} calls")
        # each level at the main path's shape: card time, eager time, plain time, bound
        for name, (terms, srcs, make, got, fq2) in timed_levels.items():
            read = {term[0] for out_terms in terms for term in out_terms}
            n_bytes = 4 * (sum(unique_elements(srcs[i]) for i in read) + sum(t.numel() for t in got))
            bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            # add or subtract, then reduce, a word each; a product by xi 10 such sums
            word_ops = sum(10 if len(term) == 3 else 1 for t in terms for term in t) * 16 * got[0].numel() // P.NLIMBS
            ops_ms = word_ops / madd_per_s * 1e3
            out_arg, _ = make()
            sum_patterns[name] = {
                "form": "fq2" if fq2 else "base field",
                "outputs": len(terms), "terms": sum(len(t) for t in terms),
                "xi_terms": sum(len(term) == 3 for t in terms for term in t), "sources": len(srcs),
                "source_shape": list(srcs[0].shape), "lead": list(SUM_LEVELS[name]),
                "ms": device_ms(lambda: mc.mod_signed_sum(terms, srcs, P.Q, out=out_arg, fq2=fq2), 50),
                "wrapper_ms": timed_ms(lambda: mc.mod_signed_sum(terms, srcs, P.Q, out=out_arg, fq2=fq2), 50),
                "plain_ms": timed_ms(lambda: sum_call(terms, srcs, make, P.Q, True, fq2), 3),
                "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": n_bytes, "launch_floor_ms": launch_floor_ms(
                    len(terms) * math.prod(srcs[0].shape[:-3 if fq2 else -2]) * math.ceil(B_MAIN / 128)),
            }
        headline = sum_patterns[SUM_ROW_LEVEL]
        return {
            "name": "mod_signed_sum", "route": "cuda", "source": "bn_tpu_torch/csrc/kernels_fq.cu",
            "replaces": "bn_tpu/ops/mont_pallas.py:375 (mod_sub_pallas), :379 (mod_neg_pallas) and :394 (fq2_xi_pallas), a level at a time",
            "launches": None, "max_abs_err": sum_err, "equal": True,
            **{k: headline[k] for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by", "bytes", "launch_floor_ms")},
            "library_ms": None, "shape": headline["source_shape"], "static": SUM_ROW_LEVEL, "levels": sum_patterns,
            **{k: (ptxas["mod_signed_sum"] or {}).get(k) for k in ("registers", "spill_store_bytes", "spill_load_bytes", "stack_bytes")},
            **{k + "_fq2": (ptxas["mod_signed_sum_fq2"] or {}).get(k)
               for k in ("registers", "spill_store_bytes", "spill_load_bytes", "stack_bytes")},
        }

    kernel_rows.append(signed_sum_row())

    # the two curve kernels, G1 and G2: coordinates are separate tensors, and
    # the batch must hold the degenerate pairs of the group law
    def with_degenerate_lanes(spec, pp, qq):
        """Overwrite the first six and the last six lanes of every row with
        P + inf, inf + Q, inf + inf, P + P, P + (-P), and one point under two
        different z (14 G by the ladder against 2 * (7 G))."""
        F, gen, gmul = (O.FQ_OPS, O.G1_ONE, O.g1_mul) if spec.name == "G1" else (O.FQ2_OPS, O.G2_ONE, O.g2_mul)
        a, b, inf = gmul(gen, 7), gmul(gen, 11), O.g_zero(F)
        lhs = curve.to_device(spec, [a, inf, inf, a, a, gmul(gen, 14)])
        rhs = curve.to_device(spec, [inf, b, inf, a, O.g_neg(F, a), O.g_double(F, a)])
        for coords, special in ((pp, lhs), (qq, rhs)):
            for t, sp in zip(coords, special):
                t[..., :6] = sp
                t[..., -6:] = sp
        return pp, qq

    def ragged_points(spec, seed):
        """Two batches of 3 x B_RAGGED multiples of the generator (Jacobian,
        z != 1) as coordinates (3, [2,] 16, B_RAGGED), degenerate lanes in."""
        rng_c = np.random.default_rng(seed)
        n = 3 * B_RAGGED
        out = []
        for _ in range(2):
            ks = [int.from_bytes(rng_c.bytes(40), "big") % P.R_SCALAR or 1 for _ in range(n)]
            flat = curve.mul(spec, curve.one(spec, (n,)), fp.to_device(fp.FR, ks))
            out.append(tuple(torch.movedim(t.reshape(t.shape[:-1] + (3, B_RAGGED)), -2, 0).contiguous() for t in flat))
        return with_degenerate_lanes(spec, *out)

    def curve_call(name, group, pp, qq, plain=False, design=None):
        if plain:
            fn = getattr(cc, name + "_plain")
            return fn(group, pp, qq) if name == "point_add" else fn(group, pp)
        fn = getattr(cc, name)
        with cc.forced_design(design) if design else contextlib.nullcontext():
            return fn(group, pp, qq) if name == "point_add" else fn(group, pp)

    def curve_timing(name, group, pp, qq, plain_lanes=None, design=None):
        """Card time, eager time, plain time and bound of one call at the
        shape of pp, of `design` (None: the wrapper's pick); the result must
        equal the plain version's.  At the MSM's width the plain version
        (int64 partial products) runs on the first `plain_lanes` lanes only,
        and its time is for those."""
        got = curve_call(name, group, pp, qq, design=design)
        cut = slice(None, plain_lanes)
        pl, ql = (tuple(t[..., cut] for t in pt) for pt in (pp, qq))
        want = curve_call(name, group, pl, ql, plain=True)
        torch.cuda.synchronize()
        err = compare(name, tuple(t[..., cut] for t in got), want,
                      f"for {group} at B={pp[0].shape[-1]}, design {design or 'picked'}")
        ins = pp + qq if name == "point_add" else pp
        n_bytes = 4 * (sum(t.numel() for t in ins) + sum(t.numel() for t in got))
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        products = CURVE_KERNELS[name][1 if group == "G1" else 2]
        ops_ms = pp[0].shape[-1] * products * MADDS_PER_PRODUCT / madd_per_s * 1e3
        return err, {
            "ms": device_ms(lambda: curve_call(name, group, pp, qq, design=design), 50),
            "wrapper_ms": timed_ms(lambda: curve_call(name, group, pp, qq, design=design), 50),
            "plain_ms": timed_ms(lambda: curve_call(name, group, pl, ql, plain=True), 3),
            "plain_lanes": pl[0].shape[-1],
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "shape": [list(t.shape) for t in ins], "bytes": n_bytes, "products_per_element": products,
        }

    curve_lib = ctypes.CDLL(str(build.lib_path("kernels_curve")))

    def curve_build(name, group, design, lanes):
        """The launch of `design` for `lanes` points (bn_point_launch: blocks,
        threads, shared bytes) and what ptxas said."""
        out = (ctypes.c_longlong * 3)()
        if curve_lib.bn_point_launch(int(name == "point_add"), int(group == "G2"), cc.DESIGNS.index(design),
                                     ctypes.c_longlong(1), ctypes.c_longlong(lanes), out) != 0:
            fail(f"cudaFuncGetAttributes refused the {design} design of {name} for {group}")
        key = name + ("_team" if design == "team" else "") + ("_g2" if group == "G2" else "")
        return {"blocks": out[0], "block_threads": out[1], "shared_bytes": out[2],
                **{k: (ptxas[key] or {}).get(k)
                   for k in ("registers", "spill_store_bytes", "spill_load_bytes", "stack_bytes")}}

    def neighbours(pt):
        """The same points one lane on: a generic second operand."""
        return tuple(torch.roll(t, 1, dims=-1) for t in pt)

    def degenerate_lanes_ok(spec, got):
        inf = curve.is_zero(spec, got)[0]
        return inf[:6].tolist() == [False, False, True, False, True, False] and inf[-6:].tolist() == inf[:6].tolist()

    for name, (replaces, _, _) in CURVE_KERNELS.items():
        max_err = 0
        designs = {d: {} for d in cc.DESIGNS}
        for spec, seed in ((g1s, 31), (g2s, 32)):
            pp, qq = ragged_points(spec, seed)
            build.reset_counts()
            got = curve_call(name, spec.name, pp, qq)
            torch.cuda.synchronize()
            picked = cc.design_for(name, 3 * B_RAGGED)
            if build.COUNTS[name] != 1 or build.INSTANCE_COUNTS[name, picked] != 1:
                fail(f"wrapper {name} counted {build.COUNTS[name]} launches for one call, "
                     f"{dict(build.INSTANCE_COUNTS)} by design")
            where = f"for {spec.name} at B={B_RAGGED}, lead 3, degenerate lanes in"
            max_err = max(max_err, compare(name, got, curve_call(name, spec.name, pp, qq, plain=True), where))
            if name == "point_add" and any(t.data_ptr() == o.data_ptr() for t in pp + qq for o in got):
                fail("point_add returned one of its operands")
            # each design, whatever the wrapper would pick: the ragged batch with
            # the degenerate lanes, blocks of 32 that straddle the rows, a batch
            # of one (the MSM's Horner combine gives it), and the main path's B
            straddle = tuple(tuple(t[..., :B_STRADDLE].contiguous() for t in pt) for pt in (pp, qq))
            one = tuple(tuple(t[0, ..., 7:8].contiguous() for t in pt) for pt in (pp, qq))
            for design in cc.DESIGNS:
                for what, (a, b) in ((where, (pp, qq)), (f"for {spec.name} at B={B_STRADDLE}, lead 3", straddle),
                                     (f"for {spec.name} at B=1", one)):
                    got_d = curve_call(name, spec.name, a, b, design=design)
                    max_err = max(max_err, compare(name, got_d, curve_call(name, spec.name, a, b, plain=True),
                                                   f"in the {design} design {what}"))
                    if name == "point_add" and a is pp and not degenerate_lanes_ok(spec, got_d):
                        fail(f"point_add ({design}) for {spec.name}: the degenerate lanes gave infinity at "
                             f"{curve.is_zero(spec, got_d)[0][:6].tolist()}")
                pt = p if spec.name == "G1" else q
                err, at_main = curve_timing(name, spec.name, pt, neighbours(pt), design=design)
                max_err = max(max_err, err)
                designs[design][spec.name] = {**at_main, **curve_build(name, spec.name, design, B_MAIN)}
        pick = cc.design_for(name, B_MAIN)
        main, g2 = designs[pick]["G1"], designs[pick]["G2"]
        row = {"name": name, "route": "cuda", "source": "bn_tpu_torch/csrc/kernels_curve.cu", "replaces": replaces,
               "launches": None, "max_abs_err": max_err, "equal": True,
               **{k: main[k] for k in ("ms", "wrapper_ms", "plain_ms", "plain_lanes", "bound_ms", "bound_by",
                                       "shape", "bytes", "products_per_element")},
               "library_ms": None, "static": "G1", "design": pick,
               **{k + "_g2": g2[k] for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by", "shape",
                                             "bytes", "products_per_element")},
               "registers": main["registers"], "spill_store_bytes": main["spill_store_bytes"],
               "spill_load_bytes": main["spill_load_bytes"], "stack_bytes": main["stack_bytes"],
               "registers_g2": g2["registers"], "spill_store_bytes_g2": g2["spill_store_bytes"],
               "designs": designs,
               "thread_from_lanes": cc.THREAD_FROM_LANES[name]}
        kernel_rows.append(row)
    emit({"phase": "kernels", "compared": [r["name"] for r in kernel_rows], "all_equal": True,
          "ragged_batch": B_RAGGED, "team_straddle_batch": B_STRADDLE, "tolerance": 0})

    # ---- phase 4: the main path, every fusion on ------------------------------
    if not (backend.pow_fixed and backend.cyclo_chain and backend.ladder) or backend.miller_step:
        fail("the fused path with the hoisted Miller loop is not the default")
    build.reset_counts()
    out = ate.pairing_batch(p, q)
    torch.cuda.synchronize()
    counts = dict(build.COUNTS)
    never = [k for k in PAIRING_KERNELS if counts[k] == 0]
    if never:
        fail(f"pairing_batch launched these kernels no time: {never}")
    if any(counts[k] for k in tuple(CURVE_KERNELS) + MILLER_KERNELS):
        fail(f"pairing_batch launched a curve kernel, fq12_mul024 or miller_step: {counts}")
    if {k: counts[k] for k in FUSED_KERNELS} != FUSED_KERNELS:
        fail(f"the fused path launched {({k: counts[k] for k in FUSED_KERNELS})}, expected {FUSED_KERNELS}")
    if {k: counts[k] for k in SUM_LAUNCHES} != SUM_LAUNCHES:
        fail(f"the fused path's sums launched {({k: counts[k] for k in SUM_LAUNCHES})}, expected {SUM_LAUNCHES}")
    if sum(counts.values()) != LAUNCHES_TOTAL["fused"]:
        fail(f"the fused path launched {sum(counts.values())} kernels, expected {LAUNCHES_TOTAL['fused']}: {counts}")

    if tuple(out.shape) != (2, 3, 2, 16, B) or out.dtype != torch.int32 or out.device.type != "cuda":
        fail(f"pairing_batch returned {tuple(out.shape)} {out.dtype} on {out.device}")
    if int(out.min()) < 0 or int(out.max()) > P.LIMB_MASK:
        fail("pairing_batch returned limbs outside [0, 65535]")
    sample = [0, 1, B // 2, B - 1]
    got = tower.fq12_from_device(out[..., sample])
    for j, i in enumerate(sample):
        expect = O.pairing(O.g1_mul(O.G1_ONE, ks1[i]), O.g2_mul(O.G2_ONE, ks2[i]))
        if got[j] != expect:
            fail(f"lane {i} differs from the oracle")
    special = tower.fq12_from_device(out[..., [lane_g1_inf, lane_g2_inf, lane_sp, lane_sq]])
    if special[0] != O.FQ12_ONE or special[1] != O.FQ12_ONE:
        fail("a lane with an infinite input did not give Gt one")
    if special[2] != special[3] or special[2] == O.FQ12_ONE:
        fail("bilinearity: e(sP, Q) != e(P, sQ)")
    emit({"phase": "main_path", "configuration": "fused", "batch": B, "launches": counts,
          "launches_total": sum(counts.values()), "sum_launches": sum(counts[k] for k in SUM_LAUNCHES),
          "oracle_lanes": sample,
          "infinity_lanes": [lane_g1_inf, lane_g2_inf], "bilinearity_lanes": [lane_sp, lane_sq]})

    # ---- phase 5: the unfused path on the first lanes of the same inputs ------
    ps = tuple(t[..., :B_UNFUSED].contiguous() for t in p)
    qs = tuple(t[..., :B_UNFUSED].contiguous() for t in q)
    build.reset_counts()
    with backend.fusions(**UNFUSED):
        out_unfused = ate.pairing_batch(ps, qs)
    torch.cuda.synchronize()
    counts_unfused = dict(build.COUNTS)
    wrong = [k for k in PAIRING_KERNELS + SUM_SINGLE_OPS if (counts_unfused[k] != 0) == (k in FUSED_KERNELS)]
    wrong += [k for k in tuple(CURVE_KERNELS) + MILLER_KERNELS if counts_unfused[k]]
    if wrong or sum(counts_unfused.values()) != LAUNCHES_TOTAL["unfused"]:
        fail(f"the unfused path's launches of {wrong} are not as expected, or not {LAUNCHES_TOTAL['unfused']} in all: "
             f"{counts_unfused}")
    if not torch.equal(out_unfused, out[..., :B_UNFUSED]):
        fail("the unfused path differs from the fused path on the same lanes")
    qa = curve.to_affine(g2s, qs)
    coeffs_fused = ate.precompute(qa)
    with backend.fusions(ladder=False):
        coeffs_unfused = ate.precompute(qa)
    if tuple(coeffs_fused.shape) != (102, 3, 2, 16, B_UNFUSED) or not torch.equal(coeffs_fused, coeffs_unfused):
        fail("the fused precompute differs from the unfused one")
    emit({"phase": "unfused_path", "batch": B_UNFUSED, "launches": counts_unfused,
          "launches_total": sum(counts_unfused.values()),
          "sum_launches": sum(counts_unfused[k] for k in SUM_LAUNCHES), "equals_fused_lanes": True,
          "precompute_equals_fused": True})

    # ---- phase 6: both paths timed in turns -----------------------------------
    def pairing_ms():
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        again = ate.pairing_batch(p, q)
        t1.record()
        torch.cuda.synchronize()
        if not torch.equal(again, out):
            fail("pairing_batch is not deterministic, or the two paths differ at the full batch")
        return t0.elapsed_time(t1)

    torch.cuda.reset_peak_memory_stats()
    times = {"fused": [], "unfused": []}
    for _ in range(3):
        times["fused"].append(pairing_ms())
        with backend.fusions(**UNFUSED):
            times["unfused"].append(pairing_ms())
    medians = {k: statistics.median(v) for k, v in times.items()}
    emit({"phase": "timing", "batch": B, "pairing_batch_ms": medians, "pairing_batch_ms_runs": times,
          "pairings_per_s": {k: B / (v * 1e-3) for k, v in medians.items()},
          "peak_memory_bytes": torch.cuda.max_memory_allocated(), "card": smi})

    # ---- phase 6b: the Miller-step configuration on the same inputs ----------
    build.reset_counts()
    with backend.fusions(miller_step=True):
        out_miller = ate.pairing_batch(p, q)
    torch.cuda.synchronize()
    counts_miller = dict(build.COUNTS)
    instances = {inst: build.INSTANCE_COUNTS["miller_step", inst] for inst in MILLER_STEPS}
    if counts_miller["miller_step"] != 102 or instances != MILLER_STEPS:
        fail(f"the Miller-step path launched miller_step {counts_miller['miller_step']} times, {instances}")
    if counts_miller["fq12_sq"] or counts_miller["fq12_mul024_pre"] or counts_miller["fq12_mul024"]:
        fail(f"the Miller-step path launched the hoisted loop's kernels: {counts_miller}")
    if not torch.equal(out_miller, out):
        fail("the Miller-step path differs from the main path's result")
    if sum(counts_miller.values()) != LAUNCHES_TOTAL["miller_step"] or counts_miller["fq2_xi"]:
        fail(f"the Miller-step path launched {sum(counts_miller.values())} kernels, expected "
             f"{LAUNCHES_TOTAL['miller_step']}, none of them fq2_xi: {counts_miller}")

    def event_ms(fn):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        res = fn()
        t1.record()
        torch.cuda.synchronize()
        return res, t0.elapsed_time(t1)

    pa, qa_full = curve.to_affine(g1s, p), curve.to_affine(g2s, q)
    coeffs = ate.precompute(qa_full)
    f_hoisted = ate.miller_loop(coeffs, pa)
    miller_times = {"hoisted": {"pairing_batch": [], "miller_loop": []},
                    "miller_step": {"pairing_batch": [], "miller_loop": []}}
    for _ in range(3):
        for config, on in (("hoisted", False), ("miller_step", True)):
            with backend.fusions(miller_step=on):
                again, ms_pair = event_ms(lambda: ate.pairing_batch(p, q))
                f_loop, ms_loop = event_ms(lambda: ate.miller_loop(coeffs, pa))
            if not (torch.equal(again, out) and torch.equal(f_loop, f_hoisted)):
                fail(f"the {config} configuration is not deterministic, or the two differ")
            miller_times[config]["pairing_batch"].append(ms_pair)
            miller_times[config]["miller_loop"].append(ms_loop)
    # the sparse multiply by an unscaled line, on the run's own coefficients
    # and points: one fq12_mul024 launch, the same limbs as fq12_mul024_pre on
    # the scaled line and as miller_step without the square
    k_line = 3
    vw = tower.fq2_scale_fq(coeffs[k_line, 1], pa[1])
    vv = tower.fq2_scale_fq(coeffs[k_line, 2], pa[0])
    build.reset_counts()
    by_tower = tower.fq12_mul_by_024(out, coeffs[k_line, 0], coeffs[k_line, 1], coeffs[k_line, 2])
    torch.cuda.synchronize()
    counts_line = {k_: v for k_, v in build.COUNTS.items() if v}
    if counts_line != {"fq12_mul024": 1}:
        fail(f"tower.fq12_mul_by_024 launched {counts_line}")
    by_tower_scaled = tower.fq12_mul_by_024(out, coeffs[k_line, 0], vw, vv)
    pre = tc.fq12_mul024_pre(out, coeffs[k_line, 0], torch.stack([vw, vv]), P.Q)
    step = tc.miller_step(out, coeffs[k_line], pa[0], pa[1], False)
    if not (torch.equal(by_tower_scaled, pre) and torch.equal(by_tower_scaled, step)) or torch.equal(by_tower, pre):
        fail("tower.fq12_mul_by_024 on the scaled line differs from fq12_mul024_pre or miller_step")
    # the squarings against an independent formula: on a cyclotomic element,
    # the easy part of the final exponentiation, the Granger-Scott squaring
    # equals the general square (fq12_sq's Karatsuba team)
    conj_over = tower.fq12_mul(tower.fq12_conj(f_hoisted), tower.fq12_inv(f_hoisted))
    easy = tower.fq12_mul(tower.fq12_frob(conj_over, 2), conj_over)
    general = tc.fq12_sq(easy, P.Q)
    if torch.equal(general, easy):
        fail("the easy part of the final exponentiation is its own square: no check")
    for what, got_sq, want_sq in (("fq12_cyclo_sq", tc.fq12_cyclo_sq(easy, P.Q), general),
                                  ("fq12_cyclo_sq_chain at n = 1", tc.fq12_cyclo_sq_chain(easy, 1, P.Q), general),
                                  ("fq12_cyclo_sq_chain at n = 2", tc.fq12_cyclo_sq_chain(easy, 2, P.Q),
                                   tc.fq12_sq(general, P.Q))):
        if not torch.equal(got_sq, want_sq):
            fail(f"{what} differs from the fq12_sq team on the cyclotomic easy part")
    emit({"phase": "miller_path", "batch": B, "launches": counts_miller, "launches_total": sum(counts_miller.values()),
          "sum_launches": sum(counts_miller[k] for k in SUM_LAUNCHES),
          "miller_step_instances": instances, "equals_main_path_lanes": B,
          "ms_runs": miller_times,
          "ms": {c_: {k_: statistics.median(v) for k_, v in t_.items()} for c_, t_ in miller_times.items()},
          "fq12_mul_by_024_step": k_line, "fq12_mul_by_024_launches": counts_line,
          "cyclotomic_squarings_equal_fq12_sq": {"lanes": B, "fq12_cyclo_sq": True, "chain_n1": True, "chain_n2": True},
          "card": smi})

    def clock(fn):
        """(result, seconds) of fn() with the card's work included."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def ran(*names):
        return {k: build.COUNTS[k] for k in names}

    def same_limbs(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # ---- phase 7: curve.mul on the curve kernels against the per-field-op law --
    curve_path = {"phase": "curve_path", "lanes_compared": B_CURVE_CHECK, "batch_timed": B, "card": smi}
    for spec, pt, k in ((g1s, p, k1), (g2s, q, k2)):
        base = curve.one(spec, (B_CURVE_CHECK,))
        ksmall = k[..., :B_CURVE_CHECK].contiguous()
        build.reset_counts()
        on = curve.mul(spec, base, ksmall)
        torch.cuda.synchronize()
        counts_on = {k_: v for k_, v in build.COUNTS.items() if v}
        designs_on = {f"{k_}/{d_}": v for (k_, d_), v in build.INSTANCE_COUNTS.items()}
        if counts_on != {"mont_mul": 1, "point_double": 256, "point_add": 256}:
            fail(f"curve.mul for {spec.name} on the curve kernels launched {counts_on}")
        build.reset_counts()
        with backend.fusions(curve_kernels=False):
            off = curve.mul(spec, base, ksmall)
        torch.cuda.synchronize()
        counts_off = {k_: v for k_, v in build.COUNTS.items() if v}
        if any(counts_off.get(k_) for k_ in CURVE_KERNELS) or not counts_off.get("mod_add"):
            fail(f"curve.mul for {spec.name} with curve_kernels off launched {counts_off}")
        if not same_limbs(on, off) or not same_limbs(on, tuple(t[..., :B_CURVE_CHECK] for t in pt)):
            fail(f"curve.mul for {spec.name}: the two paths, or two runs, give different limbs")
        times = {"on": [], "off": []}
        full = curve.one(spec, (B,))
        for _ in range(2):
            times["on"].append(clock(lambda: curve.mul(spec, full, k))[1] * 1e3)
            with backend.fusions(curve_kernels=False):
                times["off"].append(clock(lambda: curve.mul(spec, full, k))[1] * 1e3)
        curve_path[spec.name] = {"launches_on": counts_on, "launches_on_by_design": designs_on,
                                 "launches_off": counts_off,
                                 "launches_off_total": sum(counts_off.values()), "equal_limbs": True,
                                 "mul_ms_runs": times, "mul_ms": {k_: min(v) for k_, v in times.items()}}
    emit(curve_path)

    # ---- phase 8: the API at B = 8192 ------------------------------------------
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples"))
    import dh_torch
    import joux_torch

    steps = {}

    def step(name, fn):
        res, steps[name] = clock(fn)
        return res

    build.reset_counts()
    ap = step("G1.random", lambda: G1.random(101, B))
    aq = step("G2.random", lambda: G2.random(202, B))
    sc = step("Fr.random", lambda: Fr.random(303, B))
    if ran("point_double", "point_add") != {"point_double": 512, "point_add": 512}:
        fail(f"G1.random and G2.random launched {ran('point_double', 'point_add')}")
    sc_bytes = step("Fr.to_bytes", sc.to_bytes)
    if not (step("Fr.from_bytes", lambda: Fr.from_bytes(sc_bytes)) == sc):
        fail("Fr bytes do not round-trip")
    ap_bytes = step("G1.to_bytes", ap.to_bytes)
    if not (step("G1.from_bytes", lambda: G1.from_bytes(ap_bytes)) == ap):
        fail("G1 bytes do not round-trip")
    aq_bytes = step("G2.to_bytes", aq.to_bytes)
    build.reset_counts()
    if not (step("G2.from_bytes", lambda: G2.from_bytes(aq_bytes)) == aq):
        fail("G2 bytes do not round-trip")
    if ran("point_double", "point_add") != {"point_double": 256, "point_add": 257}:
        fail(f"the G2 decode's subgroup check launched {ran('point_double', 'point_add')}")
    if len(sc_bytes[0]) != 32 or len(ap_bytes[0]) != 65 or len(aq_bytes[0]) != 129:
        fail("wrong encoding lengths")

    # an on-curve point of the twist outside the r-order subgroup
    outside = None
    for i in range(1, 200):
        x = (i, 1)
        rhs = O.fq2_add(O.fq2_mul(O.fq2_sq(x), x), O.twist_b())
        y = O.fq2_sqrt(rhs)
        if y is not None and not O.g2_in_subgroup((x, y)):
            outside = (x, y)
            break
    if outside is None or not O.g2_on_curve(outside):
        fail("no on-curve point outside the subgroup found")
    bad_index = B // 2 + 1

    def refused(fn, needle=""):
        try:
            fn()
        except S.DecodeError as exc:
            return needle in str(exc)
        return False

    bad = list(aq_bytes)
    bad[bad_index] = bytes([4]) + S.encode_fq2(outside[0]) + S.encode_fq2(outside[1])
    if not step("G2.from_bytes, one point outside the subgroup", lambda: refused(lambda: G2.from_bytes(bad), f"batch index {bad_index})")):
        fail("a G2 batch with a point outside the subgroup was not refused with its index")
    off_curve_g2 = bytes([4]) + S.encode_fq2((0, 0)) + S.encode_fq2((1, 1))
    off_curve_g1 = bytes([4]) + (0).to_bytes(32, "big") + (1).to_bytes(32, "big")
    too_large_g1 = bytes([4]) + P.Q.to_bytes(32, "big") + (2).to_bytes(32, "big")
    too_large_g2 = bytes([4]) + (P.Q * P.Q).to_bytes(64, "big") + S.encode_fq2((1, 1))
    for what, fn in (("off-curve G2", lambda: G2.from_bytes(aq_bytes[:3] + [off_curve_g2])),
                     ("off-curve G1", lambda: G1.from_bytes(ap_bytes[:3] + [off_curve_g1])),
                     ("G1 coordinate >= q", lambda: G1.from_bytes([too_large_g1])),
                     ("G2 coordinate >= q^2", lambda: G2.from_bytes([too_large_g2])),
                     ("Fr >= r", lambda: Fr.from_bytes([P.R_SCALAR.to_bytes(32, "big")]))):
        if not refused(fn):
            fail(f"{what} was not refused")

    ps = step("G1 * Fr", lambda: ap * sc)
    qs = step("G2 * Fr", lambda: aq * sc)
    e_a = step("pairing(p*s, q)", lambda: pairing(ps, aq))
    e_b = step("pairing(p, q*s)", lambda: pairing(ap, qs))
    e_pq = step("pairing(p, q)", lambda: pairing(ap, aq))
    build.reset_counts()
    e_c = step("Gt.pow", lambda: e_pq.pow(sc))
    if ran("fq12_sq", "fq12_mul") != {"fq12_sq": 256, "fq12_mul": 256}:
        fail(f"Gt.pow launched {ran('fq12_sq', 'fq12_mul')}")
    if not (e_a == e_b and e_b == e_c) or e_a == Gt.one(B):
        fail("bilinearity through the API: pairing(p*s, q), pairing(p, q*s), pairing(p, q)^s differ, or are one")
    if not (step("Gt * Gt.inverse", lambda: e_a * e_a.inverse()) == Gt.one(B)):
        fail("a * a.inverse() is not Gt one")
    # sample lanes against the oracle: the scalars are those of the seeds
    kp, kq, ksc = (Fr.random(seed, B, "cpu").to_ints() for seed in (101, 202, 303))
    api_lanes = [0, B - 1]
    for lane in api_lanes:
        o_p, o_q = O.g1_mul(O.G1_ONE, kp[lane]), O.g2_mul(O.G2_ONE, kq[lane])
        lane_ps = curve.from_device(g1s, tuple(t[..., lane:lane + 1] for t in ps.dev))[0]
        if not O.g_eq(O.FQ_OPS, lane_ps, O.g1_mul(o_p, ksc[lane])):
            fail(f"lane {lane} of p * s differs from the oracle")
        if tower.fq12_from_device(e_pq.dev[..., lane:lane + 1])[0] != O.pairing(o_p, o_q):
            fail(f"lane {lane} of pairing(p, q) differs from the oracle")
    if ap_bytes[0] != S.encode_g1(O.g1_mul(O.G1_ONE, kp[0])) or aq_bytes[-1] != S.encode_g2(O.g2_mul(O.G2_ONE, kq[-1])):
        fail("the encoded points differ from the oracle's")
    build.reset_counts()
    step("dh_torch.main", lambda: dh_torch.main(batch=B, seed=11))
    counts_dh = ran("point_double", "point_add")
    build.reset_counts()
    step("joux_torch.main", lambda: joux_torch.main(batch=B, seed=1))
    counts_joux = {k_: v for k_, v in build.COUNTS.items() if v}
    if counts_dh != {"point_double": 9 * 256, "point_add": 9 * 256}:
        fail(f"dh_torch.main launched {counts_dh}")
    emit({"phase": "api_path", "batch": B, "seconds": steps, "seconds_total": sum(steps.values()),
          "refused": ["G2 outside the subgroup (index named)", "off-curve G1 and G2", "coordinate >= q", "Fr >= r"],
          "oracle_lanes": api_lanes, "launches_dh": counts_dh, "launches_joux": counts_joux,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(), "card": smi})

    # ---- phase 9: the Pippenger MSM at 2^20 points ------------------------------
    n_msm = 1 << LOG2_MSM
    rng = np.random.default_rng(20260820)
    ks = [int.from_bytes(rng.bytes(40), "big") % P.R_SCALAR or 1 for _ in range(n_msm)]
    ss = [int.from_bytes(rng.bytes(40), "big") % P.R_SCALAR for _ in range(n_msm)]

    kdev, scalars_to_card_s = clock(lambda: fp.to_device(fp.FR, ks))  # Python ints to limbs, on the host

    def make_points():
        jac = curve.mul(g1s, curve.one(g1s, (n_msm,)), kdev)
        ax, ay = curve.to_affine(g1s, jac)
        z = fp.zeros(fp.FQ, (1,))  # the appended slot: index n means 'no point'
        return jac, (torch.cat([ax, z], dim=-1), torch.cat([ay, z], dim=-1),
                     torch.cat([fp.ones(fp.FQ, (n_msm,)), z], dim=-1))

    torch.cuda.reset_peak_memory_stats()
    (jac, (px, py, pz)), points_s = clock(make_points)
    points_peak = torch.cuda.max_memory_allocated()
    # the curve kernels at the MSM's width, on these points
    # (both designs; the row's _g1_2p20 keys are those of the wrapper's pick)
    for row in kernel_rows:
        if row["name"] in CURVE_KERNELS:
            for design in cc.DESIGNS:
                err, at_msm = curve_timing(row["name"], "G1", jac, neighbours(jac), plain_lanes=1 << 16, design=design)
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["designs"][design]["G1_2p20"] = {**at_msm, **curve_build(row["name"], "G1", design, n_msm)}
            row["design_g1_2p20"] = cc.design_for(row["name"], n_msm)
            row.update({k_ + "_g1_2p20": v for k_, v in row["designs"][row["design_g1_2p20"]]["G1_2p20"].items()})
    # every one of the 2^20 lanes against the plain version, in the shape the
    # MSM's shift-scans give the kernels: (w, 16, 2^c) with the windows in front;
    # the flat call must give the same lanes
    def windows_in_front(pt):
        return tuple(t.reshape(16, n_msm // (1 << MSM_C), 1 << MSM_C).transpose(0, 1).contiguous() for t in pt)

    jac_w, next_w = windows_in_front(jac), windows_in_front(neighbours(jac))
    for name in CURVE_KERNELS:
        got_w = curve_call(name, "G1", jac_w, next_w)
        compare(name, got_w, curve_call(name, "G1", jac_w, next_w, plain=True),
                f"at {tuple(jac_w[0].shape)}, all 2^{LOG2_MSM} lanes")
        compare(name, windows_in_front(curve_call(name, "G1", jac, neighbours(jac))), got_w,
                f"flat at B={n_msm} against the same lanes with the windows in front")
    del jac, jac_w, next_w, got_w
    # the point arrays themselves: an odd batch of 2^20 + 1 whose last lane is
    # the appended infinity; the ragged end against the plain version
    odd, odd_next = (px, py, pz), neighbours((px, py, pz))
    tail = slice(n_msm + 1 - 4096, None)
    for name in CURVE_KERNELS:
        compare(name, tuple(t[..., tail] for t in curve_call(name, "G1", odd, odd_next)),
                curve_call(name, "G1", tuple(t[..., tail] for t in odd), tuple(t[..., tail] for t in odd_next), plain=True),
                f"at B={n_msm + 1}, the ragged end")
    del odd, odd_next
    r_cap = msm.default_r_cap(n_msm, MSM_C)
    t0 = time.perf_counter()
    rounds = msm.build_rounds(ss, MSM_C, r_cap)
    schedule_s = time.perf_counter() - t0
    first, spills = rounds

    def expected_launches(first, spills, cap, c):
        w = first.shape[0]
        return {"point_add": first.shape[-1] + cap * len(spills) + 2 * c + (w - 1), "point_double": (w - 1) * c}

    run_s = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        build.reset_counts()
        res, dt = clock(lambda: msm.msm_run(px, py, pz, rounds, MSM_C))
        run_s.append(dt)
    counts_msm = {k_: v for k_, v in build.COUNTS.items() if v}
    designs_msm = {f"{k_}/{d_}": v for (k_, d_), v in build.INSTANCE_COUNTS.items()}
    if counts_msm != expected_launches(first, spills, r_cap, MSM_C):
        fail(f"msm_run launched {counts_msm}, the schedule implies {expected_launches(first, spills, r_cap, MSM_C)}")
    expect = O.g1_mul(O.G1_ONE, sum(s_ * k_ for s_, k_ in zip(ss, ks)) % P.R_SCALAR)
    if not O.g_eq(O.FQ_OPS, curve.from_device(g1s, res)[0], expect):
        fail("the MSM at 2^20 points differs from the oracle")
    msm_peak = torch.cuda.max_memory_allocated()
    # where a run's time goes: the schedule's upload, the gathers alone, the
    # accumulation (gathers and additions), the bucket reduce
    w_msm, nb_msm = first.shape[0], 1 << MSM_C
    idx_first, upload_s = clock(lambda: torch.from_numpy(first).to(dev))
    by_round = idx_first.reshape(w_msm * nb_msm, -1).t().contiguous()

    def gathers_alone():
        for ids in by_round:
            for t in (px, py, pz):
                torch.index_select(t, -1, ids)

    _, gather_s = clock(gathers_alone)
    acc, accumulate_s = clock(lambda: msm._accumulate_rounds(px, py, pz, idx_first, curve.zero(g1s, (w_msm * nb_msm,))))
    for wk, idx in spills:
        acc = msm._accumulate_window(px, py, pz, torch.from_numpy(idx).to(dev), acc, wk, nb_msm)
    staged, reduce_s = clock(lambda: msm._bucket_reduce(acc, MSM_C, w_msm, nb_msm))
    if not same_limbs(staged, res):
        fail("the MSM run in stages differs from msm_run")
    del acc, idx_first, by_round

    # a skewed input that overflows one bucket: window-local spill rounds
    rng_s = np.random.default_rng(66)
    n_skew, c_skew, cap_skew = 24, 4, 2
    skew_pts = [O.g1_mul(O.G1_ONE, int(rng_s.integers(1, 1 << 62))) for _ in range(n_skew)]
    heavy = int.from_bytes(rng_s.bytes(40), "big") % P.R_SCALAR
    skew_scalars = [heavy] * (n_skew // 2) + [int.from_bytes(rng_s.bytes(40), "big") % P.R_SCALAR for _ in range(n_skew // 2)]
    skew_first, skew_spills = msm.build_rounds(skew_scalars, c_skew, cap_skew)
    build.reset_counts()
    skew_res = msm.msm(skew_pts, skew_scalars, c=c_skew, r_cap=cap_skew)
    torch.cuda.synchronize()
    counts_skew = {k_: v for k_, v in build.COUNTS.items() if v}
    if not skew_spills or counts_skew != expected_launches(skew_first, skew_spills, cap_skew, c_skew):
        fail(f"the skewed MSM: {len(skew_spills)} spill rounds, launches {counts_skew}")
    if not O.g_eq(O.FQ_OPS, curve.from_device(g1s, skew_res)[0], msm.msm_oracle(skew_pts, skew_scalars)):
        fail("the skewed MSM differs from the oracle")

    # the same MSM at 2^12 points on both group-law paths
    n_small = 1 << 12
    c_small = msm.auto_c(n_small)
    small_pts = tuple(torch.cat([t[..., :n_small], t[..., -1:]], dim=-1) for t in (px, py, pz))
    small_rounds = msm.build_rounds(ss[:n_small], c_small, msm.default_r_cap(n_small, c_small))
    small_on, small_on_s = clock(lambda: msm.msm_run(*small_pts, small_rounds, c_small))
    build.reset_counts()
    with backend.fusions(curve_kernels=False):
        small_off, small_off_s = clock(lambda: msm.msm_run(*small_pts, small_rounds, c_small))
    if any(build.COUNTS[k_] for k_ in CURVE_KERNELS) or not same_limbs(small_on, small_off):
        fail("the MSM at 2^12 points differs between the curve kernels and the per-field-op law")
    expect_small = O.g1_mul(O.G1_ONE, sum(s_ * k_ for s_, k_ in zip(ss[:n_small], ks[:n_small])) % P.R_SCALAR)
    if not O.g_eq(O.FQ_OPS, curve.from_device(g1s, small_on)[0], expect_small):
        fail("the MSM at 2^12 points differs from the oracle")
    emit({"phase": "msm_path", "n": n_msm, "c": MSM_C, "r_cap": r_cap, "R": int(first.shape[-1]),
          "spill_rounds": len(spills), "scalars_to_card_s": scalars_to_card_s, "points_s": points_s,
          "schedule_s": schedule_s, "run_s": run_s,
          "points_per_s": n_msm / min(run_s), "launches": counts_msm, "launches_by_design": designs_msm,
          "oracle_exact": True,
          "stages_s": {"schedule_upload": upload_s, "gathers_alone": gather_s,
                       "accumulate_first_schedule": accumulate_s, "bucket_reduce": reduce_s},
          "peak_memory_bytes": msm_peak, "peak_memory_bytes_point_generation": points_peak,
          "skewed": {"n": n_skew, "c": c_skew, "r_cap": cap_skew, "spill_rounds": len(skew_spills),
                     "launches": counts_skew, "oracle_exact": True},
          "n_4096": {"c": c_small, "R": int(small_rounds[0].shape[-1]), "spill_rounds": len(small_rounds[1]),
                     "run_s_curve_kernels": small_on_s, "run_s_per_field_op": small_off_s,
                     "launches_per_field_op": sum(build.COUNTS.values()), "equal_limbs": True, "oracle_exact": True},
          "card": smi})

    # ---- phase 9b: parallel/dist.py on an NCCL group of one rank ---------------
    import tempfile

    import torch.distributed as tdist

    from bn_tpu_torch.parallel import dist

    import __graft_entry_torch__ as ge  # beside this script, as bn_tpu_torch is

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))

    dist_s = {}
    with tempfile.TemporaryDirectory() as rdv:
        device = dist.init_group("nccl", f"file://{rdv}/rendezvous", 1, 0)
        try:
            product, dist_s["sharded_pairing_product"] = clock(lambda: dist.sharded_pairing_product(p, q))
            folded, dist_s["fq12_fold_product"] = clock(lambda: dist.fq12_fold_product(out))
            if tuple(product.shape) != (2, 3, 2, 16, 1) or not torch.equal(product, folded):
                fail("sharded_pairing_product differs from fq12_fold_product of the main path's result")
            small_host = curve.from_device(g1s, tuple(t[..., :n_small] for t in (px, py, pz)))
            small_sum, dist_s["sharded_msm"] = clock(lambda: dist.sharded_msm(small_host, ss[:n_small], device=device))
            if small_sum[0].device.type != "cuda" or not O.g_eq(O.FQ_OPS, curve.from_device(g1s, small_sum)[0], expect_small):
                fail("sharded_msm of 2^12 points differs from the oracle")
            gloo = tdist.new_group(backend="gloo")
            try:
                dist.sharded_pairing(p, q, group=gloo)
                fail("a CUDA tensor under a gloo group was not refused")
            except ValueError:
                pass
            _, dist_s["dryrun_multichip_in_group"] = clock(lambda: ge.dryrun_multichip(1))
            dry, dist_s["dryrun_rank"] = clock(lambda: ge._dryrun_rank(device))
            dry_want = O.FQ12_ONE
            for k_ in range(1, ge.PAIRS_PER_RANK + 1):
                dry_want = O.fq12_mul(dry_want, O.pairing(O.g1_mul(O.G1_ONE, 10 + k_), O.g2_mul(O.G2_ONE, 20 + k_)))
            if tower.fq12_from_device(dry) != [dry_want]:
                fail("the dry run's product differs from the oracle's")
        finally:
            tdist.destroy_process_group()
    _, dist_s["dryrun_multichip_spawned"] = clock(lambda: ge.dryrun_multichip(1))
    emit({"phase": "dist_path", "backend": "nccl", "world_size": 1, "device": str(device),
          "pairs": B, "msm_points": n_small, "seconds": dist_s, "product_equals_fold": True,
          "msm_oracle_exact": True, "gloo_refuses_cuda": True,
          "dryrun_multichip": {"in_group": True, "spawned": True, "product_equals_oracle": True}, "card": smi})

    # ---- phase 9c: the reference's field and group trials at 10,000 lanes -------
    import torch_trials as TT

    by_design, ladder_s = {}, {}
    for G in TT.GROUPS.values():
        base = curve.one(G.spec, (N_TRIALS,))
        k_trials = fp.to_device(fp.FR, TT.scalars(np.random.default_rng(1), N_TRIALS))
        torch.cuda.synchronize()
        build.reset_counts()
        t0 = time.perf_counter()
        curve.mul(G.spec, base, k_trials)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        ladder_s[G.name] = {"enqueued": t1 - t0, "done": time.perf_counter() - t0}
        by_design[G.name] = {f"{k_}/{d_}": v for (k_, d_), v in build.INSTANCE_COUNTS.items()}
        if by_design[G.name] != {"point_double/thread": 256, "point_add/team": 256}:
            fail(f"curve.mul of {N_TRIALS} {G.name} lanes launched {by_design[G.name]} by design")
    seconds, trial_rows = {}, []
    for trial, x in TT.trials():
        res, sec = TT.timed(trial, x, dev, N_TRIALS)
        if res.failed:
            fail(f"trial {res.name} failed on {len(res.failed)} of {res.lanes} lanes, the first {res.failed[:8]}")
        trial_rows.append({"trial": res.name, "lanes": res.lanes, "failed": 0, "s": sec})
        seconds[x.name] = seconds.get(x.name, 0.0) + sec
    emit({"phase": "trials", "n": N_TRIALS, "trials": trial_rows, "seconds_by_field_or_group": seconds,
          "seconds_total": sum(seconds.values()), "oracle_lanes": TT.sample_lanes(N_TRIALS),
          "curve_mul_launches_by_design": by_design, "curve_mul_s": ladder_s, "card": smi})

    # ---- phase 9d: __graft_entry_torch__.entry() --------------------------------
    entry_s = {}
    (entry_fn, entry_args), entry_s["args"] = clock(ge.entry)
    if any(t.device.type != "cuda" for pt in entry_args for t in pt):
        fail("entry() did not put its arguments on the card")
    calls = [clock(lambda: entry_fn(*entry_args)) for _ in range(3)]
    entry_s["calls"] = [c_[1] for c_ in calls]
    entry_want = [O.pairing(O.g1_mul(O.G1_ONE, 100 + k_), O.g2_mul(O.G2_ONE, 200 + k_))
                  for k_ in range(1, ge.ENTRY_BATCH + 1)]
    for gt, _ in calls:
        if tuple(gt.shape) != (2, 3, 2, 16, ge.ENTRY_BATCH) or tower.fq12_from_device(gt) != entry_want:
            fail("entry()'s pairing differs from the oracle's")
    emit({"phase": "entry", "batch": ge.ENTRY_BATCH, "seconds": entry_s, "oracle_lanes_equal": ge.ENTRY_BATCH,
          "card": smi})

    for row in kernel_rows:
        if row["name"] in CURVE_KERNELS:  # their path is the MSM; the API's ladders beside it
            row["launches"] = counts_msm[row["name"]]
            row["launches_per_curve_mul"] = curve_path["G1"]["launches_on"][row["name"]]
            row["launches_per_curve_mul_g2"] = curve_path["G2"]["launches_on"][row["name"]]
        elif row["name"] == "fq12_mul024":  # its path: tower.fq12_mul_by_024
            row["launches"] = counts_line["fq12_mul024"]
        elif row["name"] == "miller_step":  # its path: pairing_batch with the switch on
            row["launches"] = counts_miller["miller_step"]
            row["launches_square"] = instances["square"]
            row["launches_no_square"] = instances["no_square"]
        elif row["name"] in SUM_SINGLE_OPS:  # its path: the unfused pairing_batch (its precompute)
            row["launches"] = counts_unfused[row["name"]]
            row["launches_fused"] = counts[row["name"]]
            row["launches_miller_path"] = counts_miller[row["name"]]
        else:
            row["launches"] = counts[row["name"]]
            row["launches_unfused_1024"] = counts_unfused[row["name"]]
            row["launches_miller_path"] = counts_miller[row["name"]]
    print(smi, flush=True)
    emit({"kernels": kernel_rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
