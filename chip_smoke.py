#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run `python3 chip_smoke.py` from the repository root on a machine with one
NVIDIA H100 (or another sm_90a card) and the CUDA toolkit.  It

 1. builds the kernels under bn_tpu_torch/csrc/ with nvcc (all sources at
    once) and prints the card's name and power limit and the build time;
 2. makes the main path's inputs: 8192 (G1, G2) pairs on the card by scalar
    multiplication of the generators with seeded scalars;
 3. calls each of the fifteen kernel wrappers on CUDA tensors — at a ragged
    batch of 1000 with the edge values 0, 1, m-1 and the Montgomery one, for
    both moduli where the kernel takes one, and at the shape the main path
    gives it at B = 8192 — and holds each result against the kernel's plain
    PyTorch version on the same inputs (`pow_fixed` also against Python's
    pow, with the Fermat exponent and one with a zero digit inside; the
    squaring chain at n = 1, 2, 5; the precompute steps on both outputs).
    Tolerance: none, the limbs are integers and `max_abs_err` must be 0.  It
    times both (the kernel by replaying a CUDA graph of 50 launches, so `ms`
    is the card's time; the eager call, host included, is `wrapper_ms`),
    measures the card's 32x32->64-bit multiply-add rate with a register-only
    probe, and from that rate and the published memory rate computes each
    kernel's bound at the timed shape;
 4. drives the main path once: `pairing_batch` as a caller gets it, every
    fusion of ops/backend.py on.  Launch counts are set to 0 just before
    that call and read just after it; every kernel must have been launched,
    `pow_fixed` 3, `fq12_cyclo_sq_chain` 69, `double_step` 64 and `madd_step`
    38 times.  Lanes 0, 1, B/2 and B-1 must equal the pure-Python oracle bit
    for bit, the two lanes with an infinite input must give Gt one, and the
    bilinearity pair e(sP, Q) = e(P, sQ) must agree;
 5. drives the unfused path (every fusion off) on the first 1024 lanes of the
    same inputs: it must launch each of the eleven unfused kernels and none
    of the four fused ones, and return the fused run's lanes bit for bit;
    likewise the precompute alone, whole tensor;
 6. times both paths at B = 8192 in turns, three runs each;
 7. prints one JSON line per phase, the card line, the `kernels` line and the
    last line {"ok": true, "device": {...}}.

Any failure — no CUDA device, a build error, a kernel that differs from its
plain version, a lane that differs from the oracle — ends the run with a
non-zero exit code and no result line.
"""

import json
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
#            shape, base-field products per element, word adds per element).
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
    "double_step": ("kernels_g2_step.cu", "bn_tpu/ops/tower_pallas.py:1068", [(3, 2)], 28, 0),
    "madd_step": ("kernels_g2_step.cu", "bn_tpu/ops/tower_pallas.py:1077", [(3, 2), (2, 2)], 37, 0),
}
FUSED_KERNELS = {"pow_fixed": 3, "fq12_cyclo_sq_chain": 69, "double_step": 64, "madd_step": 38}  # launches per pairing_batch
UNFUSED = dict(pow_fixed=False, cyclo_chain=False, ladder=False)
# mangled-name fragments of the __global__ functions, to read `ptxas -v`
PTXAS_NAMES = {
    "mont_mul": "8k_binaryILi0E", "mod_add": "8k_binaryILi1E", "mod_sub": "8k_binaryILi2E",
    "mod_neg": "5k_neg", "fq2_mul": "9k_fq2_mul", "fq2_sq": "11k_fq2_unaryILi0E",
    "fq2_xi": "11k_fq2_unaryILi1E", "fq12_mul": "10k_fq12_mul", "fq12_sq": "9k_fq12_sq",
    "fq12_mul024_pre": "17k_fq12_mul024_pre", "fq12_cyclo_sq": "15k_fq12_cyclo_sq",
    "pow_fixed": "11k_pow_fixed", "fq12_cyclo_sq_chain": "21k_fq12_cyclo_sq_chain",
    "double_step": "13k_double_step", "madd_step": "11k_madd_step",
}


def statics(name, modulus):
    """The static arguments a kernel is tried with at the ragged batch: the
    exponents of pow_fixed, the chain's lengths, None for the rest."""
    if name == "pow_fixed":
        return [modulus - 2, ZERO_DIGIT_EXPONENT]
    if name == "fq12_cyclo_sq_chain":
        return [1, 2, 5]
    return [None]


def products_of(name, static):
    """Base-field products per element, with the kernel's static argument."""
    per = KERNEL_TABLE[name][3]
    if name == "pow_fixed":  # the table, then 4 squarings and a product per further digit
        digits = (static.bit_length() + 3) // 4
        return per * (15 + 5 * (digits - 1))
    if name == "fq12_cyclo_sq_chain":
        return per * static
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

    import numpy as np

    import bn_tpu_torch  # noqa: F401
    from bn_tpu_torch import ate, curve
    from bn_tpu_torch import oracle as O
    from bn_tpu_torch import params as P
    from bn_tpu_torch.fields import fp, tower
    from bn_tpu_torch.ops import backend, build
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
    emit({"phase": "probe", "what": "32x32->64-bit multiply-add with 64-bit addend, register only",
          "madds": blocks * threads * iters * chains, "ms": probe_ms, "madd_per_s": madd_per_s, "card": smi})

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
    p = curve.mul(g1s, curve.one(g1s, (B,)), k1)
    q = curve.mul(g2s, curve.one(g2s, (B,)), k2)
    torch.cuda.synchronize()

    # ---- phase 3: every kernel against its plain version ---------------------
    def static_last(fn):
        """fn(*ins, modulus) as a call that also takes (and drops) a static."""
        return lambda ins, modulus, static: fn(*ins, modulus)

    wrappers = {name: (static_last(getattr(mod, name)), static_last(getattr(mod, name + "_plain")))
                for mod, names in ((mc, ("mont_mul", "mod_add", "mod_sub", "mod_neg", "fq2_mul", "fq2_sq", "fq2_xi")),
                                   (tc, ("fq12_mul", "fq12_sq", "fq12_mul024_pre", "fq12_cyclo_sq")))
                for name in names}
    wrappers["pow_fixed"] = (lambda ins, m, e: mc.pow_fixed(*ins, e, m), lambda ins, m, e: mc.pow_fixed_plain(*ins, e, m))
    wrappers["fq12_cyclo_sq_chain"] = (lambda ins, m, n: tc.fq12_cyclo_sq_chain(*ins, n, m),
                                       lambda ins, m, n: tc.fq12_cyclo_sq_chain_plain(*ins, n, m))
    wrappers["double_step"] = (lambda ins, m, _: tc.double_step(*ins), lambda ins, m, _: tc.double_step_plain(*ins))
    wrappers["madd_step"] = (lambda ins, m, _: tc.madd_step(*ins), lambda ins, m, _: tc.madd_step_plain(*ins))

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
        moduli = (P.Q, P.R_SCALAR) if name in ("mont_mul", "mod_add", "mod_sub", "mod_neg", "pow_fixed") else (P.Q,)
        unit_structs = [tuple(st[1:]) if name == "fq2_mul" else tuple(st) for st in structs]
        for modulus in moduli:
            for static in statics(name, modulus):
                ins = [rand_field(rng, (3,) + st, B_RAGGED, modulus, specials=True) for st in unit_structs]
                got = kernel(ins, modulus, static)
                torch.cuda.synchronize()
                calls += 1
                where = f"at B={B_RAGGED}, modulus {modulus:#x}, static argument {static}"
                max_err = max(max_err, compare(name, got, plain(ins, modulus, static), where))
                if name == "pow_fixed":  # lanes 0, 1, m-1 (and the next) against Python's pow
                    lanes = P.limbs_to_ints(got[0, :, :4].cpu().numpy())
                    vals = [P.from_mont(v, modulus) for v in P.limbs_to_ints(ins[0][0, :, :4].cpu().numpy())]
                    if vals[0] != 0 or lanes != [P.to_mont(pow(v, static, modulus), modulus) for v in vals]:
                        fail(f"pow_fixed differs from Python's pow, modulus {modulus:#x}, exponent {static:#x}")
        if build.COUNTS[name] != calls:
            fail(f"wrapper {name} counted {build.COUNTS[name]} launches for {calls} calls")
        # (b) the main path's shape at B = 8192
        static = {"pow_fixed": P.Q - 2, "fq12_cyclo_sq_chain": 2}.get(name)
        ins = timed_inputs(name, structs)
        got = kernel(ins, P.Q, static)
        want = plain(ins, P.Q, static)
        torch.cuda.synchronize()
        max_err = max(max_err, compare(name, got, want, "at the main path's shape"))
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
        if name == "fq12_cyclo_sq_chain":  # the longest run of the main path too
            row["ms_n5"] = device_ms(lambda: kernel(ins, P.Q, 5), 50)
            row["bound_ms_n5"] = max(bytes_ms, ops_ms(5))
        kernel_rows.append(row)
    emit({"phase": "kernels", "compared": [r["name"] for r in kernel_rows], "all_equal": True,
          "ragged_batch": B_RAGGED, "tolerance": 0})

    # ---- phase 4: the main path, every fusion on ------------------------------
    if not (backend.pow_fixed and backend.cyclo_chain and backend.ladder):
        fail("the fused path is not the default")
    build.reset_counts()
    out = ate.pairing_batch(p, q)
    torch.cuda.synchronize()
    counts = dict(build.COUNTS)
    never = [k for k, v in counts.items() if v == 0]
    if never:
        fail(f"pairing_batch launched these kernels no time: {never}")
    if {k: counts[k] for k in FUSED_KERNELS} != FUSED_KERNELS:
        fail(f"the fused path launched {({k: counts[k] for k in FUSED_KERNELS})}, expected {FUSED_KERNELS}")

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
          "launches_total": sum(counts.values()), "oracle_lanes": sample,
          "infinity_lanes": [lane_g1_inf, lane_g2_inf], "bilinearity_lanes": [lane_sp, lane_sq]})

    # ---- phase 5: the unfused path on the first lanes of the same inputs ------
    ps = tuple(t[..., :B_UNFUSED].contiguous() for t in p)
    qs = tuple(t[..., :B_UNFUSED].contiguous() for t in q)
    build.reset_counts()
    with backend.fusions(**UNFUSED):
        out_unfused = ate.pairing_batch(ps, qs)
    torch.cuda.synchronize()
    counts_unfused = dict(build.COUNTS)
    wrong = [k for k, v in counts_unfused.items() if (v != 0) == (k in FUSED_KERNELS)]
    if wrong:
        fail(f"the unfused path's launches of {wrong} are not as expected: {counts_unfused}")
    if not torch.equal(out_unfused, out[..., :B_UNFUSED]):
        fail("the unfused path differs from the fused path on the same lanes")
    qa = curve.to_affine(g2s, qs)
    coeffs_fused = ate.precompute(qa)
    with backend.fusions(ladder=False):
        coeffs_unfused = ate.precompute(qa)
    if tuple(coeffs_fused.shape) != (102, 3, 2, 16, B_UNFUSED) or not torch.equal(coeffs_fused, coeffs_unfused):
        fail("the fused precompute differs from the unfused one")
    emit({"phase": "unfused_path", "batch": B_UNFUSED, "launches": counts_unfused,
          "launches_total": sum(counts_unfused.values()), "equals_fused_lanes": True,
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

    for row in kernel_rows:
        row["launches"] = counts[row["name"]]
        row["launches_unfused_1024"] = counts_unfused[row["name"]]
    print(smi, flush=True)
    emit({"kernels": kernel_rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
