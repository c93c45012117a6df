#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run `python3 chip_smoke.py` from the repository root on a machine with one
NVIDIA H100 (or another sm_90a card) and the CUDA toolkit.  It

 1. builds the kernels under bn_tpu_torch/csrc/ with nvcc (all sources at
    once) and prints the card's name and power limit and the build time;
 2. calls each of the eleven kernel wrappers on CUDA tensors — at a ragged
    batch of 1000 with the edge values 0, 1, m-1 and the Montgomery one, for
    both moduli where the kernel takes one, and at the shape the main path
    gives it at B = 8192 — and holds each result against the kernel's plain
    PyTorch version on the same inputs.  Tolerance: none, the limbs are
    integers and `max_abs_err` must be 0.  It times both (the kernel by
    replaying a CUDA graph of 50 launches, so `ms` is the card's time; the
    eager call, host included, is `wrapper_ms`), measures the
    card's 32x32->64-bit multiply-add rate with a register-only probe, and
    from that rate and the published memory rate computes each kernel's
    bound at the timed shape;
 3. drives the main path once: 8192 (G1, G2) pairs made on the card by
    scalar multiplication of the generators with seeded scalars, then
    `pairing_batch`.  Launch counts are set to 0 just before that call and
    read just after it; every kernel must have been launched.  Lanes 0, 1,
    B/2 and B-1 must equal the pure-Python oracle bit for bit, the two lanes
    with an infinite input must give Gt one, and the bilinearity pair
    e(sP, Q) = e(P, sQ) must agree;
 4. prints one JSON line per phase, the card line, the `kernels` line and the
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

# kernel -> (C source, TPU kernel it replaces, operand structs at the timed
#            shape, base-field products per element, word adds per element)
KERNEL_TABLE = {
    "mont_mul": ("kernels_fq.cu", "bn_tpu/ops/mont_pallas.py:366", [(), ()], 1, 16),
    "mod_add": ("kernels_fq.cu", "bn_tpu/ops/mont_pallas.py:371", [(2,), (2,)], 0, 2 * 16),
    "mod_sub": ("kernels_fq.cu", "bn_tpu/ops/mont_pallas.py:375", [(2,), (2,)], 0, 2 * 16),
    "mod_neg": ("kernels_fq.cu", "bn_tpu/ops/mont_pallas.py:379", [(2,)], 0, 2 * 8),
    "fq2_mul": ("kernels_fq.cu", "bn_tpu/ops/mont_pallas.py:383", [(5, 2), (5, 2)], 5 * 3, 5 * 5 * 16),
    "fq2_sq": ("kernels_fq.cu", "bn_tpu/ops/mont_pallas.py:388", [(2,)], 2, 3 * 16),
    "fq2_xi": ("kernels_fq.cu", "bn_tpu/ops/mont_pallas.py:394", [(2,)], 0, 10 * 16),
    "fq12_mul": ("kernel_fq12_mul.cu", "bn_tpu/ops/tower_pallas.py:1002", [(2, 3, 2), (2, 3, 2)], 54, 0),
    "fq12_sq": ("kernel_fq12_sq.cu", "bn_tpu/ops/tower_pallas.py:1010", [(2, 3, 2)], 36, 0),
    "fq12_mul024_pre": ("kernel_fq12_mul024_pre.cu", "bn_tpu/ops/tower_pallas.py:1047", [(2, 3, 2), (2,), (2, 2)], 39, 0),
    "fq12_cyclo_sq": ("kernel_fq12_cyclo_sq.cu", "bn_tpu/ops/tower_pallas.py:1015", [(2, 3, 2)], 18, 0),
}
# mangled-name fragments of the __global__ functions, to read `ptxas -v`
PTXAS_NAMES = {
    "mont_mul": "8k_binaryILi0E", "mod_add": "8k_binaryILi1E", "mod_sub": "8k_binaryILi2E",
    "mod_neg": "5k_neg", "fq2_mul": "9k_fq2_mul", "fq2_sq": "11k_fq2_unaryILi0E",
    "fq2_xi": "11k_fq2_unaryILi1E", "fq12_mul": "10k_fq12_mul", "fq12_sq": "9k_fq12_sq",
    "fq12_mul024_pre": "17k_fq12_mul024_pre", "fq12_cyclo_sq": "15k_fq12_cyclo_sq",
}


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
    from bn_tpu_torch.ops import build
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

    # ---- phase 2: every kernel against its plain version ---------------------
    wrappers = {
        "mont_mul": (mc.mont_mul, mc.mont_mul_plain), "mod_add": (mc.mod_add, mc.mod_add_plain),
        "mod_sub": (mc.mod_sub, mc.mod_sub_plain), "mod_neg": (mc.mod_neg, mc.mod_neg_plain),
        "fq2_mul": (mc.fq2_mul, mc.fq2_mul_plain), "fq2_sq": (mc.fq2_sq, mc.fq2_sq_plain),
        "fq2_xi": (mc.fq2_xi, mc.fq2_xi_plain), "fq12_mul": (tc.fq12_mul, tc.fq12_mul_plain),
        "fq12_sq": (tc.fq12_sq, tc.fq12_sq_plain),
        "fq12_mul024_pre": (tc.fq12_mul024_pre, tc.fq12_mul024_pre_plain),
        "fq12_cyclo_sq": (tc.fq12_cyclo_sq, tc.fq12_cyclo_sq_plain),
    }

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

    rng = np.random.default_rng(2024)
    kernel_rows = []
    for name, (source, replaces, structs, products, adds) in KERNEL_TABLE.items():
        wrapper, plain = wrappers[name]
        max_err = 0
        launches_here = 0
        # (a) ragged batch with edge values, lead 3; both moduli for the base four
        moduli = (P.Q, P.R_SCALAR) if name in ("mont_mul", "mod_add", "mod_sub", "mod_neg") else (P.Q,)
        unit_structs = [tuple(s[1:]) if name == "fq2_mul" else tuple(s) for s in structs]
        for modulus in moduli:
            ins = [rand_field(rng, (3,) + st, B_RAGGED, modulus, specials=True) for st in unit_structs]
            build.reset_counts()
            got = wrapper(*ins, modulus)
            torch.cuda.synchronize()
            launches_here += build.COUNTS[name]
            want = plain(*ins, modulus)
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                fail(f"kernel {name} differs from its plain version at B={B_RAGGED}, modulus {modulus:#x} (max abs err {err})")
        # (b) the main path's shape at B = 8192
        ins = [rand_field(rng, st, B_MAIN, P.Q, specials=False) for st in structs]
        got = wrapper(*ins, P.Q)
        want = plain(*ins, P.Q)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            fail(f"kernel {name} differs from its plain version at the main path's shape (max abs err {err})")
        if launches_here != len(moduli):
            fail(f"wrapper {name} counted {launches_here} launches for {len(moduli)} calls")
        ms = device_ms(lambda: wrapper(*ins, P.Q), 50)
        wrapper_ms = timed_ms(lambda: wrapper(*ins, P.Q), 50)  # eager: host time included
        plain_ms = timed_ms(lambda: plain(*ins, P.Q), 3)
        # bound: bytes each operand and the result must move once, against the
        # multiply-adds (or word adds) the formula needs at the probed rate
        n_bytes = 4 * (sum(t.numel() for t in ins) + got.numel())
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        n_ops = B_MAIN * (products * MADDS_PER_PRODUCT if products else adds)
        ops_ms = n_ops / madd_per_s * 1e3
        kernel_rows.append({
            "name": name, "route": "cuda", "source": f"bn_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": None, "max_abs_err": max_err, "equal": True, "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "shape": [list(t.shape) for t in ins], "bytes": n_bytes, "operations": n_ops,
            "registers": (ptxas[name] or {}).get("registers"),
            "spill_store_bytes": (ptxas[name] or {}).get("spill_store_bytes"),
            "spill_load_bytes": (ptxas[name] or {}).get("spill_load_bytes"),
            "stack_bytes": (ptxas[name] or {}).get("stack_bytes"),
        })
    emit({"phase": "kernels", "compared": [r["name"] for r in kernel_rows], "all_equal": True,
          "ragged_batch": B_RAGGED, "tolerance": 0})

    # ---- phase 3: the main path ----------------------------------------------
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

    build.reset_counts()
    out = ate.pairing_batch(p, q)
    torch.cuda.synchronize()
    counts = dict(build.COUNTS)
    never = [k for k, v in counts.items() if v == 0]
    if never:
        fail(f"pairing_batch launched these kernels no time: {never}")

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

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        again = ate.pairing_batch(p, q)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    if not torch.equal(again, out):
        fail("pairing_batch is not deterministic")
    pairing_ms = statistics.median(times)
    emit({"phase": "main_path", "batch": B, "launches": counts, "launches_total": sum(counts.values()),
          "oracle_lanes": sample, "infinity_lanes": [lane_g1_inf, lane_g2_inf],
          "bilinearity_lanes": [lane_sp, lane_sq], "pairing_batch_ms": pairing_ms,
          "pairing_batch_ms_runs": times, "pairings_per_s": B / (pairing_ms * 1e-3),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(), "card": smi})

    for row in kernel_rows:
        row["launches"] = counts[row["name"]]
    print(smi, flush=True)
    emit({"kernels": kernel_rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
