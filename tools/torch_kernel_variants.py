#!/usr/bin/env python3
"""Compare two builds of the port's Fq12-sized, Miller-step, step and curve kernels on the
card: the Montgomery product called out of line (-DBN_MUL_OUT_OF_LINE) against
the same product inlined at each of its 7 to 54 uses.  ops/build.py's
SOURCE_FLAGS holds the choice made from these numbers.

For each kernel and each variant it prints one JSON line:
nvcc's build time, what `ptxas -v` reports for the entry (registers, stack,
spills), the kernel's time at B = 8192 (CUDA events, 50 launches after a
warm-up, variants in turns: call, inline, inline, call), and whether the two
variants return the same limbs.  Run from the repository root on a machine
with a GPU and nvcc:  python3 tools/torch_kernel_variants.py
"""

import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bn_tpu_torch import params as P  # noqa: E402
from bn_tpu_torch.ops import build  # noqa: E402
from bn_tpu_torch.ops import mont_cuda as mc  # noqa: E402
from bn_tpu_torch.ops import tower_cuda as tc  # noqa: E402

B = 8192
VARIANTS = {"call": ["-DBN_MUL_OUT_OF_LINE"], "inline": []}
KERNELS = {  # label -> (entry, operand structs, number of outputs shaped like the first operand, own arguments)
    "fq12_mul": ("fq12_mul", [(2, 3, 2), (2, 3, 2)], 1, ()),
    "fq12_sq": ("fq12_sq", [(2, 3, 2)], 1, ()),
    "fq12_mul024_pre": ("fq12_mul024_pre", [(2, 3, 2), (2,), (2, 2)], 1, ()),
    "fq12_mul024": ("fq12_mul024", [(2, 3, 2), (3, 2)], 1, ()),
    "miller_step square": ("miller_step", [(2, 3, 2), (3, 2), (), ()], 1, (1,)),
    "miller_step no square": ("miller_step", [(2, 3, 2), (3, 2), (), ()], 1, (0,)),
    "fq12_cyclo_sq": ("fq12_cyclo_sq", [(2, 3, 2)], 1, ()),
    "fq12_cyclo_sq_chain": ("fq12_cyclo_sq_chain", [(2, 3, 2)], 1, (5,)),  # the longest run of the main path
    "double_step": ("double_step", [(3, 2)], 2, tc._step_const_args()),
    "madd_step": ("madd_step", [(3, 2), (2, 2)], 2, ()),
    # coordinates are random field elements, generic lanes: no doubling, no infinity
    "point_add G1": ("point_add", [()] * 6, 3, (0,)),
    "point_add G2": ("point_add", [(2,)] * 6, 3, (1,)),
    "point_double G1": ("point_double", [()] * 3, 3, (0,)),
    "point_double G2": ("point_double", [(2,)] * 3, 3, (1,)),
}


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    out_dir = build.BUILD / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    # start every compile at once (one per source and variant), then wait;
    # time each by its own clock
    procs = {}
    for stem in sorted({build.ENTRIES[spec[0]][0] for spec in KERNELS.values()}):
        for var, flags in VARIANTS.items():
            so = out_dir / f"lib{stem}.{var}.so"
            procs[stem, var] = (build.compile_start(stem, so, flags), so, time.perf_counter())
    libs, logs, secs = {}, {}, {}
    for key, (proc, so, t0) in procs.items():
        logs[key], _ = proc.communicate()
        secs[key] = time.perf_counter() - t0  # upper bound: includes waiting on earlier ones
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {key}:\n{logs[key]}")
        libs[key] = ctypes.CDLL(str(so))

    rng = np.random.default_rng(7)
    pool = torch.from_numpy(
        P.ints_to_limbs([int.from_bytes(rng.bytes(40), "big") % P.Q for _ in range(B)]).astype(np.int32)
    ).to(dev)
    words, inv32 = mc._mod_args(P.Q)
    stream = torch.cuda.current_stream().cuda_stream

    for label, (name, structs, n_out, own) in KERNELS.items():
        stem = build.ENTRIES[name][0]
        ins = []
        for st in structs:
            idx = torch.from_numpy(rng.integers(0, B, size=tuple(st) + (B,))).to(dev)
            ins.append(torch.movedim(pool[:, idx.reshape(-1)].reshape((16,) + tuple(st) + (B,)), 0, -2).contiguous())
        outs, ms = {}, {v: [] for v in VARIANTS}

        def run(var):
            fn = getattr(libs[stem, var], f"bn_{name}")
            fn.argtypes = list(build.ENTRIES[name][1]) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            o = torch.stack([torch.empty_like(ins[0]) for _ in range(n_out)])
            args = [t.data_ptr() for t in ins] + [x.data_ptr() for x in o] + [1, B, *own, words, inv32, stream]
            assert fn(*args) == 0
            torch.cuda.synchronize()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(50):
                fn(*args)
            t1.record()
            torch.cuda.synchronize()
            outs[var] = o
            ms[var].append(t0.elapsed_time(t1) / 50)

        for var in ("call", "inline", "inline", "call"):
            run(var)
        for var in VARIANTS:
            log = logs[stem, var]  # of the whole source: every entry in it
            regs = re.findall(r"Used (\d+) registers", log)
            spills = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", log)
            print(json.dumps({
                "kernel": label, "variant": var, "ms": ms[var], "nvcc_s_upper_bound": round(secs[stem, var], 1),
                "registers": [int(r) for r in regs],
                "stack_spillstore_spillload_bytes": [[int(x) for x in s] for s in spills],
                "same_result": bool(torch.equal(outs["call"], outs["inline"])), "card": card,
            }), flush=True)


if __name__ == "__main__":
    main()
