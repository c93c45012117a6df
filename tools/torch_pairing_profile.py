#!/usr/bin/env python3
"""Where one `pairing_batch` of the port spends its time on the card, for three
configurations of ops/backend.py in one process: fused (the default), fused
with the Miller-step kernel (`miller_step` on) and unfused (every fusion off).

Makes B (default 8192) input pairs on the card and, per configuration, runs
`pairing_batch` once to warm up, five times on the host's clock, then once
under torch.profiler, and prints one JSON line: the unprofiled wall time (the
five and their median), the wall time of the profiled call, the device-busy
time (sum of all kernel times), the idle share of the median wall time, and time and count by kernel name for this package's kernels and
for PyTorch's own kernels around them (stack, where, copy).  If the profiler shows
no device time, it says so instead of printing zeros as if measured.  Before
that it prints one JSON line with the time and the launches of each stage of
the pipeline run on its own (host clock around a synchronise).  With
--replay N it also captures one call as a CUDA graph and replays it N times,
one CUDA-event pair around each replay (the card's pace without the host's),
and checks that the replay returns the eager call's limbs.  With --package
DIR it profiles the bn_tpu_torch package of another checkout (an unpacked
parent commit, say), so that two versions of the Python callers can be timed
in turns, each in its own process, by the same tool.
Run from the repository root:
  python3 tools/torch_pairing_profile.py [B] [--replay N] [--package DIR]
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def _import_package(checkout):
    """The modules of the bn_tpu_torch of `checkout`, as this file's globals."""
    global ate, curve, P, fp, tower, backend, build
    sys.path.insert(0, str(Path(checkout).resolve()))
    from bn_tpu_torch import ate, curve
    from bn_tpu_torch import params as P
    from bn_tpu_torch.fields import fp, tower
    from bn_tpu_torch.ops import backend, build


def main():
    ap = argparse.ArgumentParser(description="stage times, device time by kernel and idle share of pairing_batch")
    ap.add_argument("batch", nargs="?", type=int, default=8192)
    ap.add_argument("--replay", type=int, default=0, help="graph replays of one captured call to time (0: none)")
    ap.add_argument("--package", default=str(Path(__file__).resolve().parent.parent),
                    help="the checkout whose bn_tpu_torch is profiled (default: this one)")
    args = ap.parse_args()
    _import_package(args.package)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    B = args.batch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    rng = np.random.default_rng(42)
    k1 = fp.to_device(fp.FR, [int.from_bytes(rng.bytes(64), "big") % P.R_SCALAR for _ in range(B)])
    k2 = fp.to_device(fp.FR, [int.from_bytes(rng.bytes(64), "big") % P.R_SCALAR for _ in range(B)])
    g1s, g2s = curve.g1_spec(), curve.g2_spec()
    p = curve.mul(g1s, curve.one(g1s, (B,)), k1)
    q = curve.mul(g2s, curve.one(g2s, (B,)), k2)
    configurations = {"fused": {}, "miller_step": dict(miller_step=True),
                      "unfused": dict(pow_fixed=False, cyclo_chain=False, ladder=False)}
    for name, switches in configurations.items():
        with backend.fusions(**switches):
            profile_one(name, B, card, p, q, args.replay)


def profile_one(name, B, card, p, q, replays):
    """The `stages` line and the by-kernel line of the configuration in force."""
    g1s, g2s = curve.g1_spec(), curve.g2_spec()
    ate.pairing_batch(p, q)
    torch.cuda.synchronize()

    def stage(fn):
        build.reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, {"ms": (time.perf_counter() - t0) * 1e3, "launches": sum(build.COUNTS.values())}

    stages = {}
    pa, stages["to_affine_g1"] = stage(lambda: curve.to_affine(g1s, p))
    qa, stages["to_affine_g2"] = stage(lambda: curve.to_affine(g2s, q))
    coeffs, stages["precompute"] = stage(lambda: ate.precompute(qa))
    f, stages["miller_loop"] = stage(lambda: ate.miller_loop(coeffs, pa))
    _, stages["final_exponentiation"] = stage(lambda: tower.final_exponentiation(f))
    print(json.dumps({"configuration": name, "batch": B, "card": card, "stages": stages}), flush=True)

    walls = []  # one call's host clock swings by tens of ms: take the median of five
    for _ in range(5):
        build.reset_counts()
        t0 = time.perf_counter()
        ate.pairing_batch(p, q)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_plain_ms = statistics.median(walls)
    launches = sum(build.COUNTS.values())

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ate.pairing_batch(p, q)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    # kernel rows only: the rows of the host ops that started them (aten::cat,
    # ...) carry the same device time a second time
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    if busy_ms == 0:
        print(json.dumps({"configuration": name, "batch": B, "card": card, "wall_ms_unprofiled": wall_plain_ms,
                          "device_time": "not measured: the profiler recorded no device time"}))
        return
    replay = replay_ms(p, q, replays) if replays else None
    print(json.dumps({
        "configuration": name, "batch": B, "card": card, "package": str(Path(ate.__file__).resolve().parent),
        "replay_ms_runs": replay, "replay_ms": statistics.median(replay) if replay else None,
        "wall_ms_unprofiled": wall_plain_ms, "wall_ms_unprofiled_runs": walls, "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms, "device_idle_share_of_unprofiled_wall": 1 - busy_ms / wall_plain_ms,
        "kernels_total": sum(n for _, _, n in rows), "launches_of_this_package": launches,
        "by_kernel": [{"name": k[:80], "ms": ms, "count": n} for k, ms, n in rows[:25]],
    }))


def replay_ms(p, q, n):
    """ms of each of n replays of one pairing_batch captured as a CUDA graph;
    the replay must return the eager call's limbs."""
    want = ate.pairing_batch(p, q)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = ate.pairing_batch(p, q)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        sys.exit("the replayed pairing_batch differs from the eager call")
    runs = []
    for _ in range(n):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        runs.append(t0.elapsed_time(t1))
    return runs


if __name__ == "__main__":
    main()
