"""The benchmark of bn_tpu_torch on NVIDIA cards: one run of one cell.

    python -m cardbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a host with the cell's cards.  The run makes
its inputs from the seed (inputs.py), warms up, runs a closed loop of calls
for about `--seconds` seconds (window.py), judges every output against the
plain reference (judge.py), and prints one JSON line: with `--trace 0` the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics, read by
cardbench/metrics/<metric>.py from the spans, the package's launch counter
and a profiled stretch after the window (trace.py).  The numbers compared for
`correct` are printed last, on standard error and under "checks".

It exits non-zero and prints no result where the host has fewer CUDA cards
than the cell asks for, where the package is missing, and where JAX or the
JAX package was loaded.  A cell over several cards runs one process a card,
in an NCCL group on a free localhost port; the ranks are forked from a
multiprocessing forkserver that imports torch and the harness once, while
this process imports them too.
"""

import time

_T0 = time.perf_counter()  # the process's start, as near as the harness sees it

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import queue as queue_module  # noqa: E402
import socket  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from multiprocessing import forkserver, resource_tracker  # noqa: E402
from pathlib import Path  # noqa: E402

from . import cells  # noqa: E402  (torch is imported once a forkserver is on its way: _ranks_context)

GIB = 1 << 30
_PARTS = {}  # this process's own set-up marks, s since its start
RANK_SECONDS = 1100  # a run may take 360 s, its first in a checkout 1200 s (the build)


def card() -> dict:
    """Kind, maximum SM clock and power limit of the host's cards (the lowest
    clock where they differ), from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,clocks.max.sm,power.limit", "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()
    rows = [[f.strip() for f in line.split(",")] for line in out]
    return {"kind": rows[0][0], "clock_max_mhz": min(float(r[1]) for r in rows),
            "power_limit_w": min(float(r[2]) for r in rows)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks_context(cell):
    """The forkserver context that forks a cell's ranks, its server started
    with torch, the harness and the configuration's modules imported."""
    ctx = multiprocessing.get_context("forkserver")
    paths = [cell.config[k] for k in ("entry", "init") if cell.config.get(k)]
    ctx.set_forkserver_preload(["torch", "cardbench.measure"] + [p.rpartition(".")[0] for p in paths])
    forkserver.ensure_running()
    return ctx


def _stop_helpers():
    """Stop the forkserver and multiprocessing's resource tracker, and wait
    for both to end."""
    forkserver._forkserver._stop()
    gc.collect()  # the queue's semaphores leave the tracker's books
    resource_tracker._resource_tracker._stop()


def _records(cell, seed, seconds, traced, opts) -> list:
    """One record a rank: in this process for one card, else from ranks forked
    one a card."""
    from . import measure, trace

    if cell.chips == 1:
        init = f"tcp://localhost:{_free_port()}" if cell.config.get("init") else None
        return [measure.measure(cell, seed, seconds, traced, _T0, init_method=init, opts=opts)]
    ctx = _ranks_context(cell)
    build = cell.config.get("build")
    if build and not opts.get("rehearsal"):
        getattr(*trace.resolve(build))()  # once, before the ranks load the kernels
    _PARTS["built"] = time.perf_counter() - _T0
    queue = ctx.Queue()
    init = f"tcp://localhost:{_free_port()}"
    procs = [ctx.Process(target=measure.rank_main,
                         args=(queue, cell, seed, seconds, traced, _T0, rank, cell.chips, init, opts))
             for rank in range(cell.chips)]
    for p in procs:
        p.start()
    records, deadline = [], time.monotonic() + RANK_SECONDS
    try:
        while len(records) < len(procs):
            try:
                status, payload = queue.get(timeout=5)
            except queue_module.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise SystemExit(f"a rank ended with exit code {dead[0]} and no record")
                if time.monotonic() > deadline:
                    raise SystemExit(f"the ranks did not finish in {RANK_SECONDS} s")
                continue
            if status != "ok":
                raise SystemExit(f"a rank failed:\n{payload}")
            records.append(payload)
    finally:
        for p in procs:
            p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
        queue.close()
        queue.join_thread()
        del queue
        _stop_helpers()
    return sorted(records, key=lambda r: r["rank"])


def _end_to_end(cell, recs) -> dict:
    lead = recs[0]
    return {
        "pairings_per_s": lead["calls"] * cell.traffic["pairs_per_call"] / lead["window_s"],
        "call_p95_ms": statistics.quantiles(lead["latency_ms"], n=20, method="inclusive")[18],
        "peak_mem_gib": max(r["peak_bytes"] for r in recs) / GIB,
        "setup_s": max(r["setup_s"] for r in recs),
    }


def _mean_top(dicts, top: int = 10) -> list:
    """[[name, seconds], ...]: the mean over the ranks, largest first."""
    total = {}
    for d in dicts:
        for k, v in d.items():
            total[k] = total.get(k, 0.0) + v / len(dicts)
    return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:top]


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool, opts: dict | None = None) -> dict:
    """The result of one run.  `opts` is for the harness's own tests and the
    control: {"rehearsal": True} runs on CPU tensors with gloo ranks and
    measures nothing; "hooks" names faults.py's faults or "module:function"
    hooks applied in every rank before the set-up."""
    from . import measure

    opts = opts or {}
    recs = _records(cell, seed, seconds, traced, opts)
    config = cell.config
    attempted = recs[0]["calls"]
    checks = {
        measure.CHECK_NAMES[config["output"]]: {"value": sum(sum(r["wrong"]) for r in recs), "limit": 0},
        "calls_differing": {"value": sum(sum(r["differing"]) for r in recs), "limit": 0},
    }
    device = {"platform": "cpu" if opts.get("rehearsal") else "gpu", "kind": recs[0]["kind"],
              "count": len(recs), "memory_peak_bytes": max(r["peak_bytes"] for r in recs)}
    result = {"correct": attempted > 0 and all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": attempted, "failed": min(attempted, max(r["failed_calls"] for r in recs))}
    if traced:
        context = {"pairs": cell.traffic["pairs_per_call"] // len(recs), "ranks": len(recs),
                   "output": config["output"],
                   "card": {"kind": "cpu"} if opts.get("rehearsal") else card()}
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(recs, context)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        profiles = [r["profile"] for r in recs if r["profile"]]
        if profiles:
            device["busy_s"] = sum(p["busy_s"] for p in profiles) / len(profiles)
            device["window_s"] = sum(p["window_s"] for p in profiles) / len(profiles)
            result["breakdown"] = {"device_ops": _mean_top([p["kernels_s"] for p in profiles]),
                                   "idle_gaps": _mean_top([p["gaps_s"] for p in profiles])}
        result["card"] = context["card"]
    else:
        values = _end_to_end(cell, recs)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = device
    result["forbidden"] = sorted({name for r in recs for name in r["forbidden"]} | set(measure.forbidden_modules()))
    result["setup_parts"] = recs[0]["setup_parts"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell of the bn_tpu_torch benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload, Path.cwd())
    try:
        if cell.chips > 1:
            _ranks_context(cell)  # its server imports torch while this process does
        import torch

        _PARTS["imported"] = time.perf_counter() - _T0
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"cell {cell.name} needs {cell.chips} CUDA card(s); this host has {have}", file=sys.stderr)
            return 2
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    finally:
        _stop_helpers()
    forbidden = result.pop("forbidden")
    if forbidden:
        print(f"modules that the port's runs may not load were loaded: {forbidden}", file=sys.stderr)
        return 3
    print("set-up of this process, s since its start: " + json.dumps(_PARTS), file=sys.stderr)
    print("set-up of rank 0, s since the start: " + json.dumps(result.pop("setup_parts")), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
