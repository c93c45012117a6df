"""One rank of a run: set-up, the measured window, the traced extras and the
judgement of what the window returned.  A one-chip cell runs it in the
process that prints the result; a cell over several chips forks one process
a chip (run.py), each of which runs it and hands back its record."""

from __future__ import annotations

import importlib
import sys
import time
import traceback
import types

import torch
import torch.distributed as tdist

from . import cells, faults, judge, trace, window

CALIBRATION_CALLS = 6  # closed-loop calls after the warm-up that size the window
PROFILED_CALLS = 8  # calls under the profiler after the window of a traced run
FORBIDDEN = ("jax", "jaxlib", "flax", "bn_tpu")
CHECK_NAMES = {"gt_per_pair": "lanes_failed", "gt_product": "products_failed"}


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the port's runs may not load,
    compared whole (bn_tpu_torch is not bn_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _hook(name: str):
    if name in faults.FAULTS:
        return faults.FAULTS[name]
    module, _, fn = name.partition(":")
    return getattr(importlib.import_module(module), fn)


def _counter(paths):
    dicts = []
    for path in paths:
        found = trace.resolve(path)
        if found is not None:
            dicts.append(getattr(*found))
    if not dicts:
        return None
    return lambda: sum(sum(d.values()) for d in dicts)


def measure(cell: cells.Cell, seed: int, seconds: float, traced: bool, t0: float,
            rank: int = 0, world: int = 1, init_method: str | None = None, opts: dict | None = None) -> dict:
    """Run the cell on this rank; returns its record (numbers only)."""
    opts = opts or {}
    rehearsal = bool(opts.get("rehearsal"))
    config, traffic = cell.config, cell.traffic
    patches, state = trace.Patches(), types.SimpleNamespace(phase="setup")
    parts = {"rank": time.perf_counter() - t0}
    try:
        if config.get("init"):  # a configuration over a process group, of one rank too
            init = getattr(*trace.resolve(config["init"]))
            device = init("gloo" if rehearsal else "nccl", init_method, world, rank)
        else:
            device = torch.device("cpu" if rehearsal else "cuda", None if rehearsal else 0)
            if not rehearsal:
                torch.cuda.set_device(device)
        if not rehearsal:
            torch.set_num_threads(1)
        clock = window.HostClock() if rehearsal else window.CudaClock(device)
        clock.sync()
        parts["device"] = time.perf_counter() - t0
        for name in opts.get("hooks", ()):
            _hook(name)(config, patches, state)
        found = trace.resolve(config["entry"])
        if found is None:
            raise SystemExit(f"the entry {config['entry']} does not resolve")
        entry = getattr(*found)
        parts["entry"] = time.perf_counter() - t0

        pool, depth = traffic["pool"], traffic["in_flight"]
        generator = cells.generator(cell)
        progs = [generator.draw(seed, b, traffic) for b in range(pool)]
        batches = [generator.make_batch(p, device) for p in progs]
        clock.sync()
        parts["inputs"] = time.perf_counter() - t0

        spans = counter = None
        if traced:
            readers = [cell.reader(m["name"]) for m in cell.per_layer]
            targets = {k: v for r in readers for k, v in getattr(r, "SPANS", {}).items()}
            spans = trace.Spans(targets, clock, patches)
            counter = _counter({p for r in readers for p in getattr(r, "COUNTERS", {}).values()})

        # set-up: one call of each batch (the first builds or loads the
        # kernels), then a short closed loop that sizes the window
        warm = window.Client(entry, batches, depth, clock, counter, spans, labels=traced)
        warm.run(pool)
        parts["first_calls"] = time.perf_counter() - t0
        per_call = window.span_s(warm.run(CALIBRATION_CALLS)) / CALIBRATION_CALLS
        parts["calibrated"] = time.perf_counter() - t0
        n_calls = torch.tensor([max(2 * depth, round(seconds / per_call))], device=device)
        if world > 1:
            tdist.broadcast(n_calls, src=0)
            tdist.barrier()
        if spans:
            spans.calls.clear()
        if not rehearsal:
            torch.cuda.reset_peak_memory_stats(device)

        client = window.Client(entry, batches, depth, clock, counter, spans, labels=traced)
        state.phase = "window"
        calls = client.run(int(n_calls))
        state.phase = "after"
        peak = torch.cuda.max_memory_allocated(device) if not rehearsal else 0
        spans_ms = spans.ms() if spans else {}
        if spans:
            spans.calls.clear()

        profile = {}
        if traced and not rehearsal:
            profile = trace.profiled(client.run, PROFILED_CALLS)

        kept, differing = client.kept, client.differing.tolist()
        del batches, warm
        if not rehearsal:
            torch.cuda.empty_cache()
        wrong = [judge.JUDGES[config["output"]](kept[b], progs[b]) for b in range(pool)]
        in_batch = [sum(1 for c in calls if c.batch == b) for b in range(pool)]
        return {
            "rank": rank,
            "calls": len(calls),
            "setup_s": calls[0].start - t0,
            "setup_parts": parts,
            "window_s": window.span_s(calls),
            "latency_ms": [(c.end - c.start) * 1e3 for c in calls],
            "enqueue_ms": [c.enqueue_ms for c in calls],
            "launches": [c.launches for c in calls] if counter else [],
            "spans_ms": spans_ms,
            "profile": profile,
            "peak_bytes": peak,
            "kind": "cpu" if rehearsal else torch.cuda.get_device_name(device),
            "wrong": wrong,
            "differing": differing,
            "failed_calls": sum(n if w else d for n, w, d in zip(in_batch, wrong, differing)),
            "forbidden": forbidden_modules(),
        }
    finally:
        patches.restore()
        if tdist.is_initialized():
            tdist.destroy_process_group()


def rank_main(queue, *args, **kwargs):
    """A forked rank: measure, and put ("ok", record) or ("error", text)
    on the queue."""
    try:
        queue.put(("ok", measure(*args, **kwargs)))
    except BaseException:  # the parent must hear of every end, then exits non-zero
        queue.put(("error", traceback.format_exc()))
        raise
