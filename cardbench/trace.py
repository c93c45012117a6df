"""What a traced run (`--trace 1`) records beside the window's own records.

Spans: thin wrappers that the benchmark puts around functions of the package
(named by dotted paths in the per-layer metrics' readers), each recording a
completion mark before and after the call and a profiler label around it.  A
span's time is the device time between its two marks; a function called
twice in one call (to_affine, once for G1 and once for G2) adds up.  A path
that no longer resolves is skipped, and its metrics find nothing to read.

The profiled stretch: torch.profiler over a few calls of the same loop after
the window.  From its device timeline come the busy time (the union of the
kernels' intervals), the stretch's length, the device time by kernel name,
the NCCL kernels' count and median length (the median, because the ranks
start their profilers at different moments and the first exchange waits for
the last of them), and the idle gaps named by what the host was doing: the
innermost of the loop's own labels (`cardbench.call`, `cardbench.wait`,
`cardbench.stage.*`) around the gap's start, and the innermost operation
inside it.
"""

from __future__ import annotations

import collections
import importlib
import statistics

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function


NAME_CHARS = 120  # a kernel's name is cut to this many characters (templates run to a thousand)


def resolve(path: str):
    """(owner, attribute name) of a dotted path such as
    "pkg.mod.func", or None where it does not resolve."""
    parts = path.split(".")
    for cut in range(len(parts) - 1, 0, -1):
        try:
            owner = importlib.import_module(".".join(parts[:cut]))
        except ImportError:
            continue
        for name in parts[cut:-1]:
            owner = getattr(owner, name, None)
        if owner is not None and hasattr(owner, parts[-1]):
            return owner, parts[-1]
        return None
    return None


class Patches:
    """Attributes replaced for one run, put back by `restore()`."""

    def __init__(self):
        self._saved = []

    def replace(self, path: str, make):
        """Replace the function at `path` by make(original); False where the
        path does not resolve."""
        found = resolve(path)
        if found is None:
            return False
        owner, name = found
        original = getattr(owner, name)
        self._saved.append((owner, name, original))
        setattr(owner, name, make(original))
        return True

    def restore(self):
        for owner, name, original in reversed(self._saved):
            setattr(owner, name, original)
        self._saved.clear()


class Spans:
    """Device time of named functions, call by call of the client."""

    def __init__(self, targets: dict, clock, patches: Patches):
        self.clock = clock
        self.calls = []  # per call: {span name: [(start mark, end mark), ...]}
        self._current = None
        self.installed = [name for name, path in sorted(targets.items())
                          if patches.replace(path, lambda fn, name=name: self._wrap(name, fn))]

    def _wrap(self, name, fn):
        def wrapper(*args, **kwargs):
            if self._current is None:
                return fn(*args, **kwargs)
            with record_function(f"cardbench.stage.{name}"):
                m0 = self.clock.mark()
                out = fn(*args, **kwargs)
                m1 = self.clock.mark()
            self._current.setdefault(name, []).append((m0, m1))
            return out
        return wrapper

    def begin_call(self):
        self._current = {"call": [(self.clock.mark(), None)]}
        self.calls.append(self._current)

    def end_call(self, done):
        self._current["call"] = [(self._current["call"][0][0], done)]
        self._current = None

    def ms(self) -> dict:
        """{span name: [ms of each call]}, once every mark has been reached."""
        out = collections.defaultdict(list)
        for call in self.calls:
            for name, marks in call.items():
                out[name].append(sum(self.clock.ms(a, b) for a, b in marks))
        return dict(out)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(kernels, host_ops, n_calls: int) -> dict:
    """The profiled stretch from its events.  kernels: (start_us, end_us,
    name) on the device; host_ops: (start_us, end_us, name) on the host."""
    if not kernels:
        return {}
    busy = _union((s, e) for s, e, _ in kernels)
    t0, t1 = busy[0][0], busy[-1][1]
    by_name = collections.Counter()
    for s, e, name in kernels:
        by_name[name[:NAME_CHARS]] += (e - s) / 1e6
    gaps = collections.Counter()
    ops, active, k = sorted(host_ops), [], 0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        while k < len(ops) and ops[k][0] <= a:
            active.append(ops[k])
            k += 1
        active = [op for op in active if op[1] >= a]
        gaps[_host_activity(active)] += (b - a) / 1e6
    nccl = sorted((e - s) / 1e6 for s, e, name in kernels if "nccl" in name.lower())
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "window_s": (t1 - t0) / 1e6,
        "calls": n_calls,
        "kernels_s": dict(by_name.most_common(10)),
        "gaps_s": dict(gaps.most_common(10)),
        "nccl": {"kernels": len(nccl), "median_s": statistics.median(nccl)} if nccl else None,
    }


def _host_activity(active) -> str:
    """The innermost cardbench label and the innermost other host operation
    among the operations running at one moment."""
    labels = [op for op in active if op[2].startswith("cardbench.")]
    others = [op for op in active if not op[2].startswith("cardbench.")]
    label = min(labels, key=lambda op: op[1] - op[0])[2][len("cardbench."):] if labels else "outside the loop"
    return f"{label} / {min(others, key=lambda op: op[1] - op[0])[2]}" if others else label


def _annotation(ev) -> bool:
    """A label's span copied onto the device's timeline, not an operation."""
    return bool(getattr(ev, "is_user_annotation", False)) or ev.name.startswith("cardbench.")


def profiled(run_calls, n_calls: int) -> dict:
    """Profile `run_calls(n_calls)` and summarize its stretch."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_calls(n_calls)
    kernels, host = [], []
    for ev in prof.events():
        span = (ev.time_range.start, ev.time_range.end, ev.name)
        if ev.device_type == DeviceType.CPU:
            host.append(span)
        elif ev.device_type == DeviceType.CUDA and not _annotation(ev):
            kernels.append(span)
    return summarize(kernels, host, n_calls)
