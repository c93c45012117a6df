"""The client: a closed loop of one caller that keeps `depth` calls in flight.

The client enqueues a call, records a completion mark on the stream behind
it, and before it enqueues call k + depth waits on the mark of call k.  Each
call's latency runs from the moment the client starts enqueuing it to its
completion mark.  The marks are CUDA events; their times are put on the
host's clock through one event recorded while the card is idle.  Every output
is compared on the card with the first output the loop kept for the same input
batch, so no call of the window is left unjudged while only the kept ones go
to the reference after the window.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import torch


class CudaClock:
    """Completion marks on the current CUDA stream."""

    def __init__(self, device):
        self.device = device

    def mark(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    @staticmethod
    def wait(m):
        m.synchronize()

    @staticmethod
    def ms(a, b) -> float:
        return a.elapsed_time(b)

    def sync(self):
        torch.cuda.synchronize(self.device)


class HostClock:
    """Marks on the host's clock, for rehearsing the harness on the CPU, where
    every call has finished when it returns.  Never used for a measurement."""

    device = torch.device("cpu")

    @staticmethod
    def mark():
        return time.perf_counter()

    @staticmethod
    def wait(m):
        pass

    @staticmethod
    def ms(a, b) -> float:
        return (b - a) * 1e3

    @staticmethod
    def sync():
        pass


@dataclasses.dataclass
class Call:
    start: float  # host clock, when the client began to enqueue the call
    enqueue_ms: float  # host time the enqueuing took
    batch: int
    done: object  # completion mark
    launches: int | None = None  # the package's launch counter, over the call
    end: float | None = None  # host clock of the completion mark, after the loop


class Client:
    """Calls `fn(*batches[k % len(batches)])` in a closed loop.

    `counter()` (or None) reads the package's launch counter; `spans` (or
    None) is told where each call begins and ends; `labels` names the loop's
    phases for the profiler."""

    def __init__(self, fn, batches, depth: int, clock, counter=None, spans=None, labels: bool = False):
        self.fn, self.batches, self.depth, self.clock = fn, batches, depth, clock
        self.counter, self.spans, self.labels = counter, spans, labels
        self.kept = [None] * len(batches)
        self.differing = torch.zeros(len(batches), dtype=torch.int64, device=clock.device)

    def _label(self, name):
        return torch.profiler.record_function(name) if self.labels else contextlib.nullcontext()

    def run(self, n_calls: int) -> list:
        """n_calls calls; returns their records with `end` filled in."""
        clock = self.clock
        clock.sync()
        ref = clock.mark()
        t_ref = time.perf_counter()
        pending, calls = collections.deque(), []
        for k in range(n_calls):
            if len(pending) == self.depth:
                with self._label("cardbench.wait"):
                    clock.wait(pending.popleft())
            b = k % len(self.batches)
            n0 = self.counter() if self.counter else None
            t0 = time.perf_counter()
            if self.spans:
                self.spans.begin_call()
            with self._label("cardbench.call"):
                out = self.fn(*self.batches[b])
            done = clock.mark()
            t1 = time.perf_counter()
            if self.spans:
                self.spans.end_call(done)
            calls.append(Call(t0, (t1 - t0) * 1e3, b, done, self.counter() - n0 if self.counter else None))
            pending.append(done)
            if self.kept[b] is None:
                self.kept[b] = out
            else:
                self.differing[b] += (out != self.kept[b]).any()
        clock.sync()
        for c in calls:
            c.end = t_ref + clock.ms(ref, c.done) / 1e3
        return calls


def span_s(calls) -> float:
    """From the start of the first call to the completion of the last."""
    return max(c.end for c in calls) - min(c.start for c in calls)
