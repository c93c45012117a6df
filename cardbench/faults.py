"""The control and the planted faults: hooks that break the timed path, so
that a run shows `correct` false.  None of them runs in the benchmark's own
runs; control.py and the tests apply them.

A hook is hook(config, patches, state): it replaces functions of the package
through `patches` (trace.Patches, restored after the run) at the paths the
configuration names under "paths", and may read `state.phase` ("setup",
"window", "after") and count the window's calls itself.

 - lazy_reduction (the control): the package's configuration states exact,
   canonical results; the control leaves every output coefficient that can be
   so as x + q, the redundant form a lazily reduced chain ends in.
 - state_unchanged: the final step (the final exponentiation) returns its
   input unchanged.
 - half_batch: the pairing computes the first half of the lanes and leaves
   the rest at Gt one.
 - exchange_left_out: the gather between ranks returns the rank's own part.
 - answer_altered / later_answer_altered: one bit of one lane of the first
   (third) call of the window is flipped where the result is produced.
"""

from __future__ import annotations

import torch

from .reference import field as rf
from .reference import limbs as rl


def _redundant(out: torch.Tensor) -> torch.Tensor:
    wide = out.to(torch.int64)
    plus_q = rl._carry(wide + rl.const(rf.Q, out.device, mont=False))
    return torch.where(plus_q[..., -1:, :] <= rl.MASK, plus_q, wide).to(out.dtype)


def lazy_reduction(config, patches, state):
    patches.replace(config["entry"], lambda fn: lambda *a, **k: _redundant(fn(*a, **k)))


def state_unchanged(config, patches, state):
    patches.replace(config["paths"]["final_step"], lambda fn: lambda f, *a, **k: f)


def half_batch(config, patches, state):
    def make(fn):
        def half(p, q, *a, **k):
            n = p[0].shape[-1]
            first = fn(tuple(t[..., : n // 2] for t in p), tuple(t[..., : n // 2] for t in q), *a, **k)
            one = rl.fq12_from_ints([1] + [0] * 11, first.device).to(first.dtype)
            return torch.cat([first, one.expand(first.shape[:-1] + (n - n // 2,))], dim=-1)
        return half
    for path in config["paths"]["pairing"]:
        patches.replace(path, make)


def exchange_left_out(config, patches, state):
    patches.replace(config["paths"]["exchange"], lambda fn: lambda t, *a, **k: t.contiguous())


def _altered_at(index: int):
    def hook(config, patches, state):
        seen = [0]

        def make(fn):
            def altered(*a, **k):
                out = fn(*a, **k)
                if state.phase != "window":
                    return out
                seen[0] += 1
                if seen[0] != index:
                    return out
                out = out.clone()
                lane = (7919 * index) % out.shape[-1]
                out[1, 2, 0, 0, lane] ^= 1
                return out
            return altered
        patches.replace(config["entry"], make)
    return hook


answer_altered = _altered_at(1)
later_answer_altered = _altered_at(3)

FAULTS = {
    "lazy_reduction": lazy_reduction,
    "state_unchanged": state_unchanged,
    "half_batch": half_batch,
    "exchange_left_out": exchange_left_out,
    "answer_altered": answer_altered,
    "later_answer_altered": later_answer_altered,
}
