"""A stand-in for the package's pairing on CPU tensors, for rehearsing the
harness in tests: the package's own plain versions take tens of seconds a
call on the CPU, the reference a few hundredths a pair.  Same layout in and
out as bn_tpu_torch.ate.pairing_batch; its last stage goes through
`final_exp`, so a fault can replace it as it replaces the package's."""

from __future__ import annotations

import torch

from cardbench.reference import field as rf
from cardbench.reference import limbs as rl


def _points(p, fq2: bool):
    if not fq2:
        return list(zip(*(rl.limbs_to_ints(c) for c in p)))
    coords = [list(zip(rl.limbs_to_ints(c[0]), rl.limbs_to_ints(c[1]))) for c in p]
    return list(zip(*coords))


def _fq12(values: list) -> torch.Tensor:
    return torch.cat([rl.fq12_from_ints(rf.fq12_ints(v), "cpu") for v in values], dim=-1).to(torch.int32)


def _ints(f: torch.Tensor) -> list:
    flat = [rl.limbs_to_ints(f.reshape(12, rl.NLIMBS, -1)[k]) for k in range(12)]
    lanes = list(zip(*flat))
    return [tuple(tuple(tuple(v[6 * a + 2 * b : 6 * a + 2 * b + 2]) for b in range(3)) for a in range(2)) for v in lanes]


def miller(p, q) -> torch.Tensor:
    ref = rf.Ref()
    out = []
    for a, b in zip(_points(p, False), _points(q, True)):
        out.append(ref.miller_loop(ref.precompute(ref.g2_to_affine(b)), ref.g1_to_affine(a)))
    return _fq12(out)


def final_exp(f: torch.Tensor) -> torch.Tensor:
    ref = rf.Ref()
    return _fq12([ref.final_exp(v) for v in _ints(f)])


def pairing_batch(p, q):
    return final_exp(miller(p, q))


def install(config, patches, state):
    """A hook: the stand-in in place of the package's pairing (and of the
    configuration's entry where that is the pairing itself)."""
    for path in config["paths"]["pairing"]:
        patches.replace(path, lambda fn: pairing_batch)
