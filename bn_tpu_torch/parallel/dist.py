"""Multi-card scaling: the batch sharded over the ranks of a process group,
Gt products and MSM partial sums folded across them.

Counterpart of the JAX package's parallel/dist.py.  A torch.distributed
process group takes the place of the JAX Mesh: one process per rank, each on
its own device, and the collectives are all_gather (and one all_reduce of an
integer) outside the kernels.  The caller starts the group, or `init_group`
does with an explicit backend: NCCL for CUDA tensors, each rank on the card
it names, gloo for CPU tensors.  A tensor on the wrong side of its group's
backend raises; nothing moves to the CPU.

Every rank passes the whole batch, as a JAX caller passes global arrays, and
works on its contiguous shard of the trailing batch axis.  A sharded pairing
returns the rank's own lanes (what a JAX array sharded over the mesh keeps on
that device); the Gt product and the MSM return the whole result on every
rank.  Products fold in the JAX functions' order (rows of width
min(p2, 1024), then a log-fold by strides), so a Jacobian sum has the same
limbs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import curve
from .. import msm as _msm
from ..ate import pairing_batch
from ..fields import tower


def init_group(backend: str, init_method: str, world_size: int, rank: int, local_rank: int | None = None):
    """Start the default process group and return this rank's device:
    `cuda:{local_rank}` (default: the rank) under "nccl", the CPU under
    "gloo".  init_method is a rendezvous such as "tcp://localhost:29500" or
    "file:///path"; nothing is read from the environment."""
    if backend == "nccl":
        device = torch.device("cuda", rank if local_rank is None else local_rank)
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=init_method, world_size=world_size, rank=rank, device_id=device)
    elif backend == "gloo":
        device = torch.device("cpu")
        dist.init_process_group("gloo", init_method=init_method, world_size=world_size, rank=rank)
    else:
        raise ValueError(f"backend must be 'nccl' (CUDA tensors) or 'gloo' (CPU tensors), got {backend!r}")
    return device


def _check_device(t: torch.Tensor, group) -> None:
    backend = dist.get_backend(group)
    on_card = {"nccl": True, "gloo": False}.get(backend)
    if on_card is None or t.is_cuda != on_card:
        raise ValueError(f"a tensor on {t.device} under a {backend!r} group: NCCL takes CUDA tensors, gloo CPU tensors")


def _all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's t, concatenated along the batch axis in rank order."""
    _check_device(t, group)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=-1)


def shard_point(p, group=None):
    """This rank's contiguous shard of the trailing batch axis of every
    coordinate.  The batch must divide evenly, as a mesh's sharding needs."""
    n_dev, rank = dist.get_world_size(group), dist.get_rank(group)
    b = p[0].shape[-1]
    if b % n_dev:
        raise ValueError(f"a batch of {b} does not shard evenly over {n_dev} ranks")
    lo = rank * (b // n_dev)
    return tuple(t[..., lo : lo + b // n_dev] for t in p)


# ---------------------------------------------------------------------------
# Gt product and point sum along the batch axis
# ---------------------------------------------------------------------------


def _fold_strides(width: int) -> list:
    s, out = width // 2, []
    while s >= 1:
        out.append(s)
        s //= 2
    return out


def fq12_fold_product(a, width: int = 1024):
    """Product of a batch of Fq12 (..., 2, 3, 2, L, B) along the trailing
    axis; returns batch 1.  Padded to a power of two p2 with Gt one, the rows
    of width w = min(p2, width) are multiplied up, then the w lanes fold by
    halving strides (lane 0 ends up holding the product)."""
    b = a.shape[-1]
    p2 = 1 << (b - 1).bit_length()
    lead = tuple(a.shape[:-5])
    if p2 != b:
        a = torch.cat([a, tower.ones12(lead + (p2 - b,), a.device)], dim=-1)
    w = min(p2, width)
    x = tower.ones12(lead + (w,), a.device)
    for row in torch.movedim(a.reshape(a.shape[:-1] + (p2 // w, w)), -2, 0):
        x = tower.fq12_mul(x, row)
    for s in _fold_strides(w):
        x = tower.fq12_mul(x, torch.roll(x, -s, dims=-1))
    return x[..., :1]


def point_fold_sum(spec, p, width: int = 1024):
    """Sum of a batch of Jacobian points along the trailing axis; returns a
    batch-1 point.  Padded with infinity; same two stages as
    fq12_fold_product."""
    b = p[0].shape[-1]
    p2 = 1 << (b - 1).bit_length()
    lead = tuple(p[0].shape[: p[0].dim() - 2 - spec.field.struct_ndim])
    device = p[0].device
    if p2 != b:
        inf = curve.zero(spec, lead + (p2 - b,), device)
        p = tuple(torch.cat([c, i], dim=-1) for c, i in zip(p, inf))
    w = min(p2, width)
    x = curve.zero(spec, lead + (w,), device)
    rows = zip(*(torch.movedim(c.reshape(c.shape[:-1] + (p2 // w, w)), -2, 0) for c in p))
    for row in rows:
        x = curve.add(spec, x, row)
    for s in _fold_strides(w):
        x = curve.add(spec, x, tuple(torch.roll(c, -s, dims=-1) for c in x))
    return tuple(c[..., :1] for c in x)


# ---------------------------------------------------------------------------
# sharded pipelines
# ---------------------------------------------------------------------------


def sharded_pairing(p, q, group=None):
    """Data-parallel batched pairing: this rank pairs its shard of the
    Jacobian batches p (G1) and q (G2) and returns those lanes of the Gt
    result.  No collective."""
    p, q = shard_point(p, group), shard_point(q, group)
    _check_device(p[0], group)
    return pairing_batch(p, q)


def sharded_pairing_product(p, q, group=None):
    """The product of all B pairings, on every rank: each rank pairs its
    shard and multiplies its lanes up, the per-rank partial products are
    gathered in rank order and folded once more."""
    part = fq12_fold_product(sharded_pairing(p, q, group))
    return fq12_fold_product(_all_gather_cat(part, group))


def sharded_msm(points, scalars, c: int | None = None, group=None, device=None):
    """Multi-card Pippenger MSM over G1: points (host oracle points) and
    scalars (ints), the same lists on every rank, are split into contiguous
    shards (bounds (n i) // n_dev, so shards may differ by one); each rank
    runs the whole MSM of its shard on `device` (default: the card), and the
    per-rank Jacobian partial sums are gathered and folded.  As in the JAX
    function, every shard's uncapped schedule is padded to one shared round
    count R and its points to the longest shard, index n_max meaning
    infinity.  Returns a batch-1 Jacobian point on every rank."""
    n_dev, rank = dist.get_world_size(group), dist.get_rank(group)
    n = len(scalars)
    if n < n_dev:
        raise ValueError(f"sharded_msm needs at least one point per rank: {n} points, {n_dev} ranks")
    if c is None:
        c = _msm.auto_c(max(1, n // n_dev))
    bounds = [(n * i) // n_dev for i in range(n_dev + 1)]
    lo, hi = bounds[rank], bounds[rank + 1]
    ns, n_max = hi - lo, max(b - a for a, b in zip(bounds[:-1], bounds[1:]))

    px, py, pz = _msm.host_points_to_affine_arrays(points[lo:hi], device)
    _check_device(px, group)
    sched = _msm.build_schedule(_msm.extract_digits(_msm.scalars_to_u16(scalars[lo:hi]), c), c)
    r_max = torch.tensor([sched.shape[-1]], dtype=torch.int64, device=px.device)
    dist.all_reduce(r_max, op=dist.ReduceOp.MAX, group=group)
    sched = np.pad(sched, ((0, 0), (0, 0), (0, int(r_max) - sched.shape[-1])), constant_values=ns)
    sched = np.where(sched >= ns, n_max, sched).astype(np.int32)
    pad = torch.zeros((px.shape[0], n_max - ns), dtype=px.dtype, device=px.device)
    px, py, pz = (torch.cat([t, pad], dim=-1) for t in (px, py, pz))

    part = _msm.msm_run(px, py, pz, (sched, []), c)
    return point_fold_sum(curve.g1_spec(), tuple(_all_gather_cat(t, group) for t in part))
