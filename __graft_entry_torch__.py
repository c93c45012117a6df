"""Entry points of the PyTorch/CUDA port: the batched pairing of one
card, and one step of the sharded pairing product over n ranks.

    import __graft_entry_torch__ as ge
    fn, args = ge.entry()            # on the card; entry("cpu") on the CPU
    gt = fn(*args)                   # (2, 3, 2, 16, 8) limbs of e(p_k, q_k)
    ge.dryrun_multichip(4)           # four ranks, one card each, NCCL

The counterparts of __graft_entry__.py's entry() and dryrun_multichip(n) on
the same pairs.  Nothing is compiled ahead: the kernels are built at their
first launch, as everywhere in bn_tpu_torch.
"""

import os
import tempfile

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from bn_tpu_torch import curve
from bn_tpu_torch import oracle as O
from bn_tpu_torch.ate import pairing_batch
from bn_tpu_torch.parallel import dist

ENTRY_BATCH = 8
PAIRS_PER_RANK = 2


def _pairs(g1_base: int, g2_base: int, n: int, device):
    """(p, q): the Jacobian batches (g1_base + k) G1 and (g2_base + k) G2 for
    k = 1..n, made by the oracle and moved to `device`."""
    ks = range(1, n + 1)
    p = curve.to_device(curve.g1_spec(), [O.g1_mul(O.G1_ONE, g1_base + k) for k in ks], device)
    q = curve.to_device(curve.g2_spec(), [O.g2_mul(O.G2_ONE, g2_base + k) for k in ks], device)
    return p, q


def entry(device=None):
    """(fn, args): the batched reduced optimal-ate pairing and its 8 pairs,
    ((100 + k) G1, (200 + k) G2) for k = 1..8, on `device` (default: the
    card).  fn(*args) is the (2, 3, 2, 16, 8) Gt batch."""
    return pairing_batch, _pairs(100, 200, ENTRY_BATCH, device)


def _dryrun_rank(device, group=None):
    """One rank's step of the dry run: the product of the pairings of the
    pairs (10 + k) G1, (20 + k) G2 for k = 1..2n, n the group's world size,
    sharded 2 a rank; returns the (2, 3, 2, 16, 1) product, the same on every
    rank."""
    p, q = _pairs(10, 20, PAIRS_PER_RANK * tdist.get_world_size(group), device)
    return dist.sharded_pairing_product(p, q, group)


def _spawned_rank(rank: int, world: int, rendezvous: str) -> None:
    device = dist.init_group("nccl", f"file://{rendezvous}", world, rank)
    try:
        _dryrun_rank(device)
        torch.cuda.synchronize(device)
    finally:
        tdist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> None:
    """One step of the sharded pipeline on n_devices ranks: the data-parallel
    batched pairing with its Gt product gathered across the ranks, 2 pairs a
    rank.  Where a default process group of world size n_devices is up, this
    rank runs its step there (NCCL: on the current card; gloo: on the CPU).
    Otherwise it spawns n_devices ranks, rank r on card r, NCCL, rendezvous
    through a temporary file, and waits for them.  Returns nothing."""
    if tdist.is_initialized():
        world = tdist.get_world_size()
        if world != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) inside a process group of world size {world}")
        on_card = tdist.get_backend() == "nccl"
        device = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
        _dryrun_rank(device)
        if on_card:
            torch.cuda.synchronize(device)
        return
    cards = torch.cuda.device_count()
    if n_devices > cards:
        raise ValueError(f"dryrun_multichip({n_devices}) needs {n_devices} CUDA devices, {cards} found")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_spawned_rank, args=(n_devices, os.path.join(tmp, "rendezvous")), nprocs=n_devices)
