"""One rank of the gloo test of bn_tpu_torch.parallel.dist, started by
tests/test_torch_dist.py through torch.multiprocessing.spawn.

It imports torch, numpy and the port only, never jax or bn_tpu, so that the
ranks do not load the JAX package.  Each rank runs on one CPU thread and
writes what it computed to <out_dir>/rank<r>.npz; the parent compares.  The
ranks also run the dry run of __graft_entry_torch__, dryrun_multichip, in
their group, and keep the product its rank function returned.  Without
pairs, a rank runs the sharded MSM alone.
"""

import sys
import time

import numpy as np
import torch

import __graft_entry_torch__ as ge
from bn_tpu_torch import curve
from bn_tpu_torch.parallel import dist


def sleep(rank, seconds):
    """A child that does nothing for `seconds`: the target of the test of
    the ranks' deadline."""
    time.sleep(seconds)


def run(rank, world, init_file, out_dir, pairs, msm_case):
    torch.set_num_threads(1)
    device = dist.init_group("gloo", f"file://{init_file}", world, rank)
    try:
        points, scalars, c = msm_case
        msm = dist.sharded_msm(points, scalars, c=c, device=device)
        out = dict(msm_x=msm[0].numpy(), msm_y=msm[1].numpy(), msm_z=msm[2].numpy())
        if pairs is not None:
            ps, qs = pairs
            p = curve.to_device(curve.g1_spec(), ps, device)
            q = curve.to_device(curve.g2_spec(), qs, device)
            out.update(lanes=dist.sharded_pairing(p, q).numpy(), product=dist.sharded_pairing_product(p, q).numpy())
            dry = []
            rank_fn = ge._dryrun_rank
            ge._dryrun_rank = lambda *args, **kwargs: dry.append(rank_fn(*args, **kwargs))
            ge.dryrun_multichip(world)
            out.update(dryrun=dry[0].numpy())
        np.savez(f"{out_dir}/rank{rank}.npz", jax_loaded="jax" in sys.modules, **out)
    finally:
        torch.distributed.destroy_process_group()
