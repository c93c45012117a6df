"""__graft_entry_torch__ on the CPU.

entry(device="cpu")'s pairs have the limbs of __graft_entry__.entry()'s
arguments (which builds arrays only: no JAX compile), and its function on
them gives the JAX package's oracle pairing on all 8 lanes.
dryrun_multichip refuses what it cannot run here; its step runs in the
four-rank gloo spawn of tests/test_torch_dist.py.  Tolerance: none.
"""

import numpy as np
import pytest
import torch
import torch.distributed as tdist

import __graft_entry__
import __graft_entry_torch__ as ge
from bn_tpu import oracle as JO
from bn_tpu_torch import convert
from bn_tpu_torch.fields import tower as T


def test_entry_pairs_and_pairing_on_the_cpu():
    fn, (p, q) = ge.entry(device="cpu")
    _, (jp, jq) = __graft_entry__.entry()
    for got, want in zip(p + q, tuple(jp) + tuple(jq)):
        assert got.device.type == "cpu" and np.array_equal(convert.to_numpy(got), np.asarray(want))
    gt = fn(p, q)
    assert tuple(gt.shape) == (2, 3, 2, 16, ge.ENTRY_BATCH)
    ks = range(1, ge.ENTRY_BATCH + 1)
    want = [JO.pairing(JO.g1_mul(JO.G1_ONE, 100 + k), JO.g2_mul(JO.G2_ONE, 200 + k)) for k in ks]
    assert T.fq12_from_device(gt) == want


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        assert ge.entry()[1][0][0].device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            ge.entry()


def test_dryrun_refusals(tmp_path):
    """More ranks than cards, and a world size other than the group's."""
    with pytest.raises(ValueError):
        ge.dryrun_multichip(torch.cuda.device_count() + 1)
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1, rank=0)
    try:
        with pytest.raises(ValueError):
            ge.dryrun_multichip(2)
    finally:
        tdist.destroy_process_group()
