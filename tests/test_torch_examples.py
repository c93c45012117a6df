"""The two examples on the port's API, `examples/dh_torch.py` and
`examples/joux_torch.py`, at batch 2 on the CPU.  Each asserts inside `main`
that the three parties arrive at one secret.  They are a file of their own
because they are fifteen 256-step ladders, three pairings and three Gt powers
on the plain versions: as a file they can run beside the other tests.
"""

import sys
from pathlib import Path

import torch

from bn_tpu_torch import Gt

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

torch.set_num_threads(1)  # tiny tensors: threads only add overhead


def test_example_dh():
    import dh_torch

    secret = dh_torch.main(batch=2, seed=21, device="cpu")
    assert secret.batch == 2 and not secret.is_zero().any()


def test_example_joux():
    import joux_torch

    secret = joux_torch.main(batch=2, seed=31, device="cpu")
    assert secret.batch == 2 and not (secret == Gt.one(2, "cpu"))
