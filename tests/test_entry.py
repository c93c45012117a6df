"""Driver entry points: entry() compile-check and the multichip dry run on
the virtual CPU mesh."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


@pytest.mark.slow
def test_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert np.asarray(out).shape[-1] == args[0][0].shape[-1]


@pytest.mark.slow
def test_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(4)
