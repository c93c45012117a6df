"""Which of two kernel paths the pipeline takes where it has a fused kernel.

Counterpart in role of the JAX package's ops/backend.py and of its
BN_TPU_POW_FUSED / BN_TPU_CYCLO_CHAIN / BN_TPU_FUSED_LADDER /
BN_TPU_CURVE_KERNELS / BN_TPU_FUSED_MILLER switches.  Five booleans; the
first four are on by default, `miller_step` is the first that is off, as
BN_TPU_FUSED_MILLER is in the JAX package (bn_tpu/ate.py):

  pow_fixed    fields/fp.py `pow_fixed` (the Fermat inversions) runs as one
               `pow_fixed` kernel instead of a loop of `mont_mul` launches;
  cyclo_chain  fields/tower.py `_cyclo_sq_run` runs a run of n >= 2
               cyclotomic squarings as one `fq12_cyclo_sq_chain` kernel
               instead of n `fq12_cyclo_sq` launches;
  ladder       ate.py `precompute` runs each of its 102 steps as one
               `double_step` / `madd_step` kernel instead of a few dozen
               Fq2-sized launches;
  curve_kernels  curve.py `add` / `double` run as one `point_add` /
               `point_double` kernel instead of the per-field-op group law
               (about 70 and 30 launches);
  miller_step  ate.py `miller_loop` runs each of its 102 steps as one
               `miller_step` kernel (square, G1 scaling and sparse multiply)
               instead of one scaling of all steps, then `fq12_sq` and
               `fq12_mul024_pre` launches a step.  Off by default.

A switch chooses between two kernel paths that return the same limbs.  It
never chooses a plain version: where a tensor lies decides that, and nothing
else.  There is no environment variable; `fusions(...)` sets switches for a
block and restores them.
"""

from __future__ import annotations

import contextlib

pow_fixed = True
cyclo_chain = True
ladder = True
curve_kernels = True
miller_step = False

NAMES = ("pow_fixed", "cyclo_chain", "ladder", "curve_kernels", "miller_step")


@contextlib.contextmanager
def fusions(**switches):
    """Set the named switches (booleans) inside the block, e.g.
    `with fusions(pow_fixed=False, cyclo_chain=False, ladder=False):` for the
    unfused path.  An unknown name or a value that is not a bool raises."""
    for name, on in switches.items():
        if name not in NAMES:
            raise ValueError(f"unknown fusion switch {name!r}: the switches are {NAMES}")
        if not isinstance(on, bool):
            raise TypeError(f"fusion switch {name} takes True or False, got {on!r}")
    before = {name: globals()[name] for name in switches}
    globals().update(switches)
    try:
        yield
    finally:
        globals().update(before)
