"""bn_tpu_torch — the PyTorch/CUDA port of the bn_tpu BN254 pairing framework.

Same structure and names as the JAX package `bn_tpu`, which stays the
reference.  This package imports torch and numpy only.  Covered so far: the
batched reduced pairing (`ate.pairing_batch`) with everything below it —
Fq/Fr Montgomery arithmetic over 16-bit limb tensors, the Fq2/Fq6/Fq12 tower,
the G1/G2 Jacobian groups — on eleven hand-written CUDA kernels (csrc/).

Tensors on the CPU go through the kernels' plain PyTorch versions; tensors on
a CUDA device go through the kernels, which are built with nvcc at first use.
Functions that create tensors take `device` and default to the card.
"""

__version__ = "0.1.0"

from . import ate, convert, curve, oracle, params  # noqa: F401
from .ate import miller_batch, pairing_batch  # noqa: F401
from .fields import fp, tower  # noqa: F401
