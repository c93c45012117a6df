"""bn_tpu_torch — the PyTorch/CUDA port of the bn_tpu BN254 pairing framework.

Same structure and names as the JAX package `bn_tpu`, which stays the
reference.  This package imports torch and numpy only.  Covered so far: the
reference crate's surface `Fr`, `G1`, `G2`, `Gt`, `pairing` (api.py) with the
validated wire format (serialization.py, host codec utils/native.py), the
batched reduced pairing (`ate.pairing_batch`), the Pippenger MSM (msm.py),
their sharding over the ranks of a torch.distributed group (parallel/dist.py)
and everything below them — Fq/Fr Montgomery arithmetic over 16-bit limb
tensors, the Fq2/Fq6/Fq12 tower, the G1/G2 Jacobian groups — on nineteen
hand-written CUDA kernels (csrc/), one for each Pallas kernel of the JAX
package.

Tensors on the CPU go through the kernels' plain PyTorch versions; tensors on
a CUDA device go through the kernels, which are built with nvcc at first use.
Functions that create tensors take `device` and default to the card.
"""

__version__ = "0.1.0"

from . import api, ate, convert, curve, msm, oracle, params, serialization  # noqa: F401
from .api import G1, G2, Fr, Gt, pairing  # noqa: F401
from .ate import miller_batch, pairing_batch  # noqa: F401
from .fields import fp, tower  # noqa: F401
