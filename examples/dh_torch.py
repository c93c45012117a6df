"""Two-round three-party Diffie-Hellman on G1 — the reference's
examples/dh.rs, batched, on the PyTorch/CUDA port.

`device` is where the batch lies: the card by default, "cpu" for a run
without one (python examples/dh_torch.py cpu)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bn_tpu_torch import Fr, G1


def main(batch: int = 4, seed: int = 11, device=None):
    alice_sk = Fr.random(seed, batch, device)
    bob_sk = Fr.random(seed + 1, batch, device)
    carol_sk = Fr.random(seed + 2, batch, device)

    alice_pk = G1.one(batch, device) * alice_sk
    bob_pk = G1.one(batch, device) * bob_sk
    carol_pk = G1.one(batch, device) * carol_sk

    # Round one
    alice_dh_1 = bob_pk * carol_sk
    bob_dh_1 = carol_pk * alice_sk
    carol_dh_1 = alice_pk * bob_sk

    # Round two
    alice_dh_2 = alice_dh_1 * alice_sk
    bob_dh_2 = bob_dh_1 * bob_sk
    carol_dh_2 = carol_dh_1 * carol_sk

    assert alice_dh_2 == bob_dh_2 and bob_dh_2 == carol_dh_2
    return alice_dh_2


if __name__ == "__main__":
    main(device=sys.argv[1] if len(sys.argv) > 1 else None)
    print("dh: shared secrets agree")
