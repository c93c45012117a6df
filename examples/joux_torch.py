"""One-round tripartite (Joux) key agreement — the reference's
examples/joux.rs, batched: every lane of the batch is an independent
three-party exchange.  On the PyTorch/CUDA port.

`device` is where the batch lies: the card by default, "cpu" for a run
without one (python examples/joux_torch.py cpu)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bn_tpu_torch import Fr, G1, G2, pairing


def main(batch: int = 4, seed: int = 1, device=None):
    alice_sk = Fr.random(seed, batch, device)
    bob_sk = Fr.random(seed + 1, batch, device)
    carol_sk = Fr.random(seed + 2, batch, device)

    alice_pk1, alice_pk2 = G1.one(batch, device) * alice_sk, G2.one(batch, device) * alice_sk
    bob_pk1, bob_pk2 = G1.one(batch, device) * bob_sk, G2.one(batch, device) * bob_sk
    carol_pk1, carol_pk2 = G1.one(batch, device) * carol_sk, G2.one(batch, device) * carol_sk

    alice_ss = pairing(bob_pk1, carol_pk2).pow(alice_sk)
    bob_ss = pairing(carol_pk1, alice_pk2).pow(bob_sk)
    carol_ss = pairing(alice_pk1, bob_pk2).pow(carol_sk)

    assert alice_ss == bob_ss and bob_ss == carol_ss
    return alice_ss


if __name__ == "__main__":
    main(device=sys.argv[1] if len(sys.argv) > 1 else None)
    print("joux: shared secrets agree")
