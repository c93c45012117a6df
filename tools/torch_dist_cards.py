#!/usr/bin/env python3
"""bn_tpu_torch.parallel.dist across the cards of one host.

One process per card, an NCCL group over them (rendezvous on a free localhost
port), each rank on `cuda:{rank}`.  Every rank makes the same inputs on its
own card from seeds, then
 - `sharded_pairing_product` of B = 8192 pairs (each rank pairs B / N) must
   equal `fq12_fold_product(pairing_batch(p, q))` on one card, on every rank;
 - `sharded_msm` of 2^16 points k_i G and scalars s_i must equal
   (sum s_i k_i mod r) G from the oracle, on every rank;
and both are timed on the host clock around a barrier and a synchronise
(three runs), beside the same work on one card (`pairing_batch` and the fold;
`msm.msm`).  Rank 0 prints one JSON line per check, then the card line.

Run from the repository root on a host with N >= 2 cards:
    python3 tools/torch_dist_cards.py [N]
`--cpu N` runs the same script with gloo on CPU processes at a tiny size, to
rehearse it on a machine without cards.
"""

import json
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as tdist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from bn_tpu_torch import ate, curve, msm  # noqa: E402
from bn_tpu_torch import oracle as O  # noqa: E402
from bn_tpu_torch import params as P  # noqa: E402
from bn_tpu_torch.fields import fp  # noqa: E402
from bn_tpu_torch.ops import build  # noqa: E402
from bn_tpu_torch.parallel import dist  # noqa: E402


def seeded_ints(seed, n, modulus):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "big") % modulus or 1 for _ in range(n)]


def rank_main(rank, n_dev, port, on_cpu, sizes, card):
    b, n_msm = sizes
    if on_cpu:
        torch.set_num_threads(1)
    device = dist.init_group("gloo" if on_cpu else "nccl", f"tcp://localhost:{port}", n_dev, rank)

    def sync():
        if not on_cpu:
            torch.cuda.synchronize(device)

    def clock(fn, runs=3):
        """(result, seconds of each run) of fn(), all ranks started together."""
        secs = []
        for _ in range(runs):
            tdist.barrier()
            sync()
            t0 = time.perf_counter()
            res = fn()
            sync()
            secs.append(time.perf_counter() - t0)
        return res, secs

    def report(obj):
        if rank == 0:
            print(json.dumps({**obj, "ranks": n_dev, "backend": tdist.get_backend(), "card": card}), flush=True)

    def same_on_every_rank(t):
        parts = [torch.empty_like(t) for _ in range(n_dev)]
        tdist.all_gather(parts, t.contiguous())
        return all(torch.equal(x, parts[0]) for x in parts)

    g1s, g2s = curve.g1_spec(), curve.g2_spec()
    k1 = fp.to_device(fp.FR, seeded_ints(42, b, P.R_SCALAR), device)
    k2 = fp.to_device(fp.FR, seeded_ints(43, b, P.R_SCALAR), device)
    p = curve.mul(g1s, curve.one(g1s, (b,), device), k1)
    q = curve.mul(g2s, curve.one(g2s, (b,), device), k2)

    product, sharded_s = clock(lambda: dist.sharded_pairing_product(p, q))
    single, single_s = clock(lambda: dist.fq12_fold_product(ate.pairing_batch(p, q)))
    if not (torch.equal(product, single) and same_on_every_rank(product)):
        raise SystemExit(f"rank {rank}: sharded_pairing_product differs from one card's product")
    report({"check": "sharded_pairing_product", "pairs": b, "equals_one_card": True,
            "seconds_runs": sharded_s, "seconds": statistics.median(sharded_s),
            "one_card_seconds_runs": single_s, "one_card_seconds": statistics.median(single_s)})

    ks, ss = seeded_ints(44, n_msm, P.R_SCALAR), seeded_ints(45, n_msm, P.R_SCALAR)
    jac = curve.mul(g1s, curve.one(g1s, (n_msm,), device), fp.to_device(fp.FR, ks, device))
    points = curve.from_device(g1s, curve.to_affine(g1s, jac) + (fp.ones(fp.FQ, (n_msm,), device),))
    total, sharded_s = clock(lambda: dist.sharded_msm(points, ss, device=device))
    alone, alone_s = clock(lambda: msm.msm(points, ss, device=device))
    expect = O.g1_mul(O.G1_ONE, sum(s * k for s, k in zip(ss, ks)) % P.R_SCALAR)
    for name, res in (("sharded_msm", total), ("msm on one card", alone)):
        if not O.g_eq(O.FQ_OPS, curve.from_device(g1s, res)[0], expect):
            raise SystemExit(f"rank {rank}: {name} differs from the oracle")
    report({"check": "sharded_msm", "points": n_msm, "c": msm.auto_c(n_msm // n_dev), "oracle_exact": True,
            "seconds_runs": sharded_s, "seconds": statistics.median(sharded_s),
            "one_card_c": msm.auto_c(n_msm), "one_card_seconds_runs": alone_s,
            "one_card_seconds": statistics.median(alone_s)})
    tdist.destroy_process_group()


def main():
    args = sys.argv[1:]
    on_cpu = bool(args) and args[0] == "--cpu"
    args = args[1:] if on_cpu else args
    if on_cpu:
        n_dev, sizes, card = int(args[0]) if args else 4, (8, 16), "cpu (rehearsal, no device numbers)"
    else:
        if not torch.cuda.is_available():
            sys.exit("needs CUDA devices (or --cpu N to rehearse)")
        n_dev = int(args[0]) if args else torch.cuda.device_count()
        if n_dev < 2 or torch.cuda.device_count() < n_dev:
            sys.exit(f"needs at least 2 cards and no more than the {torch.cuda.device_count()} this host has")
        sizes = (8192, 1 << 16)
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              check=True, capture_output=True, text=True).stdout.strip().splitlines()
        build.build_all()  # once, before the ranks load the libraries
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(rank_main, args=(n_dev, port, on_cpu, sizes, card), nprocs=n_dev)
    print(card if on_cpu else card[0], flush=True)


if __name__ == "__main__":
    main()
