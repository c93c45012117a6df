#!/usr/bin/env python3
"""Where a block of csrc/kernel_fq12_mul.cu's team spends its time on the card.

Builds, with the package's flags for kernel_fq12_mul.cu, a kernel that runs
the package's team block (fq12_mul_team_block in csrc/fq12_team.cuh, the body
of k_fq12_mul) with marks that read the multiprocessor's cycle counter
(clock64) in every warp at the block's four marks: at the start, after the
warp's member has written its Fq2 product to shared memory, after the barrier,
and after the combine (warps 0-5) or at once (the rest).  A second instance
swaps the member for one that does the same loads and pre-sums but adds its
two operands instead of multiplying them, so that the member phase splits into
loads and pre-sums against the three Montgomery products.  For each batch it prints one
JSON line per instance: the kernel's time (CUDA events, 50 launches after a
warm-up, the instances in turns), and over all blocks the median cycles of
the member phase (slowest and mean warp of a block), of the wait at the
barrier (from the slowest member's arrival to the release), of the combine,
and of the block from its first warp's start to its last warp's end; with
the SM clock nvidia-smi reads right after, and the limbs' equality with the
package's fq12_mul.  A batch of 32 is one block alone on the card.

Run from the repository root on a machine with a GPU and nvcc:
    python3 tools/torch_fq12_team_phases.py [B ...]      (default: 32 8192)
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bn_tpu_torch import params as P  # noqa: E402
from bn_tpu_torch.ops import build  # noqa: E402
from bn_tpu_torch.ops import mont_cuda as mc  # noqa: E402
from bn_tpu_torch.ops import tower_cuda as tc  # noqa: E402

SOURCE = r"""
#include "launch.cuh"
#include "fq12_team.cuh"

// the member's loads and pre-sums, with an addition in place of its product
struct SumMember {
  __device__ __forceinline__ Fq2 operator()(int w, const int32_t* a, const int32_t* b, int64_t stride,
                                            const Mod& m) const {
    int k = w / 6, j = w % 6;
    return fq2_add(fq12_team_operand(a, stride, k, j, m), fq12_team_operand(b, stride, k, j, m), m);
  }
};

struct ClockMarks {
  long long t[4];
  __device__ __forceinline__ void operator()(int i) {
    if (i == 3) __syncwarp();  // the warp's last lane done
    t[i] = clock64();
  }
};

template <class Member>
__global__ void __launch_bounds__(BN_TEAM_LANES * BN_TEAM_MEMBERS, 1)
k_phases(const int32_t* __restrict__ a, const int32_t* __restrict__ b, int32_t* __restrict__ o,
         int64_t rows, int64_t B, Mod m, long long* __restrict__ clocks) {
  ClockMarks marks;
  fq12_mul_team_block(a, b, o, rows, B, m, Member(), marks);
  if (threadIdx.x % BN_TEAM_LANES == 0) {
    long long* c = clocks + ((int64_t)blockIdx.x * BN_TEAM_MEMBERS + threadIdx.x / BN_TEAM_LANES) * 4;
    for (int i = 0; i < 4; i++) c[i] = marks.t[i];
  }
}

extern "C" int bn_phases(int products, const void* a, const void* b, void* o, long long rows, long long B,
                         const uint32_t* mod, uint32_t inv, void* clocks, void* stream) {
  unsigned grid = bn_grid(rows * B, BN_TEAM_LANES);
  if (products)
    k_phases<Fq12MulMember><<<grid, BN_TEAM_LANES * BN_TEAM_MEMBERS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)a, (const int32_t*)b, (int32_t*)o, rows, B, bn_make_mod(mod, inv), (long long*)clocks);
  else
    k_phases<SumMember><<<grid, BN_TEAM_LANES * BN_TEAM_MEMBERS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)a, (const int32_t*)b, (int32_t*)o, rows, B, bn_make_mod(mod, inv), (long long*)clocks);
  return (int)cudaGetLastError();
}
"""
MEMBERS, LANES = 18, 32


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    batches = [int(x) for x in sys.argv[1:]] or [32, 8192]
    dev = torch.device("cuda")
    card = smi("name,power.limit")
    out_dir = build.BUILD / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, so = out_dir / "fq12_team_phases.cu", out_dir / "libfq12_team_phases.so"
    src.write_text(SOURCE)
    proc = build.compile_start("kernel_fq12_mul", so, src=src)
    log, _ = proc.communicate()
    if proc.returncode != 0:
        sys.exit(f"nvcc failed:\n{log}")
    fn = ctypes.CDLL(str(so)).bn_phases
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    words, inv32 = mc._mod_args(P.Q)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(11)

    for batch in batches:
        vals = [int.from_bytes(rng.bytes(40), "big") % P.Q for _ in range(2 * 12 * batch)]
        limbs = P.ints_to_limbs(vals).astype(np.int32).reshape(16, 2, 2, 3, 2, batch)
        a, b = (torch.from_numpy(np.ascontiguousarray(np.moveaxis(limbs[:, i], 0, -2))).to(dev) for i in range(2))
        o = torch.empty_like(a)
        blocks = (batch + LANES - 1) // LANES
        clocks = torch.zeros((blocks, MEMBERS, 4), dtype=torch.int64, device=dev)
        ms = {True: [], False: []}

        def run(products):
            args = [int(products), a.data_ptr(), b.data_ptr(), o.data_ptr(), 1, batch, words, inv32,
                    clocks.data_ptr(), stream]
            if fn(*args) != 0:
                sys.exit("the phase kernel was not launched")
            torch.cuda.synchronize()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(50):
                fn(*args)
            t1.record()
            torch.cuda.synchronize()
            ms[products].append(t0.elapsed_time(t1) / 50)
            return clocks.cpu().numpy().copy()  # of the last launch

        res = {}
        for products in (True, False, False, True):
            res[products] = run(products)
            if products:
                same = bool(torch.equal(o, tc.fq12_mul(a, b, P.Q)))
        sm_clock = smi("clocks.sm")
        for products in (True, False):
            c = res[products]  # (blocks, warps, 4)
            member = c[:, :, 1] - c[:, :, 0]
            print(json.dumps({
                "batch": batch, "instance": "products" if products else "loads and pre-sums only",
                "ms": ms[products], "blocks": blocks,
                "member_cycles_slowest_warp": float(np.median(member.max(axis=1))),
                "member_cycles_mean_warp": float(np.median(member.mean(axis=1))),
                "barrier_wait_cycles": float(np.median(c[:, :, 2].max(axis=1) - c[:, :, 1].max(axis=1))),
                "combine_cycles": float(np.median((c[:, :6, 3] - c[:, :6, 2]).max(axis=1))),
                "block_cycles": float(np.median(c[:, :, 3].max(axis=1) - c[:, :, 0].min(axis=1))),
                "sm_clock_after": sm_clock, "equals_fq12_mul": same if products else None, "card": card,
            }), flush=True)


if __name__ == "__main__":
    main()
