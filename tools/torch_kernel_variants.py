#!/usr/bin/env python3
"""Compare builds of the port's Fq12-sized, Miller-step, step and curve kernels on
the card.  For the team kernels, the team design against the one-thread
design it replaced (a source this tool keeps, the product out of line):
fq12_mul (18 warps on 32 elements, lazy reduction; THREAD_SOURCE);
fq12_mul024_pre (13 warps; MUL024_THREAD_SOURCE) and fq12_sq (12 warps;
SQ_THREAD_SOURCE), __launch_bounds__ for 2 blocks a multiprocessor, also
against the team with registers for one block; fq12_cyclo_sq_chain (6 warps, __launch_bounds__ for 2 blocks
a multiprocessor; CHAIN_THREAD_SOURCE), also against the team with registers
for 3 blocks and the team with the product inlined, at n = 1, 2 and 5
squarings; double_step and madd_step (4 warps on 32 elements, __launch_bounds__
for 2 blocks a multiprocessor; STEP_THREAD_SOURCE, one source for both);
fq12_cyclo_sq (6 warps on fq12_team_block, one barrier;
CYCLO_SQ_THREAD_SOURCE), also against the chain's block at n = 1
(CYCLO_SQ_CHAIN_BLOCK_SOURCE); pow_fixed (a group of 4 lanes an element,
csrc/fq_group.cuh; POW_THREAD_SOURCE), also with groups of 8 lanes;
fq12_mul024 (fq12_mul024_pre's team on the unscaled line;
MUL024_LINE_THREAD_SOURCE), also with registers for one block; both
instances of miller_step (13 warps, csrc/miller_step_team.cuh;
MILLER_THREAD_SOURCE, the labels "miller_step square" and "miller_step no
square"), also with registers for one block in both instances and for two
in both; point_add and point_double for G1 and G2 (the labels "point_add
G1", ...), the team of csrc/curve_team.cuh against the one-thread design,
both in the package's library and picked by the C entry's design argument,
and for G2 also the team with each Fq2 product's Karatsuba products on
three warps in place of one whole Fq2 product a warp (KARATSUBA_TEAM_SOURCE);
time them
at the widths of ops/curve_cuda.py's crossover with --graph --batch 1 8192
8448 10240 12288 16384 32768 65536 262144 1048576 (1: the MSM's Horner
doublings; 8448: one wave of the team's blocks on 132 multiprocessors).
The kernels of kernels_fq.cu (mont_mul, mod_add, mod_sub, mod_neg,
fq2_mul, fq2_sq, fq2_xi, at the main path's shapes: FLAT_ROWS elements a
lane; fq2_sq is a team of two warps on 32 elements) have the package's
build alone, with --parent also the parent checkout's, mont_mul also the
Montgomery product as lo/hi carry chains (LOHI_SOURCE) against fq.cuh's
product on two arrays of even and odd products.  Every label has the variant
"package": the package's source with ops/build.py's SOURCE_FLAGS (for a
team the same build as "team").

For each kernel and each variant it prints one JSON line:
nvcc's build time, what `ptxas -v` reports for the source's entries (registers,
stack, spills, static shared memory), the kernel's time at each batch (CUDA
events, 50 launches after a warm-up, or with --graph one replay of the 50
captured as a CUDA graph, variants in turns: a, b, b, a, or a, b, c,
c, b, a; with --turns N that sequence N times), and whether every variant
returns the first one's limbs.  --parent DIR adds to every picked kernel
the build "parent": the same source file, with the flags that checkout's
ops/build.py gives it, from the checkout DIR
(an unpacked parent commit), for the before-and-after of a change (for a
curve label also "parent_thread", its one-thread design); --only VAR ...
keeps those variants alone (e.g. --only package parent); with --together,
--pairing swaps all picked kernels at once (the package's builds against
the parent's, say).  --build-only builds the picked variants, prints what
ptxas reports for each entry (and with --sass the SASS counts) and times
nothing.
With --pairing it then times `ate.pairing_batch` at B = 8192 with the
package's build of each picked kernel swapped for its other builds (a
team's one-thread build, the parent's),
one kernel at a time, and, when fq12_mul024_pre and fq12_sq are both picked,
the two together (the Miller loop's two kernels), likewise double_step with
madd_step (the precompute's two) and pow_fixed with fq12_cyclo_sq (the two
redesigned together), in turns (team, thread,
thread, team), in the three configurations of
tools/torch_pairing_profile.py, and prints one JSON line per build and
configuration.  Each turn, after a warm-up: CUDA events around 3 eager calls
(the host's pace included), the device-busy time of one call under
torch.profiler (the sum of its kernels' times), and CUDA events around 3
replays of one call captured as a CUDA graph (the card's pace: no Python
between launches); and whether every result equals the team's.
With --ladder it times curve.mul of G1 and of G2 at B = 8192 with every
curve launch of the team design, then of the one-thread design: each
captured once as a CUDA graph and replayed in turns (team, thread, thread,
team, three times: median of 6), and the curve kernels' device time in an
eager call under torch.profiler; one JSON line per group and design.
--sass also gives each function's instructions.  Run from the repository
root on a machine with a GPU and nvcc:
    python3 tools/torch_kernel_variants.py [kernel ...] [--batch B ...] [--pairing]
        [--turns N] [--parent DIR] [--only VAR ...] [--together] [--ladder] [--sass] [--build-only]
where the optional labels (e.g. fq12_mul) pick kernels, all by default
(none with --ladder alone), and
--batch the batch sizes, B = 8192 (the main path's) by default.  A batch of
32 is one block of a team alone on the card; 132 * 32 = 4224 one block on
each multiprocessor, 8448 two; for pow_fixed, 16384 is the two inversions of
`to_affine` in one launch.
"""

import argparse
import ast
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bn_tpu_torch import ate, curve  # noqa: E402
from bn_tpu_torch import params as P  # noqa: E402
from bn_tpu_torch.fields import fp  # noqa: E402
from bn_tpu_torch.ops import backend, build  # noqa: E402
from bn_tpu_torch.ops import curve_cuda as cc  # noqa: E402
from bn_tpu_torch.ops import mont_cuda as mc  # noqa: E402
from bn_tpu_torch.ops import tower_cuda as tc  # noqa: E402

B = 8192  # the main path's batch, and the number of distinct values the inputs draw from
VARIANTS = {"package": []}  # the one-thread kernels of kernels_fq.cu: the package's build alone
# kernels whose variants are others than VARIANTS
OWN_VARIANTS = {
    # fq.cuh's product (two arrays of even and odd products) against the lo/hi chains of LOHI_SOURCE
    "mont_mul": {"package": [], "lohi": []},
    "fq12_mul": {
        "team": [],  # whole products and reductions of its own: no Montgomery product to put out of line
        "thread": ["-DBN_MUL_OUT_OF_LINE"],
    },
    "fq12_mul024_pre": {
        "team": ["-DBN_MUL_OUT_OF_LINE"],
        "thread": ["-DBN_MUL_OUT_OF_LINE"],
        "team_1_block": ["-DBN_MUL_OUT_OF_LINE", "-DBN_MUL024_MIN_BLOCKS=1"],
    },
    "fq12_sq": {
        "team": ["-DBN_MUL_OUT_OF_LINE"],
        "thread": ["-DBN_MUL_OUT_OF_LINE"],
        "team_1_block": ["-DBN_MUL_OUT_OF_LINE", "-DBN_SQ_MIN_BLOCKS=1"],
    },
    "fq12_cyclo_sq_chain": {
        "team": ["-DBN_MUL_OUT_OF_LINE"],
        "thread": ["-DBN_MUL_OUT_OF_LINE"],
        "team_inline": [],
        "team_3_blocks": ["-DBN_MUL_OUT_OF_LINE", "-DBN_CYCLO_MIN_BLOCKS=3"],
    },
    **{step: {
        "team": ["-DBN_MUL_OUT_OF_LINE"],
        "thread": ["-DBN_MUL_OUT_OF_LINE"],
    } for step in ("double_step", "madd_step")},
    "fq12_cyclo_sq": {
        "team": ["-DBN_MUL_OUT_OF_LINE"],
        "thread": ["-DBN_MUL_OUT_OF_LINE"],
        "team_chain_block": ["-DBN_MUL_OUT_OF_LINE"],
    },
    "pow_fixed": {
        "team": [],  # groups of 4 lanes
        "thread": [],
        "lanes_8": ["-DBN_POW_LANES=8"],
    },
    "fq12_mul024": {
        "team": ["-DBN_MUL_OUT_OF_LINE"],
        "thread": ["-DBN_MUL_OUT_OF_LINE"],
        "team_1_block": ["-DBN_MUL_OUT_OF_LINE", "-DBN_MUL024_MIN_BLOCKS=1"],
    },
    **{label: {
        "team": ["-DBN_MUL_OUT_OF_LINE"],
        "thread": ["-DBN_MUL_OUT_OF_LINE"],
        "team_1_block": ["-DBN_MUL_OUT_OF_LINE", "-DBN_MILLER_SQ_MIN_BLOCKS=1", "-DBN_MILLER_MIN_BLOCKS=1"],
        "team_2_blocks": ["-DBN_MUL_OUT_OF_LINE", "-DBN_MILLER_SQ_MIN_BLOCKS=2", "-DBN_MILLER_MIN_BLOCKS=2"],
    } for label in ("miller_step square", "miller_step no square")},
    # the curve kernels' two designs are one library: the C entry's design
    # argument picks (CURVE_DESIGN_ARG); over Fq2 also the team with each Fq2
    # product's Karatsuba products on warps of their own (KARATSUBA_TEAM_SOURCE)
    **{f"{name} {group}": {
        "team": ["-DBN_MUL_OUT_OF_LINE"],
        "thread": ["-DBN_MUL_OUT_OF_LINE"],
        **({"team_fq_a_warp": ["-DBN_MUL_OUT_OF_LINE"]} if group == "G2" else {}),
    } for name in ("point_add", "point_double") for group in ("G1", "G2")},
}
# the design argument each variant of a curve label passes (csrc/kernels_curve.cu)
CURVE_DESIGN_ARG = {"team": 1, "thread": 0, "team_fq_a_warp": 1, "package": 1, "parent": 1, "parent_thread": 0}
CURVE_LABELS = tuple(f"{n} {g}" for n in ("point_add", "point_double") for g in ("G1", "G2"))
# variants built from another source than csrc/<stem>.cu
THREAD_SOURCE = r"""
// fq12_mul as one thread per element, 64 threads a block: the design of
// csrc/kernel_fq12_mul.cu before its team, the baseline the team is timed
// against, with the same entry and kernel name.
#include "launch.cuh"
#include "tower.cuh"

__global__ void __launch_bounds__(64)
k_fq12_mul(const int32_t* __restrict__ a, const int32_t* __restrict__ b, int32_t* __restrict__ o,
           int64_t rows, int64_t B, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t off = (t / B) * 12 * BN_NLIMB * B + (t % B);
  fq12_store(o + off, B, fq12_mul(fq12_load(a + off, B), fq12_load(b + off, B), m));
}

extern "C" int bn_fq12_mul(const void* a, const void* b, void* o, long long rows, long long B,
                           const uint32_t* mod, uint32_t inv, void* stream) {
  k_fq12_mul<<<bn_grid(rows * B, 64), 64, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)o, rows, B, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}
"""
MUL024_THREAD_SOURCE = r"""
// fq12_mul024_pre as one thread per element, 64 threads a block: the design of
// csrc/kernel_fq12_mul024_pre.cu before its team, the baseline the team is
// timed against, with the same entry and kernel name.
#include "launch.cuh"
#include "tower.cuh"

__global__ void __launch_bounds__(64)
k_fq12_mul024_pre(const int32_t* __restrict__ f, const int32_t* __restrict__ ell0,
                  const int32_t* __restrict__ scaled, int32_t* __restrict__ o, int64_t rows,
                  int64_t B, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t row = t / B, b = t % B;
  int64_t off = row * 12 * BN_NLIMB * B + b;
  Fq12 a = fq12_load(f + off, B);
  Fq2 x0 = fq2_load(ell0 + row * 2 * BN_NLIMB * B + b, B);
  const int32_t* s = scaled + row * 4 * BN_NLIMB * B + b;
  Fq2 x4 = fq2_load(s, B);                     // ell_vw * g1.y
  Fq2 x2 = fq2_load(s + 2 * BN_NLIMB * B, B);  // ell_vv * g1.x
  fq12_store(o + off, B, fq12_mul_by_024(a, x0, x2, x4, m));
}

extern "C" int bn_fq12_mul024_pre(const void* f, const void* ell0, const void* scaled, void* o,
                                  long long rows, long long B, const uint32_t* mod, uint32_t inv,
                                  void* stream) {
  k_fq12_mul024_pre<<<bn_grid(rows * B, 64), 64, 0, (cudaStream_t)stream>>>(
      (const int32_t*)f, (const int32_t*)ell0, (const int32_t*)scaled, (int32_t*)o, rows, B,
      bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}
"""
SQ_THREAD_SOURCE = r"""
// fq12_sq as one thread per element, 64 threads a block: the design of
// csrc/kernel_fq12_sq.cu before its team, the baseline the team is timed
// against, with the same entry and kernel name.
#include "launch.cuh"
#include "tower.cuh"

__global__ void __launch_bounds__(64)
k_fq12_sq(const int32_t* __restrict__ a, int32_t* __restrict__ o, int64_t rows, int64_t B, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t off = (t / B) * 12 * BN_NLIMB * B + (t % B);
  fq12_store(o + off, B, fq12_sq(fq12_load(a + off, B), m));
}

extern "C" int bn_fq12_sq(const void* a, void* o, long long rows, long long B,
                          const uint32_t* mod, uint32_t inv, void* stream) {
  k_fq12_sq<<<bn_grid(rows * B, 64), 64, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)o, rows, B, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}
"""
CHAIN_THREAD_SOURCE = r"""
// fq12_cyclo_sq_chain as one thread per element, 64 threads a block: the
// design of csrc/kernel_fq12_cyclo_sq_chain.cu before its team, the baseline
// the team is timed against, with the same entry and kernel name.  One thread
// loads its element once, squares it n times in registers (fq12_cyclo_sq in
// tower.cuh) and stores it once.
#include "launch.cuh"
#include "tower.cuh"

__global__ void __launch_bounds__(64)
k_fq12_cyclo_sq_chain(const int32_t* __restrict__ a, int32_t* __restrict__ o, int64_t rows, int64_t B,
                      int n, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t off = (t / B) * 12 * BN_NLIMB * B + (t % B);
  Fq12 v = fq12_load(a + off, B);
#pragma unroll 1
  for (int i = 0; i < n; i++) v = fq12_cyclo_sq(v, m);
  fq12_store(o + off, B, v);
}

extern "C" int bn_fq12_cyclo_sq_chain(const void* a, void* o, long long rows, long long B, int n,
                                      const uint32_t* mod, uint32_t inv, void* stream) {
  k_fq12_cyclo_sq_chain<<<bn_grid(rows * B, 64), 64, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)o, rows, B, n, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}
"""
STEP_THREAD_SOURCE = r"""
// double_step and madd_step as one thread per element, 64 threads a block: the
// design of csrc/kernels_g2_step.cu before its teams, the baseline the teams
// are timed against, with the same entries and kernel names.  One thread
// loads its running point (and base), runs g2_double_step / g2_madd_step of
// tower.cuh in registers and stores the new point and the line.
#include "launch.cuh"
#include "tower.cuh"

__global__ void __launch_bounds__(64)
k_double_step(const int32_t* __restrict__ r, int32_t* __restrict__ r_out, int32_t* __restrict__ c_out,
              int64_t rows, int64_t B, Fq two_inv, Fq2 twist_b, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t off = (t / B) * 6 * BN_NLIMB * B + (t % B);
  G2Proj p = g2_load(r + off, B);
  EllCoeffs c;
  g2_double_step(p, c, two_inv, twist_b, m);
  g2_store(r_out + off, B, p);
  ell_store(c_out + off, B, c);
}

__global__ void __launch_bounds__(64)
k_madd_step(const int32_t* __restrict__ r, const int32_t* __restrict__ base, int32_t* __restrict__ r_out,
            int32_t* __restrict__ c_out, int64_t rows, int64_t B, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t row = t / B, b = t % B;
  int64_t off = row * 6 * BN_NLIMB * B + b;
  const int32_t* bp = base + row * 4 * BN_NLIMB * B + b;
  G2Proj p = g2_load(r + off, B);
  EllCoeffs c;
  g2_madd_step(p, c, fq2_load(bp, B), fq2_load(bp + 2 * BN_NLIMB * B, B), m);
  g2_store(r_out + off, B, p);
  ell_store(c_out + off, B, c);
}

static inline Fq bn_make_fq(const uint32_t* words) {
  Fq r;
  for (int i = 0; i < BN_NW; i++) r.w[i] = words[i];
  return r;
}

// The Montgomery form of 1/2, 2^255 mod q (R = 2^256): 1 doubled 255 times
// modulo q, on the host.  q < 2^254, so a doubling never carries out.
static Fq bn_two_inv_mont(const uint32_t* q) {
  Fq x = {};
  x.w[0] = 1;
  for (int k = 0; k < 255; k++) {
    uint32_t carry = 0;
    for (int i = 0; i < BN_NW; i++) {
      const uint32_t hi = x.w[i] >> 31;
      x.w[i] = (x.w[i] << 1) | carry;
      carry = hi;
    }
    int ge = 1;  // x >= q, from the top word down
    for (int i = BN_NW - 1; i >= 0; i--)
      if (x.w[i] != q[i]) {
        ge = x.w[i] > q[i];
        break;
      }
    if (!ge) continue;
    uint64_t borrow = 0;
    for (int i = 0; i < BN_NW; i++) {
      const uint64_t d = (uint64_t)x.w[i] - q[i] - borrow;
      x.w[i] = (uint32_t)d;
      borrow = d >> 63;
    }
  }
  return x;
}

extern "C" int bn_double_step(const void* r, void* r_out, void* c_out, long long rows, long long B,
                              const uint32_t* twist_b, const uint32_t* mod, uint32_t inv, void* stream) {
  Fq2 tb;
  tb.c0 = bn_make_fq(twist_b);
  tb.c1 = bn_make_fq(twist_b + BN_NW);
  k_double_step<<<bn_grid(rows * B, 64), 64, 0, (cudaStream_t)stream>>>(
      (const int32_t*)r, (int32_t*)r_out, (int32_t*)c_out, rows, B, bn_two_inv_mont(mod), tb,
      bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}

extern "C" int bn_madd_step(const void* r, const void* base, void* r_out, void* c_out, long long rows,
                            long long B, const uint32_t* mod, uint32_t inv, void* stream) {
  k_madd_step<<<bn_grid(rows * B, 64), 64, 0, (cudaStream_t)stream>>>(
      (const int32_t*)r, (const int32_t*)base, (int32_t*)r_out, (int32_t*)c_out, rows, B,
      bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}
"""
CYCLO_SQ_THREAD_SOURCE = r"""
// fq12_cyclo_sq as one thread per element, 64 threads a block: the design of
// csrc/kernel_fq12_cyclo_sq.cu before its team, the baseline the team is
// timed against, with the same entry and kernel name.  One thread runs
// fq12_cyclo_sq of tower.cuh, 18 products, in registers.
#include "launch.cuh"
#include "tower.cuh"

__global__ void __launch_bounds__(64)
k_fq12_cyclo_sq(const int32_t* __restrict__ a, int32_t* __restrict__ o, int64_t rows, int64_t B, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t off = (t / B) * 12 * BN_NLIMB * B + (t % B);
  fq12_store(o + off, B, fq12_cyclo_sq(fq12_load(a + off, B), m));
}

extern "C" int bn_fq12_cyclo_sq(const void* a, void* o, long long rows, long long B,
                                const uint32_t* mod, uint32_t inv, void* stream) {
  k_fq12_cyclo_sq<<<bn_grid(rows * B, 64), 64, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)o, rows, B, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}
"""
CYCLO_SQ_CHAIN_BLOCK_SOURCE = r"""
// fq12_cyclo_sq as the squaring chain's block at n = 1 (fq12_cyclo_team_block
// of csrc/fq12_cyclo_team.cuh): the element loaded into a shared state, the 6
// members, the combines in place, the store; three barriers.  The other way
// to build the single squaring's team, timed against the package's.
#include "launch.cuh"
#include "fq12_cyclo_team.cuh"

__global__ void __launch_bounds__(BN_CYCLO_BLOCK, BN_CYCLO_MIN_BLOCKS)
k_fq12_cyclo_sq(const int32_t* __restrict__ a, int32_t* __restrict__ o, int64_t rows, int64_t B, Mod m) {
  TeamNoMarks marks;
  fq12_cyclo_team_block(a, o, rows, B, 1, m, Fq12CycloMember(), marks);
}

extern "C" int bn_fq12_cyclo_sq(const void* a, void* o, long long rows, long long B,
                                const uint32_t* mod, uint32_t inv, void* stream) {
  k_fq12_cyclo_sq<<<bn_grid(rows * B, BN_TEAM_LANES), BN_CYCLO_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)o, rows, B, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}
"""
POW_THREAD_SOURCE = r"""
// pow_fixed as one thread per element, 64 threads a block: the design of
// csrc/kernel_pow_fixed.cu before its group, the baseline the group is timed
// against, with the same entry and kernel name.  One thread runs the whole
// window-4 ladder (fq_pow_fixed of fq.cuh, the product inlined), its table in
// 32 KB of static shared memory as [entry][word][thread].
#include "launch.cuh"

#define BN_BLOCK_POW 64

__global__ void __launch_bounds__(BN_BLOCK_POW)
k_pow_fixed(const int32_t* __restrict__ a, int32_t* __restrict__ o, int64_t rows, int64_t B, Exp e,
            Fq one, Mod m) {
  __shared__ uint32_t tab[16 * BN_NW * BN_BLOCK_POW];
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t off = (t / B) * BN_NLIMB * B + (t % B);
  Fq r = fq_pow_fixed(fq_load(a + off, B), one, e, tab + threadIdx.x, BN_BLOCK_POW, m);
  fq_store(o + off, B, r);
}

extern "C" int bn_pow_fixed(const void* a, void* o, long long rows, long long B, const uint32_t* exp,
                            int nd, const uint32_t* one, const uint32_t* mod, uint32_t inv,
                            void* stream) {
  Exp e;
  Fq one_;
  for (int i = 0; i < BN_NW; i++) {
    e.w[i] = exp[i];
    one_.w[i] = one[i];
  }
  e.nd = nd;
  k_pow_fixed<<<bn_grid(rows * B, BN_BLOCK_POW), BN_BLOCK_POW, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)o, rows, B, e, one_, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}
"""
MUL024_LINE_THREAD_SOURCE = r"""
// Sparse line multiply with the line as the precompute emits it.  Replaces the
// Pallas TPU kernel fq12_mul024 (bn_tpu/ops/tower_pallas.py, body
// _fq12_mul024_body), which tower.fq12_mul_by_024 calls.
//
// f is an Fq12 element and `coeff` the (3, 2) struct (ell_0, ell_vw, ell_vv),
// unscaled; the product is f * ((ell_0 + ell_vv v) + ell_vw v w).  Against
// kernel_fq12_mul024_pre.cu only the loads differ: the unscaled struct holds
// ell_vw in slot 1 and ell_vv in slot 2, and fq12_mul_by_024 takes them as
// x4 and x2 (fq12_mul_by_line in tower.cuh).
//
// One thread owns one element and reduces after every product: 39 base-field
// products of 136 multiply-adds against (12 + 6 + 12) * 64 bytes moved per
// element, so integer multiply-add throughput bounds it on an H100.  Register
// pressure and block size as in kernel_fq12_mul.cu; built with
// -DBN_MUL_OUT_OF_LINE (ops/build.py) like the other Fq12 kernels.
#include "launch.cuh"
#include "tower.cuh"

#define BN_BLOCK12 64

__global__ void __launch_bounds__(BN_BLOCK12)
k_fq12_mul024(const int32_t* __restrict__ f, const int32_t* __restrict__ coeff, int32_t* __restrict__ o,
              int64_t rows, int64_t B, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t row = t / B, b = t % B;
  int64_t off = row * 12 * BN_NLIMB * B + b;
  EllCoeffs c = ell_load(coeff + row * 6 * BN_NLIMB * B + b, B);
  fq12_store(o + off, B, fq12_mul_by_line(fq12_load(f + off, B), c, m));
}

extern "C" int bn_fq12_mul024(const void* f, const void* coeff, void* o, long long rows, long long B,
                              const uint32_t* mod, uint32_t inv, void* stream) {
  k_fq12_mul024<<<bn_grid(rows * B, BN_BLOCK12), BN_BLOCK12, 0, (cudaStream_t)stream>>>(
      (const int32_t*)f, (const int32_t*)coeff, (int32_t*)o, rows, B, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}
"""
MILLER_THREAD_SOURCE = r"""
// One step of the Miller loop in one launch.  Replaces the Pallas TPU kernel
// miller_step (bn_tpu/ops/tower_pallas.py, body _miller_step_body, built as
// the two kinds miller_sq_step and miller_step), which bn_tpu/ate.py runs once
// per ladder step under BN_TPU_FUSED_MILLER=1.
//
// One thread owns one batch element: it loads f (an Fq12), the step's line
// coefficients (ell_0, ell_vw, ell_vv) as the precompute emitted them and the
// affine G1 point (px, py), squares f on a doubling step, scales ell_vw by py
// and ell_vv by px and multiplies the line in sparsely (fq12_miller_step in
// tower.cuh), then stores f.  The hoisted loop of ate.py does the same work in
// two launches a step (fq12_sq, fq12_mul024_pre) after one scaling of all 102
// steps; here f stays in registers between the square and the multiply.
//
// 79 base-field products of 136 multiply-adds with the square, 43 without,
// against (12 + 6 + 1 + 1 + 12) * 64 bytes moved per element: integer
// multiply-add throughput bounds it on an H100.  kSquare is a template
// parameter, so each kind is its own entry, and the C entry's `square` flag
// picks one, as kernels_curve.cu picks G1 or G2.  f, the coefficients and the
// two coordinates are 160 words a thread, more than the 255 registers hold
// with the square's temporaries: built with -DBN_MUL_OUT_OF_LINE
// (ops/build.py) like the other Fq12 kernels.  The result goes to a
// destination the wrapper names, never an operand (__restrict__).
#include "launch.cuh"
#include "tower.cuh"

#define BN_BLOCK12 64

template <bool kSquare>
__global__ void __launch_bounds__(BN_BLOCK12)
k_miller_step(const int32_t* __restrict__ f, const int32_t* __restrict__ coeff, const int32_t* __restrict__ px,
              const int32_t* __restrict__ py, int32_t* __restrict__ o, int64_t rows, int64_t B, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t row = t / B, b = t % B;
  int64_t off = row * 12 * BN_NLIMB * B + b;
  int64_t off1 = row * BN_NLIMB * B + b;
  EllCoeffs c = ell_load(coeff + row * 6 * BN_NLIMB * B + b, B);
  Fq12 r = fq12_miller_step<kSquare>(fq12_load(f + off, B), c, fq_load(px + off1, B), fq_load(py + off1, B), m);
  fq12_store(o + off, B, r);
}

// square = 1: a doubling step (f^2 first); square = 0: an addition step.
extern "C" int bn_miller_step(const void* f, const void* coeff, const void* px, const void* py, void* o,
                              long long rows, long long B, int square, const uint32_t* mod, uint32_t inv,
                              void* stream) {
  unsigned grid = bn_grid(rows * B, BN_BLOCK12);
  cudaStream_t s = (cudaStream_t)stream;
  Mod m = bn_make_mod(mod, inv);
  if (square)
    k_miller_step<true><<<grid, BN_BLOCK12, 0, s>>>((const int32_t*)f, (const int32_t*)coeff, (const int32_t*)px,
                                                    (const int32_t*)py, (int32_t*)o, rows, B, m);
  else
    k_miller_step<false><<<grid, BN_BLOCK12, 0, s>>>((const int32_t*)f, (const int32_t*)coeff, (const int32_t*)px,
                                                     (const int32_t*)py, (int32_t*)o, rows, B, m);
  return (int)cudaGetLastError();
}
"""
KARATSUBA_TEAM_SOURCE = r"""
// The G2 teams of csrc/curve_team.cuh with each Fq2 product's Karatsuba
// products on warps of their own: the 3 Montgomery products of fq2_mul's
// Karatsuba form, or the 2 of fq2_sq's complex squaring, each into an Fq
// entry of its own, joined again by every reader (12 warps for the
// addition, L1's four Fq2 products of 3; 7 for the doubling, D0's
// 2 + 2 + 3).  The unit the issue of the redesign proposed for G2, kept as
// the baseline of the package's one whole Fq2 product a warp.  The
// package's kernels_curve.cu supplies the kernel, the launch and the
// one-thread design (its C entries renamed here); design 1 of the entries
// below launches this team.
#define bn_point_add bn_point_add_package
#define bn_point_double bn_point_double_package
#define bn_point_launch bn_point_launch_package
#include "kernels_curve.cu"
#undef bn_point_add
#undef bn_point_double
#undef bn_point_launch

BN_CONSTEXPR int k_parts(bool sq) { return sq ? 2 : 3; }

// Part j of the Fq2 product a b (a square has b = a).
BN_DEV Fq k_part(bool sq, int j, const Fq2& a, const Fq2& b, const Mod& m) {
  if (sq) return j == 0 ? fq_mont_mul(fq_add(a.c0, a.c1, m), fq_sub(a.c0, a.c1, m), m) : fq_mont_mul(a.c0, a.c1, m);
  if (j == 0) return fq_mont_mul(a.c0, b.c0, m);
  if (j == 1) return fq_mont_mul(a.c1, b.c1, m);
  return fq_mont_mul(fq_add(a.c0, a.c1, m), fq_add(b.c0, b.c1, m), m);
}

// The product joined from its parts at entry e.
BN_DEV Fq2 k_join(bool sq, const uint32_t* s, int e, const Mod& m) {
  const Fq p0 = fq_tab_load(s, BN_TEAM_LANES, e), p1 = fq_tab_load(s, BN_TEAM_LANES, e + 1);
  Fq2 r;
  if (sq) {
    r.c0 = p0;
    r.c1 = fq_add(p1, p1, m);
  } else {
    r.c0 = fq_sub(p0, p1, m);
    r.c1 = fq_sub(fq_sub(fq_tab_load(s, BN_TEAM_LANES, e + 2), p0, m), p1, m);
  }
  return r;
}

BN_CONSTEXPR int k_level_parts(int gl) {
  int n = 0;
  for (int k = curve_level_start(gl); k < curve_level_start(gl + 1); k++) n += k_parts(curve_is_sq(k));
  return n;
}

template <bool kAdd>
BN_CONSTEXPR int k_team_warps() {
  int w = 0;
  for (int gl = kAdd ? 0 : BN_CURVE_DOUBLE_LEVEL; gl < 8; gl++) w = k_level_parts(gl) > w ? k_level_parts(gl) : w;
  return w;
}

// The first state entry of product k: the inputs' coefficients first, then
// the parts of the team's products in order.
template <bool kAdd>
BN_CONSTEXPR int k_entry(int k) {
  int e = (kAdd ? 6 : 3) * 2;
  for (int j = kAdd ? C_Z1S : C_A; j < k; j++) e += k_parts(curve_is_sq(j));
  return e;
}

template <bool kAdd>
struct KaratsubaTeam {
  using F = Fq2;
  static constexpr int W = 2;
  static constexpr int kInputs = kAdd ? 6 : 3;
  static constexpr int kFirstLevel = kAdd ? 0 : BN_CURVE_DOUBLE_LEVEL;
  static constexpr int kLevels = 8 - kFirstLevel;
  static constexpr int kWarps = k_team_warps<kAdd>();
  static constexpr int kPhases = kLevels + 1;
  static constexpr int kEntries = k_entry<kAdd>(C_PRODUCTS);
  static constexpr int kFlagWarp = k_level_parts(3);  // the first warp idle at L3 (and L4)
  struct Shared {
    uint32_t state[kEntries][BN_NW][BN_TEAM_LANES];
    uint32_t flag[BN_TEAM_LANES];
    uint32_t any;
  };
  const int32_t* in[kInputs];
  int32_t* out[3];

  static BN_DEV F input(const uint32_t* s, int k) { return CurveFromState<F>{s}(k); }
  static BN_DEV F val(const uint32_t* s, int k, const Mod& m) { return k_join(curve_is_sq(k), s, k_entry<kAdd>(k), m); }
  static BN_DEV F h_of(const uint32_t* s, const Mod& m) { return ct_sub(val(s, C_U2, m), val(s, C_U1, m), m); }
  static BN_DEV F r_of(const uint32_t* s, const Mod& m) {
    return ct_dbl(ct_sub(val(s, C_S2, m), val(s, C_S1, m), m), m);
  }
  static BN_DEV F add_x3(const uint32_t* s, const Mod& m) {
    return ct_sub(ct_sub(val(s, C_RR, m), val(s, C_J, m), m), ct_dbl(val(s, C_V, m), m), m);
  }
  static BN_DEV F dbl_e(const uint32_t* s, const Mod& m) {
    const F a = val(s, C_A, m);
    return ct_add(ct_dbl(a, m), a, m);
  }
  static BN_DEV F dbl_d(const uint32_t* s, const Mod& m) {
    return ct_dbl(ct_sub(ct_sub(val(s, C_XB2, m), val(s, C_A, m), m), val(s, C_C, m), m), m);
  }
  static BN_DEV F dbl_x3(const uint32_t* s, const Mod& m) {
    return ct_sub(val(s, C_EE, m), ct_dbl(dbl_d(s, m), m), m);
  }

  template <class In>
  static BN_DEV void operands(int k, const In& in, const uint32_t* s, F& a, F& b, const Mod& m) {
    switch (k) {
      case C_Z1S: a = in(2); b = a; break;
      case C_Z2S: a = in(5); b = a; break;
      case C_ZZ: a = ct_add(in(2), in(5), m); b = a; break;
      case C_U1: a = in(0); b = val(s, C_Z2S, m); break;
      case C_U2: a = in(3); b = val(s, C_Z1S, m); break;
      case C_Z1C: a = in(2); b = val(s, C_Z1S, m); break;
      case C_Z2C: a = in(5); b = val(s, C_Z2S, m); break;
      case C_S1: a = in(1); b = val(s, C_Z2C, m); break;
      case C_S2: a = in(4); b = val(s, C_Z1C, m); break;
      case C_I: a = ct_dbl(h_of(s, m), m); b = a; break;
      case C_Z3: a = ct_sub(ct_sub(val(s, C_ZZ, m), val(s, C_Z1S, m), m), val(s, C_Z2S, m), m); b = h_of(s, m); break;
      case C_J: a = h_of(s, m); b = val(s, C_I, m); break;
      case C_V: a = val(s, C_U1, m); b = val(s, C_I, m); break;
      case C_RR: a = r_of(s, m); b = a; break;
      case C_S1J: a = val(s, C_S1, m); b = val(s, C_J, m); break;
      case C_RV: a = r_of(s, m); b = ct_sub(val(s, C_V, m), add_x3(s, m), m); break;
      case C_A: a = in(0); b = a; break;
      case C_B: a = in(1); b = a; break;
      case C_YZ: a = in(1); b = in(2); break;
      case C_C: a = val(s, C_B, m); b = a; break;
      case C_XB2: a = ct_add(in(0), val(s, C_B, m), m); b = a; break;
      case C_EE: a = dbl_e(s, m); b = a; break;
      default: a = dbl_e(s, m); b = ct_sub(dbl_d(s, m), dbl_x3(s, m), m); break;  // C_ED
    }
  }

  static BN_DEV F chord_out(int j, const uint32_t* s, const Mod& m) {
    if (j == 0) return add_x3(s, m);
    if (j == 1) return ct_sub(val(s, C_RV, m), ct_dbl(val(s, C_S1J, m), m), m);
    return val(s, C_Z3, m);
  }
  static BN_DEV F double_out(int j, const uint32_t* s, const Mod& m) {
    if (j == 0) return dbl_x3(s, m);
    if (j == 1) return ct_sub(val(s, C_ED, m), ct_dbl(ct_dbl(ct_dbl(val(s, C_C, m), m), m), m), m);
    return ct_dbl(val(s, C_YZ, m), m);
  }

  template <class In>
  BN_DEV void level(int gl, const TeamLane& t, const In& from, uint32_t* s, Shared& sh, const Mod& m) const {
    if (kAdd && gl >= BN_CURVE_DOUBLE_LEVEL && !sh.any) return;
    int first = 0;
#pragma unroll
    for (int k = curve_level_start(gl); k < curve_level_start(gl + 1); k++) {
      const int parts = k_parts(curve_is_sq(k));
      if (t.w >= first && t.w < first + parts) {
        F a, b;
        operands(k, from, s, a, b, m);
        fq_tab_store(s, BN_TEAM_LANES, k_entry<kAdd>(k) + t.w - first, k_part(curve_is_sq(k), t.w - first, a, b, m));
      }
      first += parts;
    }
    if (kAdd && gl == 3 && t.w == kFlagWarp) {
      const bool same = f_eq(val(s, C_U1, m), val(s, C_U2, m)) & f_eq(val(s, C_S1, m), val(s, C_S2, m));
      sh.flag[t.lane] = same & !f_is_zero(input(s, 2)) & !f_is_zero(input(s, 5));
    }
    if (kAdd && gl == 4 && t.w == kFlagWarp) {
      uint32_t any = 0;
#pragma unroll
      for (int l = 0; l < BN_TEAM_LANES; l++) any |= sh.flag[l];
      sh.any = any;
    }
  }

  BN_DEV void phase(int p, const TeamLane& t, int64_t B, Shared& sh, const Mod& m) const {
    uint32_t* s = &sh.state[0][0][0] + t.lane;
    if (p > 0 && p < kLevels) {
      level(kFirstLevel + p, t, CurveFromState<F>{s}, s, sh, m);
      return;
    }
    const int64_t off = curve_offset(t.e, B, W);
    if (p == 0) {
#pragma unroll
      for (int i = 0; i < (kInputs * W + kWarps - 1) / kWarps; i++) {
        const int c = t.w + i * kWarps;
        if (c < kInputs * W)
          fq_tab_store(s, BN_TEAM_LANES, c, fq_load(in[c / W] + off + (int64_t)(c % W) * BN_NLIMB * B, B));
      }
      level(kFirstLevel, t, CurveFromMemory<F>{in, off, B}, s, sh, m);
    } else if (t.live) {
      for (int c = t.w; c < 3 * W; c += kWarps) {
        const int j = c / W;
        F v;
        if (!kAdd) v = double_out(j, s, m);
        else if (f_is_zero(input(s, 5))) v = input(s, j);
        else if (f_is_zero(input(s, 2))) v = input(s, 3 + j);
        else if (sh.flag[t.lane]) v = double_out(j, s, m);
        else v = chord_out(j, s, m);
        fq_store(out[j] + off + (int64_t)(c % W) * BN_NLIMB * B, B, curve_coeff(v, c % W));
      }
    }
  }
};

template <bool kAdd>
static int karatsuba_team(const void* const* in, void* const* out, long long rows, long long B, const Mod& m,
                          cudaStream_t s) {
  KaratsubaTeam<kAdd> team;
  for (int k = 0; k < KaratsubaTeam<kAdd>::kInputs; k++) team.in[k] = (const int32_t*)in[k];
  for (int k = 0; k < 3; k++) team.out[k] = (int32_t*)out[k];
  return curve_team_launch(team, rows * B, B, m, s);
}

extern "C" {
int bn_point_add(const void* x1, const void* y1, const void* z1, const void* x2, const void* y2,
                 const void* z2, void* ox, void* oy, void* oz, long long rows, long long B, int fq2,
                 int design, const uint32_t* mod, uint32_t inv, void* stream) {
  if (!fq2 || !design)
    return bn_point_add_package(x1, y1, z1, x2, y2, z2, ox, oy, oz, rows, B, fq2, design, mod, inv, stream);
  const void* in[6] = {x1, y1, z1, x2, y2, z2};
  void* out[3] = {ox, oy, oz};
  return karatsuba_team<true>(in, out, rows, B, bn_make_mod(mod, inv), (cudaStream_t)stream);
}

int bn_point_double(const void* x, const void* y, const void* z, void* ox, void* oy, void* oz,
                    long long rows, long long B, int fq2, int design, const uint32_t* mod, uint32_t inv,
                    void* stream) {
  if (!fq2 || !design) return bn_point_double_package(x, y, z, ox, oy, oz, rows, B, fq2, design, mod, inv, stream);
  const void* in[3] = {x, y, z};
  void* out[3] = {ox, oy, oz};
  return karatsuba_team<false>(in, out, rows, B, bn_make_mod(mod, inv), (cudaStream_t)stream);
}
}  // extern "C"
"""
LOHI_PRODUCT = r"""
// The Montgomery product as lo/hi carry chains: word-2^32 CIOS on one
// accumulator t[0..8], each row's a b_i and mu m as one chain of the low
// halves (words 0..7, its carry into word 8) and one of the high halves
// (words 1..8), on carry.cuh's primitives.  The plain form of CIOS on carry
// chains, kept as the baseline of fq.cuh's product on two arrays of even and
// odd products.  t < 2^288 while a row runs (t < 2m between rows), so no
// chain leaves word 8.
#include "launch.cuh"

BN_DEV void lohi_row(uint32_t* t, const uint32_t* v, uint32_t k) {
  Carry c;
  t[0] = mad_lo_cc(c, v[0], k, t[0]);
#pragma unroll
  for (int j = 1; j < BN_NW; j++) t[j] = madc_lo_cc(c, v[j], k, t[j]);
  t[BN_NW] = addc(c, t[BN_NW], 0u);
  Carry d;
  t[1] = mad_hi_cc(d, v[0], k, t[1]);
#pragma unroll
  for (int j = 1; j < BN_NW - 1; j++) t[j + 1] = madc_hi_cc(d, v[j], k, t[j + 1]);
  t[BN_NW] = madc_hi(d, v[BN_NW - 1], k, t[BN_NW]);
}

BN_DEV Fq mont_mul_lohi(const Fq& a, const Fq& b, const Mod& m) {
  uint32_t t[BN_NW + 1];
#pragma unroll
  for (int j = 0; j <= BN_NW; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < BN_NW; i++) {
    lohi_row(t, a.w, b.w[i]);
    lohi_row(t, m.w, t[0] * m.inv);
#pragma unroll
    for (int j = 0; j < BN_NW; j++) t[j] = t[j + 1];
    t[BN_NW] = 0;
  }
  Fq r;
#pragma unroll
  for (int j = 0; j < BN_NW; j++) r.w[j] = t[j];
  return fq_cond_sub(r, 0u, m);
}

"""
LOHI_SOURCE = LOHI_PRODUCT + r"""
// mont_mul on it, with the same entry as kernels_fq.cu's.
__global__ void __launch_bounds__(128)
k_mont_mul_lohi(const int32_t* __restrict__ a, const int32_t* __restrict__ b, int32_t* __restrict__ o,
                int64_t rows, int64_t B, Mod m) {
  int64_t t = bn_tid();
  if (t >= rows * B) return;
  int64_t off = (t / B) * BN_NLIMB * B + (t % B);
  fq_store(o + off, B, mont_mul_lohi(fq_load(a + off, B), fq_load(b + off, B), m));
}

extern "C" int bn_mont_mul(const void* a, const void* b, void* o, long long rows, long long B,
                           const uint32_t* mod, uint32_t inv, void* stream) {
  k_mont_mul_lohi<<<bn_grid(rows * B, 128), 128, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)o, rows, B, bn_make_mod(mod, inv));
  return (int)cudaGetLastError();
}
"""
# The product alone, for its SASS: one thread an element squares it n times in
# a loop that is not unrolled, so the loop's instructions are one product's
# and the loop's own three or so.  Built on the package's headers, on the
# parent's (--parent) and with LOHI_PRODUCT (BN_PRODUCT names the product).
PRODUCT_LOOP_SOURCE = r"""
#include "launch.cuh"
#ifndef BN_PRODUCT
#define BN_PRODUCT fq_mont_mul_inline
#endif

__global__ void k_product_loop(const int32_t* __restrict__ a, int32_t* __restrict__ o, int64_t B, int n, Mod m) {
  int64_t t = bn_tid();
  if (t >= B) return;
  Fq x = fq_load(a + t, B);
#pragma unroll 1
  for (int i = 0; i < n; i++) x = BN_PRODUCT(x, x, m);
  fq_store(o + t, B, x);
}
"""
OWN_SOURCES = {
    ("fq12_mul", "thread"): THREAD_SOURCE,
    ("fq12_mul024_pre", "thread"): MUL024_THREAD_SOURCE,
    ("fq12_sq", "thread"): SQ_THREAD_SOURCE,
    ("fq12_cyclo_sq_chain", "thread"): CHAIN_THREAD_SOURCE,
    ("double_step", "thread"): STEP_THREAD_SOURCE,
    ("madd_step", "thread"): STEP_THREAD_SOURCE,
    ("fq12_cyclo_sq", "thread"): CYCLO_SQ_THREAD_SOURCE,
    ("fq12_cyclo_sq", "team_chain_block"): CYCLO_SQ_CHAIN_BLOCK_SOURCE,
    ("pow_fixed", "thread"): POW_THREAD_SOURCE,
    ("fq12_mul024", "thread"): MUL024_LINE_THREAD_SOURCE,
    ("miller_step square", "thread"): MILLER_THREAD_SOURCE,
    ("miller_step no square", "thread"): MILLER_THREAD_SOURCE,
    ("point_add G2", "team_fq_a_warp"): KARATSUBA_TEAM_SOURCE,
    ("point_double G2", "team_fq_a_warp"): KARATSUBA_TEAM_SOURCE,
    ("mont_mul", "lohi"): LOHI_SOURCE,
}
PAIRING_VARIANTS = ("team", "thread", "package")  # the builds that --pairing swaps in, where a kernel has them
NOT_IN_PAIRING = ("fq12_mul024",)  # kernels pairing_batch never launches: --pairing does not swap them
# swapped together too when both are picked: the Miller loop's two teams, the precompute's two,
# the Fermat inversion's group with the single cyclotomic squaring
TEAM_PAIRS = (("fq12_mul024_pre", "fq12_sq"), ("double_step", "madd_step"), ("pow_fixed", "fq12_cyclo_sq"))
KERNELS = {  # label -> (entry, operand structs, number of outputs shaped like the first operand, own arguments)
    # the one-thread kernels of kernels_fq.cu at the main path's shapes (FLAT_ROWS elements a lane)
    "mont_mul": ("mont_mul", [(), ()], 1, ()),
    "mod_add": ("mod_add", [(2,), (2,)], 1, ()),
    "mod_sub": ("mod_sub", [(2,), (2,)], 1, ()),
    "mod_neg": ("mod_neg", [(2,)], 1, ()),
    "fq2_mul": ("fq2_mul", [(5, 2), (5, 2)], 1, ()),
    "fq2_sq": ("fq2_sq", [(2,)], 1, ()),
    "fq2_xi": ("fq2_xi", [(2,)], 1, ()),
    "fq12_mul": ("fq12_mul", [(2, 3, 2), (2, 3, 2)], 1, ()),
    "fq12_sq": ("fq12_sq", [(2, 3, 2)], 1, ()),
    "fq12_mul024_pre": ("fq12_mul024_pre", [(2, 3, 2), (2,), (2, 2)], 1, ()),
    "fq12_mul024": ("fq12_mul024", [(2, 3, 2), (3, 2)], 1, ()),
    "miller_step square": ("miller_step", [(2, 3, 2), (3, 2), (), ()], 1, (1,)),
    "miller_step no square": ("miller_step", [(2, 3, 2), (3, 2), (), ()], 1, (0,)),
    "fq12_cyclo_sq": ("fq12_cyclo_sq", [(2, 3, 2)], 1, ()),
    "fq12_cyclo_sq_chain": ("fq12_cyclo_sq_chain", [(2, 3, 2)], 1, (5,)),
    "double_step": ("double_step", [(3, 2)], 2, tc._step_const_args()),
    "madd_step": ("madd_step", [(3, 2), (2, 2)], 2, ()),
    # coordinates are random field elements, generic lanes: no doubling, no infinity
    "point_add G1": ("point_add", [()] * 6, 3, (0,)),
    "point_add G2": ("point_add", [(2,)] * 6, 3, (1,)),
    "point_double G1": ("point_double", [()] * 3, 3, (0,)),
    "point_double G2": ("point_double", [(2,)] * 3, 3, (1,)),
    # the Fermat inversion of the main path: e = q - 2, 64 digits
    "pow_fixed": ("pow_fixed", [()], 1, mc._pow_args(P.Q - 2, P.Q)),
}


# the flat kernels' rows: field elements (Fq2 elements for fq2_*) a lane of the batch
FLAT_ROWS = {"mod_add": 2, "mod_sub": 2, "mod_neg": 2, "fq2_mul": 5}


# labels timed with several sets of own arguments, in place of KERNELS': the
# chain at the shortest run of the checks, of the main path, and the longest
OWN_ARG_RUNS = {"fq12_cyclo_sq_chain": [(1,), (2,), (5,)]}


def source_flags_of(root: Path) -> dict:
    """SOURCE_FLAGS of the checkout at root (its bn_tpu_torch/ops/build.py),
    so that its kernels build as its own package builds them."""
    tree = ast.parse((root / "bn_tpu_torch" / "ops" / "build.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "SOURCE_FLAGS" for t in node.targets):
            return ast.literal_eval(node.value)
    return {}


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    ap = argparse.ArgumentParser()
    ap.add_argument("kernels", nargs="*", default=[])
    ap.add_argument("--batch", type=int, nargs="+", default=[B])
    ap.add_argument("--pairing", action="store_true",
                    help="time pairing_batch with each picked team kernel's team and one-thread builds swapped in")
    ap.add_argument("--sass", action="store_true",
                    help="count each build's SASS instructions (cuobjdump) and the instructions of its loops")
    ap.add_argument("--turns", type=int, default=1, help="times to run the sequence of turns")
    ap.add_argument("--parent", type=Path, help="a checkout whose build of each picked kernel is the variant 'parent'")
    ap.add_argument("--only", nargs="+", help="the variants to build and time, of those a kernel has")
    ap.add_argument("--together", action="store_true",
                    help="with --pairing, swap every picked kernel at once, in place of one at a time and in pairs")
    ap.add_argument("--graph", action="store_true",
                    help="time each kernel's 50 launches as a replayed CUDA graph, not as 50 launches from Python")
    ap.add_argument("--build-only", action="store_true",
                    help="build the picked variants, print what ptxas (and with --sass cuobjdump) reports, time nothing")
    ap.add_argument("--ladder", action="store_true",
                    help="time a G1 and a G2 curve.mul at B = 8192 as replayed CUDA graphs, team against one-thread design")
    args = ap.parse_args()
    picked = args.kernels or ([] if args.ladder else list(KERNELS))
    unknown = [k for k in picked if k not in KERNELS]
    if unknown:
        sys.exit(f"unknown kernels {unknown}; known: {list(KERNELS)}")
    out_dir = build.BUILD / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)

    parent_flags = {} if args.parent is None else source_flags_of(args.parent)

    def variants_of(label):
        """variant -> (nvcc flags, source path or None for the package's).
        Every label has "package", the package's source with its
        build.SOURCE_FLAGS (for a team the same build as "team"); with
        --parent also "parent", the checkout's, and for a curve label
        "parent_thread", that build's one-thread design."""
        stem = build.ENTRIES[KERNELS[label][0]][0]
        out = {var: (flags, None) for var, flags in OWN_VARIANTS.get(label, VARIANTS).items()}
        out.setdefault("package", (build.SOURCE_FLAGS.get(stem, []), None))
        if args.parent is not None:
            out["parent"] = (parent_flags.get(stem, []), args.parent / "bn_tpu_torch" / "csrc" / f"{stem}.cu")
            if label in CURVE_LABELS:
                out["parent_thread"] = out["parent"]
        return {v: x for v, x in out.items() if args.only is None or v in args.only}

    # start every compile at once (one per source and distinct flags), then
    # wait; time each by its own clock.  Variants that differ only in their
    # arguments (the curve kernels' designs) share a build.
    procs, build_of = {}, {}
    for label in picked:
        stem = build.ENTRIES[KERNELS[label][0]][0]
        for var, (flags, src) in variants_of(label).items():
            if (label, var) in OWN_SOURCES:
                key = (stem, var)
            else:
                key = (stem, tuple(flags), str(src))
            build_of[stem, var] = key
            if key not in procs:
                so = out_dir / f"lib{stem}.{var}.so"
                if (label, var) in OWN_SOURCES:
                    src = out_dir / f"{stem}.{var}.cu"
                    src.write_text(OWN_SOURCES[label, var])
                procs[key] = (build.compile_start(stem, so, flags, src), so, time.perf_counter())
    libs, logs, secs, built = {}, {}, {}, {}
    for key, (proc, so, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {key}:\n{log}")
        built[key] = (ctypes.CDLL(str(so)), log, time.perf_counter() - t0)  # seconds: upper bound, includes waiting
    for stem_var, key in build_of.items():
        libs[stem_var], logs[stem_var], secs[stem_var] = built[key]
    if args.sass:
        for (stem, var), key in build_of.items():
            print(json.dumps({"sass": stem, "variant": var, **sass_counts(procs[key][1]), "card": card}), flush=True)
        if "mont_mul" in picked:
            product_sass(out_dir, args.parent, card)
    if args.build_only:
        for (stem, var), log in logs.items():
            print(json.dumps({"ptxas": stem, "variant": var, "entries": ptxas_entries(log), "card": card}), flush=True)
        return

    rng = np.random.default_rng(7)
    pool = torch.from_numpy(
        P.ints_to_limbs([int.from_bytes(rng.bytes(40), "big") % P.Q for _ in range(B)]).astype(np.int32)
    ).to(dev)
    words, inv32 = mc._mod_args(P.Q)
    stream = torch.cuda.current_stream().cuda_stream

    runs = [(label, batch, own) for label in picked for batch in args.batch
            for own in OWN_ARG_RUNS.get(label, [KERNELS[label][3]])]
    for label, batch, own in runs:
        name, structs, n_out, _ = KERNELS[label]
        stem = build.ENTRIES[name][0]
        variants = list(variants_of(label))
        ins = []
        for st in structs:
            idx = torch.from_numpy(rng.integers(0, B, size=tuple(st) + (batch,))).to(dev)
            ins.append(torch.movedim(pool[:, idx.reshape(-1)].reshape((16,) + tuple(st) + (batch,)), 0, -2).contiguous())
        outs, ms = {}, {v: [] for v in variants}

        def run(var):
            fn = getattr(libs[stem, var], f"bn_{name}")
            fn.argtypes = list(build.ENTRIES[name][1]) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            o = torch.stack([torch.empty_like(ins[0]) for _ in range(n_out)])
            design = (CURVE_DESIGN_ARG[var],) if label in CURVE_LABELS else ()
            call_args = ([t.data_ptr() for t in ins] + [x.data_ptr() for x in o]
                         + [FLAT_ROWS.get(label, 1), batch, *own, *design, words, inv32])
            assert fn(*call_args, stream) == 0
            torch.cuda.synchronize()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            if args.graph:  # the 50 launches captured once and replayed: no host time between them
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    for _ in range(50):
                        assert fn(*call_args, torch.cuda.current_stream().cuda_stream) == 0
                graph.replay()
                torch.cuda.synchronize()
                t0.record()
                graph.replay()
                t1.record()
            else:
                t0.record()
                for _ in range(50):
                    fn(*call_args, stream)
                t1.record()
            torch.cuda.synchronize()
            outs[var] = o
            ms[var].append(t0.elapsed_time(t1) / 50)

        for var in (variants + variants[::-1]) * args.turns:
            run(var)
        for var in variants:
            log = logs[stem, var]  # of the whole source: every entry in it
            used = [line for line in log.splitlines() if re.search(r"Used \d+ registers", line)]
            regs = [re.search(r"Used (\d+) registers", line).group(1) for line in used]
            smem = [m.group(1) if (m := re.search(r"(\d+) bytes smem", line)) else 0 for line in used]  # absent: 0
            spills = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", log)
            print(json.dumps({
                "kernel": label, "variant": var, "batch": batch, "own_args": [x if isinstance(x, int) else list(x) for x in own], "ms": ms[var], "nvcc_s_upper_bound": round(secs[stem, var], 1),
                "registers": [int(r) for r in regs], "shared_bytes_static": [int(x) for x in smem],
                "stack_spillstore_spillload_bytes": [[int(x) for x in s] for s in spills],
                "same_result": bool(torch.equal(outs[var], outs[variants[0]])), "card": card,
            }), flush=True)

    if args.pairing:
        entries = [KERNELS[k][0] for k in picked if k not in CURVE_LABELS and KERNELS[k][0] not in NOT_IN_PAIRING]
        if args.together:
            swaps = [tuple(dict.fromkeys(entries))]
        else:
            swaps = [(k,) for k in dict.fromkeys(entries)]
            swaps += [pair for pair in TEAM_PAIRS if all(k in entries for k in pair)]
        builds = [v for v in PAIRING_VARIANTS + ("parent",) if args.only is None or v in args.only]
        for kernels in swaps:
            time_pairing(kernels, {var: {k: libs[build.ENTRIES[k][0], var] for k in kernels}
                                   for var in builds if all((build.ENTRIES[k][0], var) in libs for k in kernels)},
                         card)
    if args.ladder:
        time_ladder(card)


def ptxas_entries(log):
    """What `ptxas -v` printed for each entry function of a build: its
    registers, stack frame and spill stores and loads, by mangled name."""
    out = {}
    for blk in re.split(r"(?=ptxas info\s+: Compiling entry function)", log):
        head = re.match(r"ptxas info\s+: Compiling entry function '([^']+)'", blk)
        if not head:
            continue
        regs = re.search(r"Used (\d+) registers", blk)
        own = re.search(re.escape(head.group(1)) + r"\s*\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", blk)
        out[head.group(1)] = {"registers": int(regs.group(1)) if regs else None,
                              "stack_spillstore_spillload_bytes": [int(x) for x in own.groups()] if own else None}
    return out


def product_sass(out_dir, parent, card):
    """The Montgomery product's SASS instructions, the shortest loop of
    PRODUCT_LOOP_SOURCE's build: fq.cuh's product ("package"), the lo/hi
    chains of LOHI_PRODUCT ("lohi") and, given a checkout, its fq.cuh's
    ("parent", its csrc/ first on the include path)."""
    builds = {"package": ([], PRODUCT_LOOP_SOURCE),
              "lohi": (["-DBN_PRODUCT=mont_mul_lohi"], LOHI_PRODUCT + PRODUCT_LOOP_SOURCE)}
    if parent is not None:
        builds["parent"] = (["-I", str(parent / "bn_tpu_torch" / "csrc")], PRODUCT_LOOP_SOURCE)
    procs = {}
    for var, (flags, text) in builds.items():
        src = out_dir / f"product_loop.{var}.cu"
        src.write_text(text)
        so = out_dir / f"libproduct_loop.{var}.so"
        procs[var] = (build.compile_start("product_loop", so, flags, src), so)
    for var, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for the product loop {var}:\n{log}")
        counts = sass_counts(so)
        print(json.dumps({"sass_product": var, "product_loop_instructions": min(counts["loop_instructions"]),
                          "loop_instructions": counts["loop_instructions"], "kernel_instructions": counts["instructions"],
                          "imad": counts["imad"], "ptxas": ptxas_entries(log), "card": card}), flush=True)


def sass_counts(so):
    """The SASS of a built library (cuobjdump -sass, beside nvcc): its
    instructions, those of the IMAD family, shuffles and votes, and the
    instructions of each loop (from a backward branch to its target, in
    address order; a pow_fixed build's shortest is the squaring loop, one
    Montgomery product with its loop count)."""
    sass = subprocess.run([str(Path(build.nvcc()).parent / "cuobjdump"), "-sass", str(so)],
                          check=True, capture_output=True, text=True).stdout
    ins = [(int(a, 16), text.strip()) for a, text in re.findall(r"^\s+/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass, re.M)]
    loops = []
    for addr, text in ins:
        target = re.search(r"\bBRA\s+0x([0-9a-f]+)", text)
        if target and int(target[1], 16) < addr:
            loops.append((addr - int(target[1], 16)) // 16 + 1)
    ops = [text.split()[1] if text.startswith("@") else text.split()[0] for _, text in ins]
    # instructions of each function, __global__ or called, by its mangled name
    functions = {}
    for chunk in re.split(r"^\s*Function : ", sass, flags=re.M)[1:]:
        functions[chunk.split()[0]] = len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+[^;]*;", chunk, re.M))
    return {"instructions": len(ins), "imad": sum(o.startswith("IMAD") for o in ops),
            "shfl": sum(o.startswith("SHFL") for o in ops), "vote": sum(o.startswith("VOTE") for o in ops),
            "loop_instructions": loops, "function_instructions": functions}


def time_ladder(card, turns=3):
    """curve.mul of G1 and of G2 at B = 8192 (256 point_double and 256
    point_add launches, the selects between them) with every curve launch
    of the team design, then of the one-thread design: each captured once as
    a CUDA graph and replayed in turns (team, thread, thread, team) `turns`
    times, so 2 * turns replays each, median; the curve kernels' device time
    in one eager call under torch.profiler, each design once a turn; and
    whether the two give the same limbs."""
    rng = np.random.default_rng(42)
    for spec in (curve.g1_spec(), curve.g2_spec()):
        k = fp.to_device(fp.FR, [int.from_bytes(rng.bytes(64), "big") % P.R_SCALAR for _ in range(B)])
        base = curve.one(spec, (B,))
        graphs, outs = {}, {}
        ms = {d: [] for d in cc.DESIGNS}
        busy = {d: [] for d in cc.DESIGNS}
        for design in cc.DESIGNS:
            with cc.forced_design(design):
                curve.mul(spec, base, k)  # warm-up, outside the capture
                torch.cuda.synchronize()
                graphs[design] = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graphs[design]):
                    outs[design] = curve.mul(spec, base, k)
        for design in ("team", "thread", "thread", "team") * turns:
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            graphs[design].replay()
            t1.record()
            torch.cuda.synchronize()
            ms[design].append(t0.elapsed_time(t1))
            if len(busy[design]) < turns:
                with cc.forced_design(design), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    curve.mul(spec, base, k)
                    torch.cuda.synchronize()
                busy[design].append(sum(
                    getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)
                    for ev in prof.key_averages()
                    if ev.device_type == torch.autograd.DeviceType.CUDA
                    and re.search(r"k_curve_team|k_point_(add|double)", ev.key)) / 1e3)
        for design in cc.DESIGNS:
            print(json.dumps({
                "ladder": spec.name, "design": design, "batch": B, "ms_graph_replay": statistics.median(ms[design]),
                "ms_graph_replay_runs": ms[design], "curve_kernels_device_ms_runs": busy[design],
                "same_result": all(torch.equal(a, b) for a, b in zip(outs[design], outs["team"])), "card": card,
            }), flush=True)


def time_pairing(kernels, kernel_libs, card):
    """pairing_batch at B = 8192 with build.launch's entries of `kernels`
    taken from each build's libraries (kernel_libs: build -> kernel ->
    library) in turns; the inputs of tools/torch_pairing_profile.py."""
    rng = np.random.default_rng(42)
    k1, k2 = (fp.to_device(fp.FR, [int.from_bytes(rng.bytes(64), "big") % P.R_SCALAR for _ in range(B)])
              for _ in range(2))
    g1s, g2s = curve.g1_spec(), curve.g2_spec()
    p = curve.mul(g1s, curve.one(g1s, (B,)), k1)
    q = curve.mul(g2s, curve.one(g2s, (B,)), k2)
    configurations = {"fused": {}, "miller_step": dict(miller_step=True),
                      "unfused": dict(pow_fixed=False, cyclo_chain=False, ladder=False)}
    package_entry = build.entry
    entries = {}
    for var, libs in kernel_libs.items():
        entries[var] = {}
        for kernel, lib in libs.items():
            fn = getattr(lib, f"bn_{kernel}")
            fn.argtypes = list(build.ENTRIES[kernel][1]) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            entries[var][kernel] = fn
    ms = {(var, c, how): [] for var in entries for c in configurations for how in ("eager", "busy", "graph")}
    launches, same, first = {}, {}, {}

    def events_ms(fn):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        out = fn()
        t1.record()
        torch.cuda.synchronize()
        return out, t0.elapsed_time(t1)

    def check(var, c, out):
        first.setdefault(c, out)
        same[var, c] = same.get((var, c), True) and bool(torch.equal(out, first[c]))

    try:
        for var in list(entries) + list(entries)[::-1]:
            build.entry = lambda name, fns=entries[var]: fns[name] if name in fns else package_entry(name)
            for c, switches in configurations.items():
                with backend.fusions(**switches):
                    ate.pairing_batch(p, q)  # warm-up
                    torch.cuda.synchronize()
                    for _ in range(3):
                        build.reset_counts()
                        out, t = events_ms(lambda: ate.pairing_batch(p, q))
                        ms[var, c, "eager"].append(t)
                        launches[var, c] = dict(build.COUNTS)
                    check(var, c, out)
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        ate.pairing_batch(p, q)
                        torch.cuda.synchronize()
                    ms[var, c, "busy"].append(sum(
                        getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)
                        for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3)
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        out = ate.pairing_batch(p, q)
                    for _ in range(3):
                        ms[var, c, "graph"].append(events_ms(graph.replay)[1])
                    check(var, c, out)
                    del graph, out
    finally:
        build.entry = package_entry
    for var in entries:
        for c in configurations:
            runs = {how: ms[var, c, how] for how in ("eager", "busy", "graph")}
            print(json.dumps({
                "pairing_batch": c, "swapped": "+".join(kernels), "build": var, "batch": B,
                "ms_eager": statistics.median(runs["eager"]), "ms_eager_runs": runs["eager"],
                "device_busy_ms_runs": runs["busy"],
                "ms_graph_replay": statistics.median(runs["graph"]), "ms_graph_replay_runs": runs["graph"],
                "launches": sum(launches[var, c].values()),
                "swapped_launches": {k: launches[var, c][k] for k in kernels},
                "same_result_as_team": same[var, c], "card": card,
            }), flush=True)


if __name__ == "__main__":
    main()
