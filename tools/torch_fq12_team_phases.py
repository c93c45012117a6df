#!/usr/bin/env python3
"""Where a block of one of the port's team kernels spends its time on the
card: csrc/kernel_fq12_mul.cu (its team of csrc/fq12_mul_team.cuh on
team_block_on), kernel_fq12_mul024_pre.cu, kernel_fq12_sq.cu (the skeleton
fq12_team_block of csrc/fq12_team.cuh), kernel_fq12_cyclo_sq_chain.cu,
kernels_g2_step.cu or kernel_miller_step.cu.

fq12_mul (the default), fq12_mul024_pre, fq12_sq:

Builds, with the package's flags, a kernel that runs the package's team block
(the kernel's team, or fq12_team_block with the kernel's member and combine,
under its __launch_bounds__) with marks that read the multiprocessor's cycle
counter (clock64) in every warp at the block's four marks: at the start,
after the warp's member has written its products to shared memory, after the
barrier, and after the combine (warps 0-11 for fq12_mul, 0-5 for the others)
or at once (the rest).  A second instance swaps the member for one that does
the same loads and pre-sums but stores or adds its two operands instead of
multiplying them, so that the member phase splits into loads and pre-sums
against the products (fq12_mul: three whole products; the others: three
Montgomery products).  For each batch it prints one
JSON line per instance: the kernel's time (CUDA events, 50 launches after a
warm-up, the instances in turns), and over all blocks the median cycles of
the member phase (slowest and mean warp of a block), of the wait at the
barrier (from the slowest member's arrival to the release), of the combine
(slowest warp, and each combine), and of the block from its first
warp's start to its last warp's end; with the SM clock nvidia-smi reads right
after, and the limbs' equality with the package's kernel.  A batch of 32 is
one block alone on the card.

--kernel fq12_cyclo_sq_chain: the same for the chain's team block
(fq12_cyclo_team_block in csrc/fq12_cyclo_team.cuh, the body of
k_fq12_cyclo_sq_chain, under the same __launch_bounds__) at n squarings
(--n, 5 by default, the main path's longest run): lane 0 of every warp writes
clock64 to device memory at each of the block's marks.  For each batch and
instance it prints the kernel's time, the load phase, and for each squaring,
over all blocks, the median cycles of the member phase (slowest and mean
warp), of the wait at the first barrier, of the combine (slowest warp) and
of the wait at the second barrier; the store, the block's cycles, and the
limbs' equality with the package's fq12_cyclo_sq_chain.  Thread 0 also reads
its block's multiprocessor (%smid) and the global timer at the block's start
and end, so the line also gives the median block in µs, the SM clock during
the run (cycles over nanoseconds), the kernel's span, and for each
multiprocessor the most blocks it ran at once.  The second instance adds
each member's two operands instead of multiplying them.

--kernel double_step|madd_step: the same for a precompute step's team block
(g2_step_team_block in csrc/g2_step_team.cuh with G2DoubleTeam or
G2MaddTeam, the body of k_double_step / k_madd_step, under the same
__launch_bounds__), with the marks of the chain: for each batch one line with
the kernel's time, the load phase, and for each level, over all blocks, the
median cycles of the members and that level's stores (slowest warp, mean
warp, and each warp) and of the wait at the level's barrier; the final
stores, the block's cycles and µs, the SM clock in the run, the most blocks
a multiprocessor ran at once, and the limbs' equality with the package's
kernel (both outputs).

--kernel point_add|point_double: the same for the curve kernels' team block
(team_block_on in csrc/team.cuh with CurveTeam of csrc/curve_team.cuh, the
body of k_curve_team, under the same __launch_bounds__), for G1 and for G2,
on random coordinates: for each batch and team one line like miller_step's.

--kernel miller_step: the same for the Miller step's team block (team_block
in csrc/team.cuh with MillerStepTeam of csrc/miller_step_team.cuh, the body
of k_miller_step, under the same __launch_bounds__), both instances: for
each batch and instance one line with the kernel's time, and for each phase,
over all blocks, the median cycles of the warps' work (slowest warp, mean
warp, each warp) and of the wait at the barrier that ends it; the block's
cycles and µs, the SM clock in the run, the most blocks a multiprocessor ran
at once, and the limbs' equality with the package's kernel.

Run from the repository root on a machine with a GPU and nvcc:
    python3 tools/torch_fq12_team_phases.py [B ...]
        [--kernel fq12_mul|fq12_mul024_pre|fq12_sq|fq12_cyclo_sq_chain|double_step|madd_step|miller_step|
                  point_add|point_double]
        [--n N] [--flag F ...]    (default: 32 8192, fq12_mul, n = 5; --flag adds nvcc flags,
        e.g. --flag=-DBN_MILLER_SQ_MIN_BLOCKS=1)
"""

import argparse
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
#include "fq12_cyclo_team.cuh"
#include "fq12_mul_team.cuh"
#include "fq12_mul024_team.cuh"
#include "fq12_sq_team.cuh"
#include "g2_step_team.cuh"
#include "miller_step_team.cuh"
#include "curve_team.cuh"

// fq12_mul's lazy team with a member that does the same reads of the stage
// and pre-sums and stores its two operands in place of the whole products.
struct MulSumsTeam : Fq12MulTeam {
  __device__ __forceinline__ void phase(int p, const TeamLane& t, int64_t B, Shared& sh, const Mod& m) const {
    if (p != 1) return Fq12MulTeam::phase(p, t, B, sh, m);
    const uint32_t* in = &sh.in[0][0][0] + t.lane;
    uint32_t* tab = &sh.x[0][0][0] + t.lane;
    const int k = t.w / 6, j = t.w % 6;
    const Fq2 x = fq12_mul_operand(Fq12Shared{in + 6 * k * BN_NW * BN_TEAM_LANES}, j, m);
    const Fq2 y = fq12_mul_operand(Fq12Shared{in + (18 + 6 * k) * BN_NW * BN_TEAM_LANES}, j, m);
    uint32_t v[BN_DW];
    for (int i = 0; i < BN_NW; i++) {
      v[i] = x.c0.w[i] ^ y.c0.w[i];
      v[BN_NW + i] = x.c1.w[i] ^ y.c1.w[i];
    }
    dw_tab_store(tab, BN_TEAM_LANES, 2 * t.w, v);
    dw_tab_store(tab, BN_TEAM_LANES, 2 * t.w + 1, v);
  }
};

// Each other team's member from three operand pointers, with its products
// (the package's member) or with an addition of its two operands in their place.
struct Mul024Products {
  const int32_t *a, *b, *c;
  __device__ __forceinline__ Fq2 operator()(int w, int64_t e, int64_t B, const Mod& m) const {
    return fq12_mul024_member(Fq12Global{a}, LineScaled{b, c})(w, e, B, m);
  }
};
struct Mul024Sums {
  const int32_t *a, *b, *c;
  __device__ __forceinline__ Fq2 operator()(int w, int64_t e, int64_t B, const Mod& m) const {
    Fq2 z, x;
    fq12_mul024_operands(w, Fq12Global{a}.at(e, B), LineScaled{b, c}.at(e, B), m, z, x);
    return fq2_add(z, x, m);
  }
};
struct SqProducts {
  const int32_t *a, *b, *c;
  __device__ __forceinline__ Fq2 operator()(int w, int64_t e, int64_t B, const Mod& m) const {
    return fq12_sq_member(Fq12Global{a})(w, e, B, m);
  }
};
struct SqSums {
  const int32_t *a, *b, *c;
  __device__ __forceinline__ Fq2 operator()(int w, int64_t e, int64_t B, const Mod& m) const {
    const Fq12Global::Element z = Fq12Global{a}.at(e, B);
    const int k = w / 6, j = w % 6;
    return fq2_add(fq12_sq_operand(z, k, 0, j, m), fq12_sq_operand(z, k, 1, j, m), m);
  }
};

// the clock at a block's N marks (4 for two phases, 6 for three)
template <int N = 4>
struct ClockMarks {
  long long t[N];
  __device__ __forceinline__ void operator()(int i) {
    if (i == N - 1) __syncwarp();  // the warp's last lane done
    t[i] = clock64();
  }
};

// the package's team block under the package kernel's __launch_bounds__
template <int MEMBERS, int MIN_BLOCKS, class Member, class Combine>
__global__ void __launch_bounds__(BN_TEAM_LANES * MEMBERS, MIN_BLOCKS)
k_phases(const int32_t* __restrict__ a, const int32_t* __restrict__ b, const int32_t* __restrict__ c,
         int32_t* __restrict__ o, int64_t rows, int64_t B, Mod m, long long* __restrict__ clocks) {
  ClockMarks<> marks;
  fq12_team_block<MEMBERS>(o, rows, B, m, Member{a, b, c}, Combine(), marks);
  if (threadIdx.x % BN_TEAM_LANES == 0) {
    long long* row = clocks + ((int64_t)blockIdx.x * MEMBERS + threadIdx.x / BN_TEAM_LANES) * 4;
    for (int i = 0; i < 4; i++) row[i] = marks.t[i];
  }
}

// fq12_mul's team block (team_block_on on dynamic shared memory, the body of
// k_fq12_mul, under its __launch_bounds__)
template <class Team>
__global__ void __launch_bounds__(BN_TEAM_LANES * BN_TEAM_MEMBERS, 1)
k_mul_phases(const Team team, int64_t n, int64_t B, Mod m, long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char scratch[];
  ClockMarks<2 * Team::kPhases> marks;
  team_block_on(team, *reinterpret_cast<typename Team::Shared*>(scratch), n, B, m, marks);
  if (threadIdx.x % BN_TEAM_LANES == 0) {
    long long* row = clocks + ((int64_t)blockIdx.x * BN_TEAM_MEMBERS + threadIdx.x / BN_TEAM_LANES) * 2 * Team::kPhases;
    for (int i = 0; i < 2 * Team::kPhases; i++) row[i] = marks.t[i];
  }
}

template <class Team>
static int mul_phases_run(const Team& team, long long n, long long B, const Mod& m, void* clocks, void* stream) {
  const int bytes = (int)sizeof(typename Team::Shared);
  cudaError_t rc = cudaFuncSetAttribute(k_mul_phases<Team>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  k_mul_phases<Team><<<bn_grid(n, BN_TEAM_LANES), BN_TEAM_LANES * BN_TEAM_MEMBERS, bytes, (cudaStream_t)stream>>>(
      team, n, B, m, (long long*)clocks);
  return (int)cudaGetLastError();
}

// kernel 0: fq12_mul (a, b), 1: fq12_mul024_pre (f, ell0, scaled), 2: fq12_sq (a)
extern "C" int bn_phases(int kernel, int products, const void* a, const void* b, const void* c, void* o,
                         long long rows, long long B, const uint32_t* mod, uint32_t inv, void* clocks,
                         void* stream) {
  const unsigned grid = bn_grid(rows * B, BN_TEAM_LANES);
  const Mod m = bn_make_mod(mod, inv);
#define BN_PHASES(MEMBERS, MIN_BLOCKS, MEMBER, COMBINE)                                                   \
  k_phases<MEMBERS, MIN_BLOCKS, MEMBER, COMBINE><<<grid, BN_TEAM_LANES * MEMBERS, 0, (cudaStream_t)stream>>>( \
      (const int32_t*)a, (const int32_t*)b, (const int32_t*)c, (int32_t*)o, rows, B, m, (long long*)clocks)
  const Fq12MulTeam mul{(const int32_t*)a, (const int32_t*)b, (int32_t*)o};
  if (kernel == 0 && products) return mul_phases_run(mul, rows * B, B, m, clocks, stream);
  if (kernel == 0) return mul_phases_run(MulSumsTeam{mul}, rows * B, B, m, clocks, stream);
  if (kernel == 1 && products) BN_PHASES(BN_MUL024_MEMBERS, BN_MUL024_MIN_BLOCKS, Mul024Products, Fq12Mul024Combine);
  else if (kernel == 1) BN_PHASES(BN_MUL024_MEMBERS, BN_MUL024_MIN_BLOCKS, Mul024Sums, Fq12Mul024Combine);
  else if (products) BN_PHASES(BN_SQ_MEMBERS, BN_SQ_MIN_BLOCKS, SqProducts, Fq12SqCombine);
  else BN_PHASES(BN_SQ_MEMBERS, BN_SQ_MIN_BLOCKS, SqSums, Fq12SqCombine);
#undef BN_PHASES
  return (int)cudaGetLastError();
}

// the chain's member with an addition in place of its product
struct CycloSumMember {
  __device__ __forceinline__ Fq2 operator()(int w, const uint32_t* state, int stride, const Mod& m) const {
    Fq2 x, y;
    fq12_cyclo_operands(w, fq2_tab_load(state, stride, fq12_cyclo_u(w / 2)),
                        fq2_tab_load(state, stride, fq12_cyclo_v(w / 2)), m, x, y);
    return fq2_add(x, y, m);
  }
};

// lane 0 of each warp writes the clock to its warp's row of 3 + 4n marks;
// thread 0 also writes the block's multiprocessor and the global timer (ns)
// at the first and the last mark to the block's row of `info`
struct RowClockMarks {
  long long* row;
  long long* info;
  int last;
  __device__ __forceinline__ void operator()(int s) {
    __syncwarp();  // the warp's last lane done
    if (threadIdx.x % BN_TEAM_LANES == 0) row[s] = clock64();
    if (threadIdx.x == 0 && (s == 0 || s == last)) {
      unsigned long long ns;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
      info[s == 0 ? 1 : 2] = (long long)ns;
      if (s == 0) {
        unsigned sm;
        asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
        info[0] = sm;
      }
    }
  }
};

template <class Member>
__global__ void __launch_bounds__(BN_CYCLO_BLOCK, BN_CYCLO_MIN_BLOCKS)
k_chain_phases(const int32_t* __restrict__ a, int32_t* __restrict__ o, int64_t rows, int64_t B, int n, Mod m,
               long long* __restrict__ clocks, long long* __restrict__ info) {
  RowClockMarks marks{clocks + ((int64_t)blockIdx.x * BN_CYCLO_MEMBERS + threadIdx.x / BN_TEAM_LANES) * (3 + 4 * n),
                      info + (int64_t)blockIdx.x * 3, 2 + 4 * n};
  fq12_cyclo_team_block(a, o, rows, B, n, m, Member(), marks);
}

extern "C" int bn_chain_phases(int products, const void* a, void* o, long long rows, long long B, int n,
                               const uint32_t* mod, uint32_t inv, void* clocks, void* info, void* stream) {
  unsigned grid = bn_grid(rows * B, BN_TEAM_LANES);
  if (products)
    k_chain_phases<Fq12CycloMember><<<grid, BN_CYCLO_BLOCK, 0, (cudaStream_t)stream>>>(
        (const int32_t*)a, (int32_t*)o, rows, B, n, bn_make_mod(mod, inv), (long long*)clocks, (long long*)info);
  else
    k_chain_phases<CycloSumMember><<<grid, BN_CYCLO_BLOCK, 0, (cudaStream_t)stream>>>(
        (const int32_t*)a, (int32_t*)o, rows, B, n, bn_make_mod(mod, inv), (long long*)clocks, (long long*)info);
  return (int)cudaGetLastError();
}

// a step's team block under k_double_step's / k_madd_step's __launch_bounds__,
// with the chain's marks: 3 + 2 kLevels a warp
template <class Step>
__global__ void __launch_bounds__(BN_TEAM_LANES * Step::kMembers, 2)
k_step_phases(Step step, int32_t* __restrict__ r_out, int32_t* __restrict__ c_out, int64_t rows, int64_t B, Mod m,
              long long* __restrict__ clocks, long long* __restrict__ info) {
  constexpr int kMarks = 3 + 2 * Step::kLevels;
  RowClockMarks marks{clocks + ((int64_t)blockIdx.x * Step::kMembers + threadIdx.x / BN_TEAM_LANES) * kMarks,
                      info + (int64_t)blockIdx.x * 3, kMarks - 1};
  g2_step_team_block(step, r_out, c_out, rows, B, m, marks);
}

// out[0] warps and out[1] levels of double_step's team (madd = 0) or madd_step's (1)
extern "C" void bn_step_shape(int madd, int* out) {
  out[0] = madd ? G2MaddTeam::kMembers : G2DoubleTeam::kMembers;
  out[1] = madd ? G2MaddTeam::kLevels : G2DoubleTeam::kLevels;
}

// madd = 0: double_step on r with the twist's b (sixteen words, host);
// madd = 1: madd_step on r and base
extern "C" int bn_step_phases(int madd, const void* r, const void* base, void* r_out, void* c_out, long long rows,
                              long long B, const uint32_t* twist_b, const uint32_t* mod, uint32_t inv, void* clocks,
                              void* info, void* stream) {
  const unsigned grid = bn_grid(rows * B, BN_TEAM_LANES);
  const Mod m = bn_make_mod(mod, inv);
  if (madd) {
    k_step_phases<<<grid, BN_TEAM_LANES * G2MaddTeam::kMembers, 0, (cudaStream_t)stream>>>(
        G2MaddTeam{(const int32_t*)r, (const int32_t*)base}, (int32_t*)r_out, (int32_t*)c_out, rows, B, m,
        (long long*)clocks, (long long*)info);
  } else {
    Fq2 tb;
    for (int i = 0; i < BN_NW; i++) {
      tb.c0.w[i] = twist_b[i];
      tb.c1.w[i] = twist_b[BN_NW + i];
    }
    k_step_phases<<<grid, BN_TEAM_LANES * G2DoubleTeam::kMembers, 0, (cudaStream_t)stream>>>(
        G2DoubleTeam{(const int32_t*)r, tb}, (int32_t*)r_out, (int32_t*)c_out, rows, B, m, (long long*)clocks,
        (long long*)info);
  }
  return (int)cudaGetLastError();
}

// miller_step's team block under k_miller_step's __launch_bounds__, with the
// chain's marks: 2 kPhases a warp
template <bool kSquare>
__global__ void __launch_bounds__(BN_MILLER_BLOCK, kSquare ? BN_MILLER_SQ_MIN_BLOCKS : BN_MILLER_MIN_BLOCKS)
k_miller_phases(const int32_t* __restrict__ f, const int32_t* __restrict__ coeff, const int32_t* __restrict__ px,
                const int32_t* __restrict__ py, int32_t* __restrict__ o, int64_t rows, int64_t B, Mod m,
                long long* __restrict__ clocks, long long* __restrict__ info) {
  constexpr int kMarks = 2 * MillerStepTeam<kSquare>::kPhases;
  RowClockMarks marks{clocks + ((int64_t)blockIdx.x * BN_MILLER_WARPS + threadIdx.x / BN_TEAM_LANES) * kMarks,
                      info + (int64_t)blockIdx.x * 3, kMarks - 1};
  team_block(MillerStepTeam<kSquare>{f, coeff, px, py, o}, rows * B, B, m, marks);
}

// out[0] warps and out[1] phases of the instance (square = 1 or 0)
extern "C" void bn_miller_shape(int square, int* out) {
  out[0] = BN_MILLER_WARPS;
  out[1] = square ? MillerStepTeam<true>::kPhases : MillerStepTeam<false>::kPhases;
}

extern "C" int bn_miller_phases(int square, const void* f, const void* coeff, const void* px, const void* py, void* o,
                                long long rows, long long B, const uint32_t* mod, uint32_t inv, void* clocks,
                                void* info, void* stream) {
  const unsigned grid = bn_grid(rows * B, BN_TEAM_LANES);
  const Mod m = bn_make_mod(mod, inv);
  if (square)
    k_miller_phases<true><<<grid, BN_MILLER_BLOCK, 0, (cudaStream_t)stream>>>(
        (const int32_t*)f, (const int32_t*)coeff, (const int32_t*)px, (const int32_t*)py, (int32_t*)o, rows, B, m,
        (long long*)clocks, (long long*)info);
  else
    k_miller_phases<false><<<grid, BN_MILLER_BLOCK, 0, (cudaStream_t)stream>>>(
        (const int32_t*)f, (const int32_t*)coeff, (const int32_t*)px, (const int32_t*)py, (int32_t*)o, rows, B, m,
        (long long*)clocks, (long long*)info);
  return (int)cudaGetLastError();
}

// a curve team's block (team_block_on with CurveTeam of csrc/curve_team.cuh,
// the body of k_curve_team, under the same __launch_bounds__ and on dynamic
// shared memory), with the chain's marks: 2 kPhases a warp
template <class Team>
__global__ void __launch_bounds__(Team::kWarps * BN_TEAM_LANES, 2)
k_curve_phases(const Team team, int64_t n, int64_t B, Mod m, long long* __restrict__ clocks,
               long long* __restrict__ info) {
  extern __shared__ __align__(16) unsigned char curve_state[];
  constexpr int kMarks = 2 * Team::kPhases;
  RowClockMarks marks{clocks + ((int64_t)blockIdx.x * Team::kWarps + threadIdx.x / BN_TEAM_LANES) * kMarks,
                      info + (int64_t)blockIdx.x * 3, kMarks - 1};
  team_block_on(team, *reinterpret_cast<typename Team::Shared*>(curve_state), n, B, m, marks);
}

template <class Team>
static int curve_phases_run(const void* const* in, void* const* out, long long n, long long B, const Mod& m,
                            void* clocks, void* info, void* stream, int* shape) {
  shape[0] = Team::kWarps;
  shape[1] = Team::kPhases;
  if (in == nullptr) return 0;
  Team team;
  for (int k = 0; k < Team::kInputs; k++) team.in[k] = (const int32_t*)in[k];
  for (int k = 0; k < 3; k++) team.out[k] = (int32_t*)out[k];
  const int bytes = (int)sizeof(typename Team::Shared);
  cudaError_t rc = cudaFuncSetAttribute(k_curve_phases<Team>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  k_curve_phases<Team><<<bn_grid(n, BN_TEAM_LANES), Team::kWarps * BN_TEAM_LANES, bytes, (cudaStream_t)stream>>>(
      team, n, B, m, (long long*)clocks, (long long*)info);
  return (int)cudaGetLastError();
}

// add = 1: point_add, 0: point_double; fq2 = 1: G2.  shape gets the team's
// warps and phases; with in = nullptr nothing is launched.
extern "C" int bn_curve_phases(int add, int fq2, const void* const* in, void* const* out, long long rows,
                               long long B, const uint32_t* mod, uint32_t inv, void* clocks, void* info, void* stream,
                               int* shape) {
  const Mod m = bn_make_mod(mod, inv);
  const long long n = rows * B;
#define BN_CURVE_PHASES(F, ADD) curve_phases_run<CurveTeam<F, ADD>>(in, out, n, B, m, clocks, info, stream, shape)
  if (!fq2) return add ? BN_CURVE_PHASES(Fq, true) : BN_CURVE_PHASES(Fq, false);
  return add ? BN_CURVE_PHASES(Fq2, true) : BN_CURVE_PHASES(Fq2, false);
#undef BN_CURVE_PHASES
}
"""
LANES = 32
CHAIN_MEMBERS = 6
CURVE = ("point_add", "point_double")
STEPS = ("double_step", "madd_step")
# the one-barrier teams: kernel -> (bn_phases' kernel index, members,
# combines, operand structs: an Fq12 element, an Fq2 (ell0), two Fq2 (scaled))
TEAMS = {
    "fq12_mul": (0, 18, 12, [(2, 3, 2), (2, 3, 2)]),
    "fq12_mul024_pre": (1, 13, 6, [(2, 3, 2), (2,), (2, 2)]),
    "fq12_sq": (2, 12, 6, [(2, 3, 2)]),
}


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    ap = argparse.ArgumentParser()
    ap.add_argument("batches", type=int, nargs="*", default=[32, 8192])
    ap.add_argument("--kernel", choices=list(TEAMS) + ["fq12_cyclo_sq_chain"] + list(STEPS) + ["miller_step"] + list(CURVE),
                    default="fq12_mul")
    ap.add_argument("--n", type=int, default=5, help="squarings of the chain")
    ap.add_argument("--flag", action="append", default=[], help="an nvcc flag added to the package's (repeatable)")
    args = ap.parse_args()
    card = smi("name,power.limit")
    out_dir = build.BUILD / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, so = out_dir / "fq12_team_phases.cu", out_dir / "libfq12_team_phases.so"
    src.write_text(SOURCE)
    # every team kernel's source builds with the same flags (ops/build.py SOURCE_FLAGS)
    stem = build.ENTRIES[args.kernel][0]
    proc = build.compile_start(stem, so, build.SOURCE_FLAGS.get(stem, []) + args.flag, src=src)
    log, _ = proc.communicate()
    if proc.returncode != 0:
        sys.exit(f"nvcc failed:\n{log}")
    lib = ctypes.CDLL(str(so))
    if args.kernel == "fq12_cyclo_sq_chain":
        chain_phases(lib, args.batches, args.n, card)
    elif args.kernel in STEPS:
        step_phases(lib, args.kernel, args.batches, card)
    elif args.kernel == "miller_step":
        miller_phases(lib, args.batches, card)
    elif args.kernel in CURVE:
        curve_phases(lib, args.kernel, args.batches, card)
    else:
        team_phases(lib, args.kernel, args.batches, card)


def timed_runs(launch, clocks, ms, products):
    """One launch, then 50 timed by CUDA events; the clocks of the last."""
    if launch(products) != 0:
        sys.exit("the phase kernel was not launched")
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(50):
        launch(products)
    t1.record()
    torch.cuda.synchronize()
    ms[products].append(t0.elapsed_time(t1) / 50)
    return clocks.cpu().numpy().copy()


def random_operands(rng, structs, batch, dev):
    """One (*struct, 16, batch) tensor of random field elements for each struct."""
    out = []
    for st in structs:
        vals = [int.from_bytes(rng.bytes(40), "big") % P.Q for _ in range(int(np.prod(st)) * batch)]
        limbs = P.ints_to_limbs(vals).astype(np.int32).reshape((16,) + tuple(st) + (batch,))
        out.append(torch.from_numpy(np.ascontiguousarray(np.moveaxis(limbs, 0, -2))).to(dev))
    return out


def blocks_at_once(info):
    """For each multiprocessor, the most blocks whose [start, end] on the
    global timer overlap; returns {that count: multiprocessors}."""
    most = {}
    for sm in np.unique(info[:, 0]):
        spans = info[info[:, 0] == sm, 1:]
        events = sorted([(t, 1) for t in spans[:, 0]] + [(t, -1) for t in spans[:, 1]], key=lambda e: (e[0], e[1]))
        now = top = 0
        for _, d in events:
            now += d
            top = max(top, now)
        most[top] = most.get(top, 0) + 1
    return {str(k): v for k, v in sorted(most.items())}


def chain_phases(lib, batches, n, card):
    fn = lib.bn_chain_phases
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    words, inv32 = mc._mod_args(P.Q)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(11)
    dev = torch.device("cuda")
    med = lambda x: [float(v) for v in np.median(x, axis=0)]  # noqa: E731  over blocks
    for batch in batches:
        (a,) = random_operands(rng, [(2, 3, 2)], batch, dev)
        o = torch.empty_like(a)
        blocks = (batch + LANES - 1) // LANES
        clocks = torch.zeros((blocks, CHAIN_MEMBERS, 3 + 4 * n), dtype=torch.int64, device=dev)
        info = torch.zeros((blocks, 3), dtype=torch.int64, device=dev)  # multiprocessor, start ns, end ns
        ms = {True: [], False: []}

        def launch(products):
            return fn(int(products), a.data_ptr(), o.data_ptr(), 1, batch, n, words, inv32, clocks.data_ptr(),
                      info.data_ptr(), stream)

        res, infos = {}, {}
        for products in (True, False, False, True):
            res[products] = timed_runs(launch, clocks, ms, products)
            infos[products] = info.cpu().numpy().copy()
            if products:
                same = bool(torch.equal(o, tc.fq12_cyclo_sq_chain(a, n, P.Q)))
        sm_clock = smi("clocks.sm")
        for products in (True, False):
            c, nfo = res[products], infos[products]  # (blocks, warps, 3 + 4n), (blocks, 3)
            sq = [4 * i + np.arange(1, 6) for i in range(n)]  # each squaring's marks: start, member, barrier, combine, barrier
            member = np.stack([c[:, :, s[1]] - c[:, :, s[0]] for s in sq], axis=1)  # (blocks, n, warps)
            print(json.dumps({
                "kernel": "fq12_cyclo_sq_chain", "batch": batch, "n": n,
                "instance": "products" if products else "loads and pre-sums only",
                "ms": ms[products], "blocks": blocks,
                "load_cycles": float(np.median(c[:, :, 1].max(axis=1) - c[:, :, 0].min(axis=1))),
                "member_cycles_slowest_warp": med(member.max(axis=2)),
                "member_cycles_mean_warp": med(member.mean(axis=2)),
                "barrier1_wait_cycles": med(np.stack([c[:, :, s[2]].max(axis=1) - c[:, :, s[1]].max(axis=1) for s in sq], axis=1)),
                "combine_cycles_slowest_warp": med(np.stack([(c[:, :, s[3]] - c[:, :, s[2]]).max(axis=1) for s in sq], axis=1)),
                "barrier2_wait_cycles": med(np.stack([c[:, :, s[4]].max(axis=1) - c[:, :, s[3]].max(axis=1) for s in sq], axis=1)),
                "store_cycles": float(np.median((c[:, :, -1] - c[:, :, -2]).max(axis=1))),
                "block_cycles": float(np.median(c[:, :, -1].max(axis=1) - c[:, :, 0].min(axis=1))),
                "block_us": float(np.median(nfo[:, 2] - nfo[:, 1])) / 1e3,
                "sm_clock_ghz_in_run": float(np.median((c[:, 0, -1] - c[:, 0, 0]) / (nfo[:, 2] - nfo[:, 1]))),
                "kernel_span_us": float(nfo[:, 2].max() - nfo[:, 1].min()) / 1e3,
                "multiprocessors_used": int(len(np.unique(nfo[:, 0]))),
                "most_blocks_at_once_per_multiprocessor": blocks_at_once(nfo),
                "sm_clock_after": sm_clock, "equals_fq12_cyclo_sq_chain": same if products else None, "card": card,
            }), flush=True)


def step_phases(lib, kernel, batches, card):
    fn = lib.bn_step_phases
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [
        ctypes.POINTER(ctypes.c_uint32)] * 2 + [ctypes.c_uint32] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    madd = kernel == "madd_step"
    shape = (ctypes.c_int * 2)()
    lib.bn_step_shape(int(madd), shape)
    members, levels = shape
    marks = 3 + 2 * levels
    package = tc.madd_step if madd else tc.double_step
    words, inv32 = mc._mod_args(P.Q)
    (twist_b,) = tc._step_const_args()
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(11)
    dev = torch.device("cuda")
    med = lambda x: [float(v) for v in np.median(x, axis=0)]  # noqa: E731  over blocks
    for batch in batches:
        ins = random_operands(rng, [(3, 2), (2, 2)] if madd else [(3, 2)], batch, dev)
        r_out, c_out = torch.empty_like(ins[0]), torch.empty_like(ins[0])
        blocks = (batch + LANES - 1) // LANES
        clocks = torch.zeros((blocks, members, marks), dtype=torch.int64, device=dev)
        info = torch.zeros((blocks, 3), dtype=torch.int64, device=dev)  # multiprocessor, start ns, end ns
        ms = {True: []}

        def launch(_):
            return fn(int(madd), ins[0].data_ptr(), ins[-1].data_ptr(), r_out.data_ptr(), c_out.data_ptr(), 1, batch,
                      twist_b, words, inv32, clocks.data_ptr(), info.data_ptr(), stream)

        c = timed_runs(launch, clocks, ms, True)  # (blocks, warps, marks)
        nfo = info.cpu().numpy().copy()
        same = all(torch.equal(g, w) for g, w in zip((r_out, c_out), package(*ins)))
        sm_clock = smi("clocks.sm")
        # level l: from the previous barrier's release (mark 1 + 2l) to the warp's arrival (2 + 2l)
        work = np.stack([c[:, :, 2 + 2 * lv] - c[:, :, 1 + 2 * lv] for lv in range(levels)], axis=1)  # (blocks, levels, warps)
        print(json.dumps({
            "kernel": kernel, "batch": batch, "levels": levels, "ms": ms[True], "blocks": blocks,
            "load_cycles": float(np.median(c[:, :, 1].max(axis=1) - c[:, :, 0].min(axis=1))),
            "level_cycles_slowest_warp": med(work.max(axis=2)),
            "level_cycles_mean_warp": med(work.mean(axis=2)),
            "level_cycles_by_warp": [med(work[:, lv, :]) for lv in range(levels)],
            "barrier_wait_cycles": med(np.stack([c[:, :, 3 + 2 * lv].max(axis=1) - c[:, :, 2 + 2 * lv].max(axis=1)
                                                 for lv in range(levels)], axis=1)),
            "final_store_cycles_slowest_warp": float(np.median((c[:, :, -1] - c[:, :, -2]).max(axis=1))),
            "block_cycles": float(np.median(c[:, :, -1].max(axis=1) - c[:, :, 0].min(axis=1))),
            "block_us": float(np.median(nfo[:, 2] - nfo[:, 1])) / 1e3,
            "sm_clock_ghz_in_run": float(np.median((c[:, 0, -1] - c[:, 0, 0]) / (nfo[:, 2] - nfo[:, 1]))),
            "kernel_span_us": float(nfo[:, 2].max() - nfo[:, 1].min()) / 1e3,
            "multiprocessors_used": int(len(np.unique(nfo[:, 0]))),
            "most_blocks_at_once_per_multiprocessor": blocks_at_once(nfo),
            "sm_clock_after": sm_clock, f"equals_{kernel}": same, "card": card,
        }), flush=True)


def miller_phases(lib, batches, card):
    fn = lib.bn_miller_phases
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    words, inv32 = mc._mod_args(P.Q)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(11)
    dev = torch.device("cuda")
    med = lambda x: [float(v) for v in np.median(x, axis=0)]  # noqa: E731  over blocks
    for batch in batches:
        f, coeff, px, py = random_operands(rng, [(2, 3, 2), (3, 2), (), ()], batch, dev)
        o = torch.empty_like(f)
        blocks = (batch + LANES - 1) // LANES
        for square in (True, False):
            shape = (ctypes.c_int * 2)()
            lib.bn_miller_shape(int(square), shape)
            warps, phases = shape
            clocks = torch.zeros((blocks, warps, 2 * phases), dtype=torch.int64, device=dev)
            info = torch.zeros((blocks, 3), dtype=torch.int64, device=dev)  # multiprocessor, start ns, end ns
            ms = {True: []}

            def launch(_):
                return fn(int(square), f.data_ptr(), coeff.data_ptr(), px.data_ptr(), py.data_ptr(), o.data_ptr(), 1,
                          batch, words, inv32, clocks.data_ptr(), info.data_ptr(), stream)

            c = timed_runs(launch, clocks, ms, True)  # (blocks, warps, 2 phases)
            nfo = info.cpu().numpy().copy()
            same = bool(torch.equal(o, tc.miller_step(f, coeff, px, py, square)))
            sm_clock = smi("clocks.sm")
            # phase p: from the start or the previous barrier's release (mark 2p) to the warp's end of work (1 + 2p)
            work = np.stack([c[:, :, 1 + 2 * p] - c[:, :, 2 * p] for p in range(phases)], axis=1)
            print(json.dumps({
                "kernel": "miller_step", "instance": "square" if square else "no square", "batch": batch,
                "phases": phases, "ms": ms[True], "blocks": blocks,
                "phase_cycles_slowest_warp": med(work.max(axis=2)),
                "phase_cycles_mean_warp": med(work.mean(axis=2)),
                "phase_cycles_by_warp": [med(work[:, p, :]) for p in range(phases)],
                "barrier_wait_cycles": med(np.stack([c[:, :, 2 + 2 * p].max(axis=1) - c[:, :, 1 + 2 * p].max(axis=1)
                                                     for p in range(phases - 1)], axis=1)),
                "block_cycles": float(np.median(c[:, :, -1].max(axis=1) - c[:, :, 0].min(axis=1))),
                "block_us": float(np.median(nfo[:, 2] - nfo[:, 1])) / 1e3,
                "sm_clock_ghz_in_run": float(np.median((c[:, 0, -1] - c[:, 0, 0]) / (nfo[:, 2] - nfo[:, 1]))),
                "kernel_span_us": float(nfo[:, 2].max() - nfo[:, 1].min()) / 1e3,
                "multiprocessors_used": int(len(np.unique(nfo[:, 0]))),
                "most_blocks_at_once_per_multiprocessor": blocks_at_once(nfo),
                "sm_clock_after": sm_clock, "equals_miller_step": same, "card": card,
            }), flush=True)


def curve_phases(lib, kernel, batches, card):
    """The curve team's block of `kernel` for G1 and G2 on random coordinates
    (generic lanes: the addition's doubling levels find no flag and do
    nothing)."""
    from bn_tpu_torch.ops import curve_cuda as cc

    fn = lib.bn_curve_phases
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_longlong] * 2 + [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32] + [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    words, inv32 = mc._mod_args(P.Q)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(11)
    dev = torch.device("cuda")
    add = kernel == "point_add"
    med = lambda x: [float(v) for v in np.median(x, axis=0)]  # noqa: E731  over blocks
    for batch in batches:
        for group in ("G1", "G2"):
            st = cc.STRUCTS[group]
            ins = random_operands(rng, [st] * (6 if add else 3), batch, dev)
            outs = [torch.empty_like(ins[0]) for _ in range(3)]
            in_c = (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins))
            out_c = (ctypes.c_void_p * 3)(*(t.data_ptr() for t in outs))
            shape = (ctypes.c_int * 2)()
            fn(int(add), int(group == "G2"), None, None, 1, batch, words, inv32, None, None, stream, shape)
            warps, phases = shape
            blocks = (batch + LANES - 1) // LANES
            clocks = torch.zeros((blocks, warps, 2 * phases), dtype=torch.int64, device=dev)
            info = torch.zeros((blocks, 3), dtype=torch.int64, device=dev)  # multiprocessor, start ns, end ns
            ms = {True: []}

            def launch(_):
                return fn(int(add), int(group == "G2"), in_c, out_c, 1, batch, words, inv32, clocks.data_ptr(),
                          info.data_ptr(), stream, shape)

            c = timed_runs(launch, clocks, ms, True)  # (blocks, warps, 2 phases)
            nfo = info.cpu().numpy().copy()
            with cc.forced_design("team"):
                want = getattr(cc, kernel)(group, *([tuple(ins[:3]), tuple(ins[3:])] if add else [tuple(ins)]))
            same = all(torch.equal(g, w) for g, w in zip(outs, want))
            sm_clock = smi("clocks.sm")
            work = np.stack([c[:, :, 1 + 2 * p] - c[:, :, 2 * p] for p in range(phases)], axis=1)
            print(json.dumps({
                "kernel": kernel, "group": group, "batch": batch, "warps": warps,
                "phases": phases, "ms": ms[True], "blocks": blocks,
                "phase_cycles_slowest_warp": med(work.max(axis=2)),
                "phase_cycles_mean_warp": med(work.mean(axis=2)),
                "barrier_wait_cycles": med(np.stack([c[:, :, 2 + 2 * p].max(axis=1) - c[:, :, 1 + 2 * p].max(axis=1)
                                                     for p in range(phases - 1)], axis=1)),
                "block_cycles": float(np.median(c[:, :, -1].max(axis=1) - c[:, :, 0].min(axis=1))),
                "block_us": float(np.median(nfo[:, 2] - nfo[:, 1])) / 1e3,
                "sm_clock_ghz_in_run": float(np.median((c[:, 0, -1] - c[:, 0, 0]) / (nfo[:, 2] - nfo[:, 1]))),
                "kernel_span_us": float(nfo[:, 2].max() - nfo[:, 1].min()) / 1e3,
                "multiprocessors_used": int(len(np.unique(nfo[:, 0]))),
                "most_blocks_at_once_per_multiprocessor": blocks_at_once(nfo),
                "sm_clock_after": sm_clock, "equals_the_package_team": same, "card": card,
            }), flush=True)


def team_phases(lib, kernel, batches, card):
    fn = lib.bn_phases
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    index, members, combines, structs = TEAMS[kernel]
    marks = 6 if kernel == "fq12_mul" else 4  # fq12_mul's team stages its operands in a phase of its own
    s = marks - 4  # the member phase's first mark
    package = {"fq12_mul": tc.fq12_mul, "fq12_mul024_pre": tc.fq12_mul024_pre, "fq12_sq": tc.fq12_sq}[kernel]
    words, inv32 = mc._mod_args(P.Q)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(11)
    dev = torch.device("cuda")
    for batch in batches:
        ins = random_operands(rng, structs, batch, dev)
        ptrs = [t.data_ptr() for t in ins] + [None] * (3 - len(ins))
        o = torch.empty_like(ins[0])
        blocks = (batch + LANES - 1) // LANES
        clocks = torch.zeros((blocks, members, marks), dtype=torch.int64, device=dev)
        ms = {True: [], False: []}

        def launch(products):
            return fn(index, int(products), *ptrs, o.data_ptr(), 1, batch, words, inv32, clocks.data_ptr(), stream)

        res = {}
        for products in (True, False, False, True):
            res[products] = timed_runs(launch, clocks, ms, products)
            if products:
                same = bool(torch.equal(o, package(*ins, P.Q)))
        sm_clock = smi("clocks.sm")
        for products in (True, False):
            c = res[products]  # (blocks, warps, marks)
            member = c[:, :, s + 1] - c[:, :, s]
            combine = c[:, :combines, s + 3] - c[:, :combines, s + 2]
            stage = {} if s == 0 else {
                "stage_cycles_slowest_warp": float(np.median((c[:, :, 1] - c[:, :, 0]).max(axis=1))),
                "stage_barrier_wait_cycles": float(np.median(c[:, :, 2].max(axis=1) - c[:, :, 1].max(axis=1)))}
            print(json.dumps({
                "kernel": kernel, "batch": batch, "instance": "products" if products else "loads and pre-sums only",
                "ms": ms[products], "blocks": blocks, **stage,
                "member_cycles_slowest_warp": float(np.median(member.max(axis=1))),
                "member_cycles_mean_warp": float(np.median(member.mean(axis=1))),
                "member_cycles_by_warp": [float(x) for x in np.median(member, axis=0)],
                "barrier_wait_cycles": float(np.median(c[:, :, s + 2].max(axis=1) - c[:, :, s + 1].max(axis=1))),
                "combine_cycles": float(np.median(combine.max(axis=1))),
                "combine_cycles_by_warp": [float(x) for x in np.median(combine, axis=0)],
                "block_cycles": float(np.median(c[:, :, s + 3].max(axis=1) - c[:, :, 0].min(axis=1))),
                "sm_clock_after": sm_clock, f"equals_{kernel}": same if products else None, "card": card,
            }), flush=True)


if __name__ == "__main__":
    main()
