// What every team of warps shares (fq12_team.cuh, fq12_cyclo_team.cuh,
// g2_step_team.cuh, miller_step_team.cuh): the Fq2 additions and xi as
// calls, an Fq2 in a team's shared memory, a thread's place in its block,
// and the block's skeleton that runs a team in phases (team_block, at the
// end); and the smallest team, fq2_sq's (Fq2SqTeam).
//
// Lanes.  A block works on 32 consecutive elements: lane l of every warp on
// element blockIdx.x * 32 + l, and warp w is member w.  Shared memory is
// laid out [entry][coefficient][word][lane] (fq2_tab_store with stride 32:
// neighbouring lanes on neighbouring banks).  A lane past the end clamps
// its element to the last one, computes with the others and skips every
// store: no thread leaves before a barrier.
//
// Plain C++ like the other headers, so the host tests run the same code;
// only team_lane, TeamNoMarks and team_block are device code.
#pragma once

#include "tower.cuh"

// The team's Fq2 additions and xi are calls, not inlined copies.  A member's
// loads and pre-sums and a combine are straight-line code that each warp runs
// once, in 18 and 6 versions; inlined, the combine took half of a block's
// cycles for at most 32 base-field additions, and as calls two fifths
// (tools/torch_fq12_team_phases.py).  The likely cause is instruction fetch:
// inlined, every instruction of that code is fetched once, from beyond the
// instruction cache; as calls, every warp runs the same few hundred.
static BN_DEV_NOINLINE Fq2 team_add(Fq2 a, Fq2 b, Mod m) { return fq2_add(a, b, m); }
static BN_DEV_NOINLINE Fq2 team_sub(Fq2 a, Fq2 b, Mod m) { return fq2_sub(a, b, m); }
static BN_DEV_NOINLINE Fq2 team_xi(Fq2 a, Mod m) { return fq2_xi(a, m); }

// An Fq2 in a team's shared memory: entries 2k and 2k+1 of fq_tab_store.
BN_DEV void fq2_tab_store(uint32_t* tab, int stride, int k, const Fq2& v) {
  fq_tab_store(tab, stride, 2 * k, v.c0);
  fq_tab_store(tab, stride, 2 * k + 1, v.c1);
}

BN_DEV Fq2 fq2_tab_load(const uint32_t* tab, int stride, int k) {
  Fq2 r;
  r.c0 = fq_tab_load(tab, stride, 2 * k);
  r.c1 = fq_tab_load(tab, stride, 2 * k + 1);
  return r;
}

// A thread's place in a team block: its lane, its warp (the member it is),
// its element (clamped past the end of n elements) and whether the element
// is its own to store.  The host tests build it for each lane and warp.
struct TeamLane {
  int lane, w;
  int64_t e;
  bool live;
};

BN_DEV TeamLane team_lane_at(int lane, int w, int64_t first, int64_t n) {
  TeamLane t;
  t.lane = lane;
  t.w = w;
  t.e = first + lane;
  t.live = t.e < n;
  if (!t.live) t.e = n - 1;
  return t;
}

// fq2_sq as the smallest team (kernels_fq.cu): two warps on 32 elements,
// warp 0 computes coefficient 0 of the square, (a0 + a1)(a0 - a1), and warp 1
// coefficient 1, 2 a0 a1.  Each warp loads both coefficients of its lanes'
// elements itself (the second warp's loads of a line find it in L1) and
// stores only its own coefficient, so the warps share nothing: one phase, no
// barrier, and each thread runs one Montgomery product's dependent chain.
struct Fq2SqTeam {
  static constexpr int kWarps = 2, kPhases = 1;
  struct Shared {};
  const int32_t* a;
  int32_t* o;

  BN_DEV void phase(int, const TeamLane& t, int64_t B, Shared&, const Mod& m) const {
    const int64_t off = (t.e / B) * 2 * BN_NLIMB * B + t.e % B;
    const Fq2 x = fq2_load(a + off, B);
    Fq r;
    if (t.w == 0) {
      r = fq_mont_mul(fq_add(x.c0, x.c1, m), fq_sub(x.c0, x.c1, m), m);
    } else {
      r = fq_mont_mul(x.c0, x.c1, m);
      r = fq_add(r, r, m);
    }
    if (t.live) fq_store(o + off + t.w * BN_NLIMB * B, B, r);
  }
};

#ifdef __CUDACC__
__device__ __forceinline__ TeamLane team_lane(int64_t n) {
  return team_lane_at(threadIdx.x % BN_TEAM_LANES, threadIdx.x / BN_TEAM_LANES, (int64_t)blockIdx.x * BN_TEAM_LANES, n);
}

struct TeamNoMarks {
  __device__ __forceinline__ void operator()(int) {}
};

// The block of a team that runs in phases (fq12_team_block in
// fq12_team.cuh, kernel_miller_step.cu): Team::Shared is the block's shared
// memory, and every thread runs team.phase(p, its TeamLane, B, shared, m)
// for p = 0 .. Team::kPhases - 1, a barrier between two phases: a phase
// reads of the shared memory only what earlier phases wrote, and its warps
// write entries no other warp of the phase reads or writes.  `marks(i)` is
// called at the start (0), after phase p's work (1 + 2p) and after the
// barrier that follows it (2 + 2p): it does nothing in the package's kernels,
// and tools/torch_fq12_team_phases.py reads the clock there.  team_block_on
// runs the same on a Team::Shared the kernel provides: dynamic shared memory,
// for a team whose Shared is above the 48 KB a static one may take
// (kernels_curve.cu).
template <class Team, class Marks>
__device__ __forceinline__ void team_block_on(const Team& team, typename Team::Shared& shared, int64_t n, int64_t B,
                                              const Mod& m, Marks& marks) {
  marks(0);
  const TeamLane t = team_lane(n);
#pragma unroll
  for (int p = 0; p < Team::kPhases; p++) {
    team.phase(p, t, B, shared, m);
    marks(1 + 2 * p);
    if (p + 1 < Team::kPhases) {
      __syncthreads();
      marks(2 + 2 * p);
    }
  }
}

template <class Team, class Marks>
__device__ __forceinline__ void team_block(const Team& team, int64_t n, int64_t B, const Mod& m, Marks& marks) {
  __shared__ typename Team::Shared shared;
  team_block_on(team, shared, n, B, m, marks);
}
#endif
