// One step of the Miller loop split over a team of 13 warps, for
// kernel_miller_step.cu: the element in shared memory for the whole step,
// fq12_sq's team (fq12_sq_team.cuh) and the sparse line multiply's
// (fq12_mul024_team.cuh) run on it in one block (lanes and the block's
// skeleton team_block: team.cuh).
//
// The step (fq12_miller_step in tower.cuh, src/groups/mod.rs:494-509): f^2
// on a doubling step (the square instance), then f times the line
// (x0 + x2 v) + x4 v w, with x0 = ell_0, x2 = ell_vv px, x4 = ell_vw py from
// the step's unscaled coefficients (rows, 3, 2, 16, B) and the affine G1
// point px, py (rows, 16, B).
//
// Levels, warp w on its lane's element, a barrier between two:
//   0: warps 0-5 load coefficient w of f into the state;
//   1 (square instance only): warps 0-11 are fq12_sq's members on the
//      state, their products into the scratch;
//   2 (square instance only): warps 0-5 write fq12_sq's combine w, from the
//      scratch, over coefficient w of the state: f^2 in place of f;
//   at level 2, or at level 0 without the square: warps 6 and 7 scale the
//      line, x2 and x4 into the line slots (one fq2_scale_fq each: 2
//      base-field products), beside the six warps that combine or load;
//   3: all 13 warps are the sparse multiply's members on the state and the
//      line (x0 from device memory, x2 and x4 from the line slots), their
//      products into the scratch;
//   4: warps 0-5 store the sparse multiply's combine w as output
//      coefficient w.
// Shared memory: the scratch, 13 Fq2 a lane (26,624 bytes; level 1 uses 12
// of them, level 3 all), the state, 6 (12,288), and the line slots, 2
// (4,096): 43,008 bytes in all, under the 48 KB of static shared memory.
// The state is read from shared memory, not device memory, by every member.
// f^2 may overwrite f in place because level 2 reads only the scratch, and
// every member of level 1 has read the state before the barrier that ends it;
// level 3 overwrites the scratch only after the barrier that ends level 2.
//
// Every sum and difference is taken modulo q and every product reduced at
// once, so the result is that of tower.cuh's one-thread fq12_miller_step,
// bit for bit, whatever order the warps of a level run in.  Plain C++ like
// the other headers, so the host tests run the same levels.
#pragma once

#include "fq12_mul024_team.cuh"
#include "fq12_sq_team.cuh"
#include "fq12_team.cuh"
#include "team.cuh"

#define BN_MILLER_WARPS BN_MUL024_MEMBERS  // 13: the sparse multiply's members
#define BN_MILLER_BLOCK (BN_TEAM_LANES * BN_MILLER_WARPS)
#define BN_MILLER_SCALE_WARP 6  // warps 6 and 7 scale the line
// blocks a multiprocessor that __launch_bounds__ asks registers for, in the
// square instance and in the other (kernel_miller_step.cu says why one and two)
#ifndef BN_MILLER_SQ_MIN_BLOCKS
#define BN_MILLER_SQ_MIN_BLOCKS 1
#endif
#ifndef BN_MILLER_MIN_BLOCKS
#define BN_MILLER_MIN_BLOCKS 2
#endif

// The step's line: x0 from the coefficients in device memory, x2 and x4
// from the line slots at the thread's lane (a line source of
// fq12_mul024_team.cuh).
struct LineShared {
  const int32_t* coeff;
  const uint32_t* tab;
  struct Element {
    const int32_t* x0;
    const uint32_t* tab;
    int64_t B;
    BN_DEV Fq2 operator()(int i) const { return i == 0 ? fq2_load(x0, B) : fq2_tab_load(tab, BN_TEAM_LANES, i - 1); }
  };
  BN_DEV Element at(int64_t e, int64_t B) const { return Element{line_coeffs_at(coeff, e, B), tab, B}; }
};

// Line slot s of element e: x2 = ell_vv px (s = 0) or x4 = ell_vw py (s = 1).
BN_DEV Fq2 miller_line_slot(const int32_t* coeff, const int32_t* px, const int32_t* py, int64_t e, int64_t B, int s,
                            const Mod& m) {
  const Fq2 ell = fq2_load(line_coeffs_at(coeff, e, B) + (int64_t)(2 - s) * 2 * BN_NLIMB * B, B);
  return fq2_scale_fq(ell, fq_load((s == 0 ? px : py) + (e / B) * BN_NLIMB * B + (e % B), B), m);
}

template <bool kSquare>
struct MillerStepTeam {
  static constexpr int kWarps = BN_MILLER_WARPS, kPhases = kSquare ? 5 : 3;
  struct Shared {
    uint32_t prods[BN_MUL024_MEMBERS][2][BN_NW][BN_TEAM_LANES];
    uint32_t state[BN_TEAM_COMBINES][2][BN_NW][BN_TEAM_LANES];
    uint32_t line[2][2][BN_NW][BN_TEAM_LANES];
  };
  const int32_t* f;
  const int32_t* coeff;
  const int32_t* px;
  const int32_t* py;
  int32_t* __restrict__ o;

  // The line slots, by warps 6 and 7.
  BN_DEV void scale(const TeamLane& t, int64_t B, uint32_t* line, const Mod& m) const {
    if (t.w >= BN_MILLER_SCALE_WARP && t.w < BN_MILLER_SCALE_WARP + 2) {
      const int s = t.w - BN_MILLER_SCALE_WARP;
      fq2_tab_store(line, BN_TEAM_LANES, s, miller_line_slot(coeff, px, py, t.e, B, s, m));
    }
  }

  // Level 0: f into the state (and the line slots without the square).
  BN_DEV void load(const TeamLane& t, int64_t B, uint32_t* state, uint32_t* line, const Mod& m) const {
    if (t.w < BN_TEAM_COMBINES) fq2_tab_store(state, BN_TEAM_LANES, t.w, Fq12Global{f}.at(t.e, B)(t.w));
    if (!kSquare) scale(t, B, line, m);
  }

  // Level 1: fq12_sq's members on the state.
  BN_DEV void square_members(const TeamLane& t, int64_t B, uint32_t* prods, const uint32_t* state,
                             const Mod& m) const {
    if (t.w < BN_SQ_MEMBERS) fq12_team_members(prods, t, B, m, fq12_sq_member(Fq12Shared{state}));
  }

  // Level 2: its combines, f^2 over f, and the line slots.
  BN_DEV void square_combines(const TeamLane& t, int64_t B, const uint32_t* prods, uint32_t* state,
                              uint32_t* line, const Mod& m) const {
    if (t.w < BN_TEAM_COMBINES)
      fq2_tab_store(state, BN_TEAM_LANES, t.w, Fq12SqCombine()(t.w, t.e, B, prods, BN_TEAM_LANES, m));
    scale(t, B, line, m);
  }

  // Level 3: the sparse multiply's members on the state and the line.
  BN_DEV void mul024_members(const TeamLane& t, int64_t B, uint32_t* prods, const uint32_t* state,
                             const uint32_t* line, const Mod& m) const {
    fq12_team_members(prods, t, B, m, fq12_mul024_member(Fq12Shared{state}, LineShared{coeff, line}));
  }

  // Level 4: its combines store.
  BN_DEV void mul024_combines(const TeamLane& t, int64_t B, const uint32_t* prods, const Mod& m) const {
    fq12_team_combines(o, prods, t, B, m, Fq12Mul024Combine());
  }

  // Phase p is level p of the square instance; without the square, phases
  // 0, 1, 2 are levels 0, 3, 4.
  BN_DEV void phase(int p, const TeamLane& t, int64_t B, Shared& sh, const Mod& m) const {
    uint32_t* prods = &sh.prods[0][0][0][0] + t.lane;
    uint32_t* state = &sh.state[0][0][0][0] + t.lane;
    uint32_t* line = &sh.line[0][0][0][0] + t.lane;
    const int level = kSquare || p == 0 ? p : p + 2;
    if (level == 0)
      load(t, B, state, line, m);
    else if (level == 1)
      square_members(t, B, prods, state, m);
    else if (level == 2)
      square_combines(t, B, prods, state, line, m);
    else if (level == 3)
      mul024_members(t, B, prods, state, line, m);
    else
      mul024_combines(t, B, prods, m);
  }
};
