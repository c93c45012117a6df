// The two steps of the G2 precompute split over a team of 4 members, for
// kernels_g2_step.cu, and the block's skeleton that runs either
// (g2_step_team_block, at the end).
//
// Lanes, as in every team (team.cuh): a block works on 32 consecutive
// elements (across rows), lane l of every warp on element blockIdx.x * 32 +
// l, and warp w is member w.  Layouts: the running point r and each step's
// line coefficients are (rows, 3, 2, 16, B), the affine base (rows, 2, 2,
// 16, B); Fq2 number k of element e starts at g2_step_offset(e, B, width) + k
// * 2 * 16 * B.
//
// State.  A step is not one layer of independent products but a chain of
// dependency levels, so the block keeps the step's values in shared memory,
// the state, [slot][coefficient][word][lane] (fq2_tab_store with stride 32),
// across its levels: the inputs are loaded into their slots once, and every
// product, and every sum that later levels share, goes into a slot of its
// own.  At each level member w computes one Fq2 product from the state, with
// its pre-sums, and writes its slots; a barrier ends the level.  A member
// writes only slots no member of its level reads, and reads only slots of
// earlier levels.
//
// Outputs.  Output k, 0 <= k < 6, is x', y', z', ell_0, ell_vw, ell_vv: k < 3
// goes to r_out, the rest to c_out, each to the layout of r.  An output is
// stored, with the additions that make it, by the warp and at the level its
// step names (out_warp, out_level): at a level where its inputs are ready, by
// a warp with no product or a short one there, or after the last level.
//
// The level schedules (member w's product at each level; "-": none, the
// warp stores the outputs named under it):
//
// g2_double_step (tower.cuh, src/groups/mod.rs:612-634), 24 base-field
// products.  The two products by 1/2 there are halvings here (fq_half: add q
// when odd, shift right), the same canonical value:
//   L0: xy = x y        b = y^2           c = z^2         s = (y + z)^2
//   L1: e = (3c) b',    z' = b h, with    j = x^2         - ell_vw = -h
//       also f = 3e     h = s - (b + c)
//   L2: e^2             g^2, with         x' = a (b - f), - ell_0 = xi(e - b),
//                       g = (b + f) / 2   a = xy / 2        ell_vv = 3j
//   after L2: x' (w0), y' = g^2 - 3 e^2 (w1), z' (w2).
//
// g2_madd_step (tower.cuh, src/groups/mod.rs:591-610), 37 base-field products:
//   L0: d = x - z bx    e = y - z by      -              -
//   L1: f = d^2         g = e^2           e bx           d by
//       ell_vw = d      ell_vv = -e
//   L2: h = d f         i = x f           z g            - ell_0 = xi(e bx - d by)
//   L3: x' = d j        t = e (i - j)     h y            z' = z h
//       with j = z g + h - 2i, in both
//   after L3: x' (w0), y' = t - h y (w1), z' (w2).
//
// Every sum and difference is taken modulo q and every product reduced at
// once, so each intermediate is the canonical element: a team's result is
// that of tower.cuh's one-thread formula, bit for bit, whatever the order its
// members and stores run in within a level.  Plain C++ like the other
// headers, so the host tests run the same code; only the block's skeleton is
// device code.
#pragma once

#include "team.cuh"

#define BN_STEP_OUTPUTS 6  // x', y', z', ell_0, ell_vw, ell_vv

// a / 2 mod q for a < q: a + q when a is odd (below 2^255, q < 2^254), then
// one bit right.  On a Montgomery representative it halves the value it
// stands for, so it equals the product by the Montgomery form of 1/2.
BN_DEV Fq fq_half(const Fq& a, const Mod& m) {
  const uint32_t odd = a.w[0] & 1u;
  Fq mm;
#pragma unroll
  for (int i = 0; i < BN_NW; i++) mm.w[i] = odd ? m.w[i] : 0u;
  Fq s;
  fq_add_raw(s, a, mm);  // no carry out
  Fq r;
#pragma unroll
  for (int i = 0; i < BN_NW - 1; i++) r.w[i] = (s.w[i] >> 1) | (s.w[i + 1] << 31);
  r.w[BN_NW - 1] = s.w[BN_NW - 1] >> 1;
  return r;
}

static BN_DEV_NOINLINE Fq2 team_half(Fq2 a, Mod m) {
  Fq2 r;
  r.c0 = fq_half(a.c0, m);
  r.c1 = fq_half(a.c1, m);
  return r;
}

// 3a as 2a + a, with the team's calls.
BN_DEV Fq2 team_mul3(const Fq2& a, const Mod& m) { return team_add(team_add(a, a, m), a, m); }

// Fq2 number 0 of element e in a (rows, width, 2, 16, B) tensor.
BN_DEV int64_t g2_step_offset(int64_t e, int64_t B, int width) {
  return (e / B) * width * 2 * BN_NLIMB * B + (e % B);
}

// Output k of element e to its place: x', y', z' in r_out, the coefficients in c_out.
BN_DEV void g2_step_store(int32_t* r_out, int32_t* c_out, int k, int64_t e, int64_t B, const Fq2& v) {
  fq2_store((k < 3 ? r_out : c_out) + g2_step_offset(e, B, 3) + (int64_t)(k % 3) * 2 * BN_NLIMB * B, B, v);
}

// The doubling step's team.  twist_b is the twist's b in Montgomery form.
struct G2DoubleTeam {
  enum Slot { X, Y, Z, XY, B2, C2, S, E, F, NZ, J, EE, GG, NX, SLOTS };
  static constexpr int kMembers = 4, kInputs = 3, kLevels = 3;
  const int32_t* r;
  Fq2 twist_b;

  BN_DEV Fq2 input(int k, int64_t e, int64_t B) const {
    return fq2_load(r + g2_step_offset(e, B, 3) + (int64_t)k * 2 * BN_NLIMB * B, B);
  }

  // h = (y + z)^2 - (b + c): z' = b h, and ell_vw = -h.
  static BN_DEV Fq2 h_of(const uint32_t* s, int n, const Mod& m) {
    return team_sub(fq2_tab_load(s, n, S), team_add(fq2_tab_load(s, n, B2), fq2_tab_load(s, n, C2), m), m);
  }

  // Member w's product at level l, with its pre-sums, into its slots.
  BN_DEV void member(int l, int w, uint32_t* s, int n, const Mod& m) const {
    auto at = [&](int k) { return fq2_tab_load(s, n, k); };
    if (l == 0) {
      if (w == 0) fq2_tab_store(s, n, XY, fq2_mul(at(X), at(Y), m));
      else if (w == 1) fq2_tab_store(s, n, B2, fq2_sq(at(Y), m));
      else if (w == 2) fq2_tab_store(s, n, C2, fq2_sq(at(Z), m));
      else fq2_tab_store(s, n, S, fq2_sq(team_add(at(Y), at(Z), m), m));
    } else if (l == 1) {
      if (w == 0) {
        const Fq2 e = fq2_mul(team_mul3(at(C2), m), twist_b, m);
        fq2_tab_store(s, n, E, e);
        fq2_tab_store(s, n, F, team_mul3(e, m));
      } else if (w == 1) {
        fq2_tab_store(s, n, NZ, fq2_mul(at(B2), h_of(s, n, m), m));
      } else if (w == 2) {
        fq2_tab_store(s, n, J, fq2_sq(at(X), m));
      }
    } else {
      if (w == 0) fq2_tab_store(s, n, EE, fq2_sq(at(E), m));
      else if (w == 1) fq2_tab_store(s, n, GG, fq2_sq(team_half(team_add(at(B2), at(F), m), m), m));
      else if (w == 2) fq2_tab_store(s, n, NX, fq2_mul(team_half(at(XY), m), team_sub(at(B2), at(F), m), m));
    }
  }

  // The level at which output k is stored (kLevels: after the last) and the warp that stores it.
  static BN_DEV int out_level(int k) { return k == 4 ? 1 : k == 3 || k == 5 ? 2 : 3; }
  static BN_DEV int out_warp(int k) { return k < 3 ? k : 3; }

  BN_DEV Fq2 output(int k, const uint32_t* s, int n, const Mod& m) const {
    auto at = [&](int j) { return fq2_tab_load(s, n, j); };
    switch (k) {
      case 0: return at(NX);
      case 1: return team_sub(at(GG), team_mul3(at(EE), m), m);
      case 2: return at(NZ);
      case 3: return team_xi(team_sub(at(E), at(B2), m), m);
      case 4: return fq2_neg(h_of(s, n, m), m);
      default: return team_mul3(at(J), m);
    }
  }
};

// The mixed-addition step's team, base = the affine (bx, by).
struct G2MaddTeam {
  enum Slot { X, Y, Z, BX, BY, D, E, F, G, EBX, DBY, H, I, ZG, NX, T, HY, NZ, SLOTS };
  static constexpr int kMembers = 4, kInputs = 5, kLevels = 4;
  const int32_t* r;
  const int32_t* base;

  BN_DEV Fq2 input(int k, int64_t e, int64_t B) const {
    if (k < 3) return fq2_load(r + g2_step_offset(e, B, 3) + (int64_t)k * 2 * BN_NLIMB * B, B);
    return fq2_load(base + g2_step_offset(e, B, 2) + (int64_t)(k - 3) * 2 * BN_NLIMB * B, B);
  }

  // j = z g + h - 2i, the pre-sum of two members of the last level.
  static BN_DEV Fq2 j_of(const uint32_t* s, int n, const Mod& m) {
    const Fq2 i = fq2_tab_load(s, n, I);
    return team_sub(team_add(fq2_tab_load(s, n, ZG), fq2_tab_load(s, n, H), m), team_add(i, i, m), m);
  }

  BN_DEV void member(int l, int w, uint32_t* s, int n, const Mod& m) const {
    auto at = [&](int k) { return fq2_tab_load(s, n, k); };
    if (l == 0) {
      if (w == 0) fq2_tab_store(s, n, D, team_sub(at(X), fq2_mul(at(Z), at(BX), m), m));
      else if (w == 1) fq2_tab_store(s, n, E, team_sub(at(Y), fq2_mul(at(Z), at(BY), m), m));
    } else if (l == 1) {
      if (w == 0) fq2_tab_store(s, n, F, fq2_sq(at(D), m));
      else if (w == 1) fq2_tab_store(s, n, G, fq2_sq(at(E), m));
      else if (w == 2) fq2_tab_store(s, n, EBX, fq2_mul(at(E), at(BX), m));
      else fq2_tab_store(s, n, DBY, fq2_mul(at(D), at(BY), m));
    } else if (l == 2) {
      if (w == 0) fq2_tab_store(s, n, H, fq2_mul(at(D), at(F), m));
      else if (w == 1) fq2_tab_store(s, n, I, fq2_mul(at(X), at(F), m));
      else if (w == 2) fq2_tab_store(s, n, ZG, fq2_mul(at(Z), at(G), m));
    } else {
      if (w == 0) fq2_tab_store(s, n, NX, fq2_mul(at(D), j_of(s, n, m), m));
      else if (w == 1) fq2_tab_store(s, n, T, fq2_mul(at(E), team_sub(at(I), j_of(s, n, m), m), m));
      else if (w == 2) fq2_tab_store(s, n, HY, fq2_mul(at(H), at(Y), m));
      else fq2_tab_store(s, n, NZ, fq2_mul(at(Z), at(H), m));
    }
  }

  static BN_DEV int out_level(int k) { return k == 4 || k == 5 ? 1 : k == 3 ? 2 : 4; }
  static BN_DEV int out_warp(int k) { return k == 5 ? 1 : k == 4 ? 0 : k; }

  BN_DEV Fq2 output(int k, const uint32_t* s, int n, const Mod& m) const {
    auto at = [&](int j) { return fq2_tab_load(s, n, j); };
    switch (k) {
      case 0: return at(NX);
      case 1: return team_sub(at(T), at(HY), m);
      case 2: return at(NZ);
      case 3: return team_xi(team_sub(at(EBX), at(DBY), m), m);
      case 4: return at(D);
      default: return fq2_neg(at(E), m);
    }
  }
};

#ifdef __CUDACC__
// The block of a step's team (kernels_g2_step.cu): Step::kMembers warps,
// lane l of warp w on element blockIdx.x * 32 + l.  The warps load the
// step's inputs into the state (warp w input k for k = w, w + kMembers, ...),
// a barrier; then each level l: member w runs step.member(l, w, ...), the
// warp stores the outputs whose out_level is l and out_warp is w, a barrier.
// After the last level each warp stores its outputs with out_level
// kLevels.  The state is Step::SLOTS Fq2 of 2,048 bytes.  A lane past the end
// clamps its element to the last one, computes with the others and skips
// every store: no thread leaves before a barrier.  `marks(i)` is called at
// the start (0), after the load's barrier (1), at level l after the warp's
// member and stores (2 + 2l) and after the barrier (3 + 2l), and at the end
// (2 + 2 kLevels): it does nothing in the package's kernels, and
// tools/torch_fq12_team_phases.py reads the clock there.
template <class Step, class Marks>
__device__ __forceinline__ void g2_step_team_block(const Step& step, int32_t* __restrict__ r_out,
                                                   int32_t* __restrict__ c_out, int64_t rows, int64_t B,
                                                   const Mod& m, Marks& marks) {
  __shared__ uint32_t state[Step::SLOTS][2][BN_NW][BN_TEAM_LANES];
  marks(0);
  const TeamLane t = team_lane(rows * B);
  const int w = t.w;
  const int64_t e = t.e;
  const bool live = t.live;
  uint32_t* st = &state[0][0][0][0] + t.lane;  // stride BN_TEAM_LANES: the layout of fq2_tab_store
  for (int k = w; k < Step::kInputs; k += Step::kMembers) fq2_tab_store(st, BN_TEAM_LANES, k, step.input(k, e, B));
  __syncthreads();
  marks(1);
#pragma unroll
  for (int l = 0; l < Step::kLevels; l++) {
    step.member(l, w, st, BN_TEAM_LANES, m);
#pragma unroll
    for (int k = 0; k < BN_STEP_OUTPUTS; k++)
      if (Step::out_level(k) == l && Step::out_warp(k) == w && live)
        g2_step_store(r_out, c_out, k, e, B, step.output(k, st, BN_TEAM_LANES, m));
    marks(2 + 2 * l);
    __syncthreads();
    marks(3 + 2 * l);
  }
#pragma unroll
  for (int k = 0; k < BN_STEP_OUTPUTS; k++)
    if (Step::out_level(k) == Step::kLevels && Step::out_warp(k) == w && live)
      g2_step_store(r_out, c_out, k, e, B, step.output(k, st, BN_TEAM_LANES, m));
  marks(2 + 2 * Step::kLevels);
}
#endif
