// Host build of the port's CUDA field/tower/curve headers (bn_tpu_torch/csrc/
// carry.cuh, fq.cuh, fq_dw.cuh, fq_group.cuh, tower.cuh, team.cuh, fq12_team.cuh,
// fq12_mul_team.cuh, fq12_mul024_team.cuh, fq12_sq_team.cuh, fq12_cyclo_team.cuh,
// g2_step_team.cuh, miller_step_team.cuh, curve.cuh, curve_team.cuh,
// signed_sum.cuh are plain
// C++ when no CUDA compiler is at work: carry.cuh's PTX primitives are their
// C++ twins there).
// One loop over the batch stands in for the grid, with the same offsets as the kernels, so
// the formulas and the memory layout can be checked on a machine without a
// GPU.  Built and driven by tests/test_torch_csrc_host.py.
#include <string.h>

#include "curve.cuh"
#include "curve_team.cuh"
#include "fq12_cyclo_team.cuh"
#include "fq_group.cuh"
#include "fq12_mul_team.cuh"
#include "fq12_mul024_team.cuh"
#include "fq12_sq_team.cuh"
#include "g2_step_team.cuh"
#include "miller_step_team.cuh"
#include "signed_sum.cuh"

enum {
  OP_MONT_MUL, OP_MOD_ADD, OP_MOD_SUB, OP_MOD_NEG, OP_FQ2_MUL, OP_FQ2_SQ, OP_FQ2_XI,
  OP_FQ12_MUL, OP_FQ12_SQ, OP_FQ12_MUL024_PRE, OP_FQ12_CYCLO_SQ,
  OP_POW_FIXED, OP_FQ12_CYCLO_SQ_CHAIN, OP_DOUBLE_STEP, OP_MADD_STEP, OP_FQ12_MUL024,
  OP_FQ12_MUL_TEAM, OP_FQ12_MUL_TEAM_REVERSE, OP_FQ12_CYCLO_TEAM, OP_FQ12_CYCLO_TEAM_REVERSE,
  OP_FQ12_MUL024_TEAM, OP_FQ12_MUL024_TEAM_REVERSE, OP_FQ12_SQ_TEAM, OP_FQ12_SQ_TEAM_REVERSE,
  OP_DOUBLE_STEP_TEAM, OP_DOUBLE_STEP_TEAM_REVERSE, OP_MADD_STEP_TEAM, OP_MADD_STEP_TEAM_REVERSE,
  OP_FQ12_CYCLO_SQ_TEAM, OP_FQ12_CYCLO_SQ_TEAM_REVERSE,
  OP_GROUP_MUL_4, OP_GROUP_MUL_4_REVERSE, OP_GROUP_MUL_8, OP_GROUP_MUL_8_REVERSE,
  OP_GROUP_POW_4, OP_GROUP_POW_4_REVERSE, OP_GROUP_POW_8, OP_GROUP_POW_8_REVERSE,
  OP_FQ12_MUL024_LINE_TEAM, OP_FQ12_MUL024_LINE_TEAM_REVERSE, OP_FQ2_SQ_TEAM, OP_FQ2_SQ_TEAM_REVERSE
};

// The group of fq_group.cuh on the host: the T lanes of one group as arrays
// of lane values, run phase by phase.  Every lane value starts poisoned (a
// pattern that is no field element's word and no 0/1 predicate), each()
// runs the lanes of a phase in lane order or, with `reverse`, last to first,
// and the exchanges read the source lanes' entries between phases: a lane
// that reads what no lane has produced yet, or a phase in which one lane's
// work depends on another's, changes the result.
template <int T>
struct HostGroup {
  static constexpr int LANES = T, W = BN_NW / T;
  template <class V>
  struct Lv {
    V v[T];
    Lv() { memset(v, 0xA5, sizeof v); }
    V& operator[](int l) { return v[l]; }
    const V& operator[](int l) const { return v[l]; }
  };
  bool reverse;
  template <class F>
  void each(F f) const {
    for (int i = 0; i < T; i++) f(reverse ? T - 1 - i : i);
  }
  Lv<uint32_t> bcast(const Lv<uint32_t>& x, int src) const {
    Lv<uint32_t> r;
    each([&](int l) { r[l] = x[src]; });
    return r;
  }
  Lv<uint32_t> rotate_down(const Lv<uint32_t>& x) const {
    Lv<uint32_t> r;
    each([&](int l) { r[l] = x[(l + 1) % T]; });
    return r;
  }
  Lv<uint32_t> rotate_up(const Lv<uint32_t>& x) const {
    Lv<uint32_t> r;
    each([&](int l) { r[l] = x[(l + T - 1) % T]; });
    return r;
  }
  uint32_t ballot(const Lv<uint32_t>& p) const {
    uint32_t r = 0;
    each([&](int l) { r |= (uint32_t)(p[l] != 0) << l; });
    return r;
  }
};

// kernel_pow_fixed.cu's group for every element of a (rows, 16, B) tensor,
// one group after another: the product fq_group_mul of a and b (pow = 0) or
// the ladder fq_group_pow of a with exponent e and the Montgomery one `one`,
// its table in a plain array laid out as the kernel's shared memory, lane l
// at offset l with stride T.
template <int T>
static void group_run(bool pow, bool reverse, const int32_t* a, const int32_t* b, int32_t* o, int64_t rows,
                      int64_t B, const Exp& e, const uint32_t* one, const Mod& m) {
  using G = HostGroup<T>;
  using Words = typename G::template Lv<GWords<G::W>>;
  const G g{reverse};
  const GroupMod<G> gm = fq_group_mod(g, m);
  for (int64_t t = 0; t < rows * B; t++) {
    const int64_t off = (t / B) * BN_NLIMB * B + (t % B);
    auto load = [&](const int32_t* p) {
      const Fq v = fq_load(p + off, B);
      Words r;
      g.each([&](int l) {
        for (int k = 0; k < G::W; k++) r[l].w[k] = v.w[l * G::W + k];
      });
      return r;
    };
    Words r;
    if (pow) {
      uint32_t tab[16 * BN_NW];
      memset(tab, 0xA5, sizeof tab);
      typename G::template Lv<uint32_t*> mine;
      g.each([&](int l) { mine[l] = tab + l; });
      r = fq_group_pow(g, load(a), fq_group_words(g, one), e, mine, T, gm);
    } else {
      r = fq_group_mul(g, load(a), load(b), gm);
    }
    Fq v;
    g.each([&](int l) {
      for (int k = 0; k < G::W; k++) v.w[l * G::W + k] = r[l].w[k];
    });
    fq_store(o + off, B, v);
  }
}

// team_block (team.cuh), the block of the teams that run in phases, one
// block after another: the block's shared memory (Team::Shared, laid out as
// the kernel's) starts every block filled with a pattern that is no field
// element; then each phase runs its warps over the block's 32 lanes, as
// between two barriers, members in order or, with `reverse`, last to first,
// after `poison(p, shared)` has refilled what phase p is to write.  The
// result does not change only if no warp reads what another warp of its
// phase writes, and no phase reads what no earlier phase wrote.  A lane past
// the end clamps its element and skips its stores, as in the kernel
// (team_lane_at).
template <class Team, class Poison>
static void team_run(const Team& team, int64_t rows, int64_t B, const Mod& m, bool reverse, Poison poison) {
  typename Team::Shared sh;
  const int64_t n = rows * B;
  for (int64_t first = 0; first < n; first += BN_TEAM_LANES) {
    memset(&sh, 0xFF, sizeof sh);
    for (int p = 0; p < Team::kPhases; p++) {
      poison(p, sh);
      for (int i = 0; i < Team::kWarps; i++) {
        const int w = reverse ? Team::kWarps - 1 - i : i;
        for (int lane = 0; lane < BN_TEAM_LANES; lane++) team.phase(p, team_lane_at(lane, w, first, n), B, sh, m);
      }
    }
  }
}

// fq12_team_block (fq12_team.cuh), the block of kernel_fq12_mul024.cu, kernel_fq12_mul024_pre.cu, kernel_fq12_sq.cu and
// kernel_fq12_cyclo_sq.cu: the MEMBERS members write their Fq2 products into
// the scratch, then the 6 combines read it and store.
template <int MEMBERS, class Member, class Combine>
static void fq12_team(const Member& member, const Combine& combine, int32_t* o, int64_t rows, int64_t B,
                      const Mod& m, bool reverse) {
  using Team = Fq12Team<MEMBERS, Member, Combine>;
  team_run(Team{o, member, combine}, rows, B, m, reverse, [](int, typename Team::Shared&) {});
}

// kernel_miller_step.cu's team: the scratch is poisoned again before the
// sparse multiply's members overwrite it (phase 3 of the square instance,
// phase 1 of the other), so a member that read a product of fq12_sq's
// would show.
template <bool kSquare>
static void miller_team(const int32_t* f, const int32_t* c, const int32_t* px, const int32_t* py, int32_t* o,
                        int64_t rows, int64_t B, const Mod& m, bool reverse) {
  using Team = MillerStepTeam<kSquare>;
  team_run(Team{f, c, px, py, o}, rows, B, m, reverse, [](int p, typename Team::Shared& sh) {
    if (p == (kSquare ? 3 : 1)) memset(sh.prods, 0xFF, sizeof sh.prods);
  });
}

// kernel_fq12_cyclo_sq_chain.cu's team, one block after another: the 6 slots
// of the block's 32 elements are loaded into a state laid out as the kernel's
// shared memory, [slot][coefficient][word][lane]; each of the n squarings, the
// 6 members (each over the 32 lanes) write their Fq2 products into a scratch
// laid out the same way, then, as after the barrier, the 6 combines rewrite
// the state's slots in place; after n squarings the slots are stored.  The
// state starts every block, and the scratch every squaring, filled with a
// pattern that is no field element, and `reverse` runs the members and the
// combines last to first: the result does not change only if no member reads
// another's product and no combine reads a slot another combine writes.  A
// lane past the end clamps its element and skips the store, as in the kernel.
static void fq12_cyclo_team(const int32_t* a, int32_t* o, int64_t rows, int64_t B, int n, const Mod& m,
                            bool reverse) {
  uint32_t state[BN_CYCLO_SLOTS * 2 * BN_NW * BN_TEAM_LANES];
  uint32_t prods[BN_CYCLO_MEMBERS * 2 * BN_NW * BN_TEAM_LANES];
  const int64_t total = rows * B;
  auto slot = [&](int64_t e, int k) { return fq12_offset(e, B) + (int64_t)k * 2 * BN_NLIMB * B; };
  for (int64_t first = 0; first < total; first += BN_TEAM_LANES) {
    for (uint32_t& x : state) x = 0xFFFFFFFFu;
    for (int k = 0; k < BN_CYCLO_SLOTS; k++)
      for (int lane = 0; lane < BN_TEAM_LANES; lane++)
        fq2_tab_store(state + lane, BN_TEAM_LANES, k,
                      fq2_load(a + slot(first + lane < total ? first + lane : total - 1, k), B));
    for (int i = 0; i < n; i++) {
      for (uint32_t& x : prods) x = 0xFFFFFFFFu;
      for (int j = 0; j < BN_CYCLO_MEMBERS; j++) {
        int w = reverse ? BN_CYCLO_MEMBERS - 1 - j : j;
        for (int lane = 0; lane < BN_TEAM_LANES; lane++)
          fq2_tab_store(prods + lane, BN_TEAM_LANES, w, fq12_cyclo_member(w, state + lane, BN_TEAM_LANES, m));
      }
      for (int j = 0; j < BN_CYCLO_SLOTS; j++) {
        int c = reverse ? BN_CYCLO_SLOTS - 1 - j : j;
        for (int lane = 0; lane < BN_TEAM_LANES; lane++)
          fq2_tab_store(state + lane, BN_TEAM_LANES, c,
                        fq12_cyclo_combine(c, prods + lane, state + lane, BN_TEAM_LANES, m));
      }
    }
    for (int k = 0; k < BN_CYCLO_SLOTS; k++)
      for (int lane = 0; lane < BN_TEAM_LANES && first + lane < total; lane++)
        fq2_store(o + slot(first + lane, k), B, fq2_tab_load(state + lane, BN_TEAM_LANES, k));
  }
}

// g2_step_team_block (g2_step_team.cuh), the block of kernels_g2_step.cu,
// one block after another: the step's inputs of the block's 32 elements are
// loaded into a state laid out as the kernel's shared memory,
// [slot][coefficient][word][lane]; then at each level the members (each over
// the 32 lanes) write their slots and the outputs of that level are stored;
// after the last level the rest are stored.  The state starts every block
// filled with a pattern that is no field element, and `reverse` runs each
// level's stores before its members and both last to first: the result does
// not change only if no member reads a slot of its own level and no store
// reads a slot its level writes.  A warp stores the outputs whose out_warp
// and out_level name it, as in the kernel, so an output no warp of the team
// stores is left unwritten.  A lane past the end clamps its element and skips
// the stores, as in the kernel.
template <class Step>
static void g2_step_team(const Step& step, int32_t* r_out, int32_t* c_out, int64_t rows, int64_t B, const Mod& m,
                         bool reverse) {
  uint32_t state[Step::SLOTS * 2 * BN_NW * BN_TEAM_LANES];
  const int64_t n = rows * B;
  for (int64_t first = 0; first < n; first += BN_TEAM_LANES) {
    auto elem = [&](int lane) { return first + lane < n ? first + lane : n - 1; };
    auto stores = [&](int l) {  // each warp's outputs of level l, as the kernel picks them
      for (int i = 0; i < Step::kMembers * BN_STEP_OUTPUTS; i++) {
        int j = reverse ? Step::kMembers * BN_STEP_OUTPUTS - 1 - i : i, w = j / BN_STEP_OUTPUTS, k = j % BN_STEP_OUTPUTS;
        if (Step::out_level(k) != l || Step::out_warp(k) != w) continue;
        for (int lane = 0; lane < BN_TEAM_LANES && first + lane < n; lane++)
          g2_step_store(r_out, c_out, k, first + lane, B, step.output(k, state + lane, BN_TEAM_LANES, m));
      }
    };
    for (uint32_t& x : state) x = 0xFFFFFFFFu;
    for (int k = 0; k < Step::kInputs; k++)
      for (int lane = 0; lane < BN_TEAM_LANES; lane++)
        fq2_tab_store(state + lane, BN_TEAM_LANES, k, step.input(k, elem(lane), B));
    for (int l = 0; l < Step::kLevels; l++) {
      if (reverse) stores(l);
      for (int i = 0; i < Step::kMembers; i++) {
        int w = reverse ? Step::kMembers - 1 - i : i;
        for (int lane = 0; lane < BN_TEAM_LANES; lane++) step.member(l, w, state + lane, BN_TEAM_LANES, m);
      }
      if (!reverse) stores(l);
    }
    stores(Step::kLevels);
  }
}

static Fq words_fq(const uint32_t* w) {
  Fq r;
  for (int i = 0; i < BN_NW; i++) r.w[i] = w[i];
  return r;
}

// k_signed_sum's grid as loops: every (output, row, lane) of the table.
template <class Table>
static void signed_sum_grid(const Table& t, const Mod& m) {
  for (int k = 0; k < t.n_out; k++)
    for (int32_t row = 0; row < t.rows; row++)
      for (int64_t b = 0; b < t.B; b++) signed_sum_element(t, k, row, b, m);
}

// bn_mod_signed_sum's table from the same host arrays (an Fq2SumTable with
// fq2 set); 1 when the entry would refuse them.
template <class Table>
static int host_level(const long long* desc, const int8_t* terms, int n_src, int n_out, int n1, int n2,
                      long long rows, long long B, const Mod& m) {
  Table t;
  if (!signed_sum_table(t, desc, terms, n_src, n_out, n1, n2, rows, B)) return 1;
  signed_sum_grid(t, m);
  return 0;
}

extern "C" int host_signed_sum(const long long* desc, const int8_t* terms, int n_src, int n_out, int n1, int n2,
                               long long rows, long long B, int fq2, const uint32_t* mod, uint32_t inv) {
  Mod m;
  for (int i = 0; i < BN_NW; i++) m.w[i] = mod[i];
  m.inv = inv;
  return fq2 ? host_level<Fq2SumTable>(desc, terms, n_src, n_out, n1, n2, rows, B, m)
             : host_level<SumTable>(desc, terms, n_src, n_out, n1, n2, rows, B, m);
}

// out2 is the second output of the step kernels.  n and extra are a kernel's
// own arguments: pow_fixed takes n = digit count and extra = exponent words
// then the words of R mod m; the chain takes n = squarings; double_step takes
// extra = the words of 1/2 then of the twist's b, its team the twist's b only.
extern "C" int host_run(int op, const int32_t* a, const int32_t* b, const int32_t* c, int32_t* o,
                        int32_t* out2, long long rows, long long B, int n, const uint32_t* extra,
                        const uint32_t* mod, uint32_t inv) {
  Mod m;
  for (int i = 0; i < BN_NW; i++) m.w[i] = mod[i];
  m.inv = inv;
  if (op == OP_FQ12_MUL_TEAM || op == OP_FQ12_MUL_TEAM_REVERSE) {  // kernel_fq12_mul.cu's team, lazy reduction
    if (!fq12_mul_modulus_is_q(mod)) return 1;
    team_run(Fq12MulTeam{a, b, o}, rows, B, m, op == OP_FQ12_MUL_TEAM_REVERSE, [](int, Fq12MulTeam::Shared&) {});
    return 0;
  }
  if (op == OP_FQ12_MUL024_TEAM || op == OP_FQ12_MUL024_TEAM_REVERSE) {  // f, ell0, scaled
    fq12_team<BN_MUL024_MEMBERS>(fq12_mul024_member(Fq12Global{a}, LineScaled{b, c}), Fq12Mul024Combine(), o, rows,
                                 B, m, op == OP_FQ12_MUL024_TEAM_REVERSE);
    return 0;
  }
  if (op == OP_FQ12_MUL024_LINE_TEAM || op == OP_FQ12_MUL024_LINE_TEAM_REVERSE) {  // f, the unscaled coefficients
    fq12_team<BN_MUL024_MEMBERS>(fq12_mul024_member(Fq12Global{a}, LineCoeffs{b}), Fq12Mul024Combine(), o, rows, B,
                                 m, op == OP_FQ12_MUL024_LINE_TEAM_REVERSE);
    return 0;
  }
  if (op == OP_FQ12_SQ_TEAM || op == OP_FQ12_SQ_TEAM_REVERSE) {
    fq12_team<BN_SQ_MEMBERS>(fq12_sq_member(Fq12Global{a}), Fq12SqCombine(), o, rows, B, m,
                             op == OP_FQ12_SQ_TEAM_REVERSE);
    return 0;
  }
  if (op == OP_DOUBLE_STEP_TEAM || op == OP_DOUBLE_STEP_TEAM_REVERSE) {  // extra: the twist's b
    Fq2 tb;
    tb.c0 = words_fq(extra);
    tb.c1 = words_fq(extra + BN_NW);
    g2_step_team(G2DoubleTeam{a, tb}, o, out2, rows, B, m, op == OP_DOUBLE_STEP_TEAM_REVERSE);
    return 0;
  }
  if (op == OP_MADD_STEP_TEAM || op == OP_MADD_STEP_TEAM_REVERSE) {  // r, base
    g2_step_team(G2MaddTeam{a, b}, o, out2, rows, B, m, op == OP_MADD_STEP_TEAM_REVERSE);
    return 0;
  }
  if (op == OP_FQ12_CYCLO_TEAM || op == OP_FQ12_CYCLO_TEAM_REVERSE) {
    fq12_cyclo_team(a, o, rows, B, n, m, op == OP_FQ12_CYCLO_TEAM_REVERSE);
    return 0;
  }
  if (op == OP_FQ12_CYCLO_SQ_TEAM || op == OP_FQ12_CYCLO_SQ_TEAM_REVERSE) {  // kernel_fq12_cyclo_sq.cu's team
    fq12_team<BN_CYCLO_MEMBERS>(Fq12CycloSqMember{a}, Fq12CycloSqCombine{a}, o, rows, B, m,
                                op == OP_FQ12_CYCLO_SQ_TEAM_REVERSE);
    return 0;
  }
  if (op >= OP_GROUP_MUL_4 && op <= OP_GROUP_POW_8_REVERSE) {  // pow: n = digit count, extra = e then one
    const int k = op - OP_GROUP_MUL_4;
    const bool pow = k >= 4, eight = k % 4 >= 2, reverse = k % 2;
    Exp e = {};
    if (pow) {
      for (int i = 0; i < BN_NW; i++) e.w[i] = extra[i];
      e.nd = n;
    }
    const uint32_t* one = pow ? extra + BN_NW : nullptr;
    if (eight)
      group_run<8>(pow, reverse, a, b, o, rows, B, e, one, m);
    else
      group_run<4>(pow, reverse, a, b, o, rows, B, e, one, m);
    return 0;
  }
  if (op == OP_MOD_SUB) {  // kernels_fq.cu's entries: a table of one output, fixed at compile time
    SumDense<1, -2, 1> t;
    if (!signed_sum_dense(t, a, b, o, rows, B)) return 1;
    signed_sum_grid(t, m);
    return 0;
  }
  if (op == OP_MOD_NEG) {
    SumDense<-1, 0, 1> t;
    if (!signed_sum_dense(t, a, nullptr, o, rows, B)) return 1;
    signed_sum_grid(t, m);
    return 0;
  }
  if (op == OP_FQ2_XI) {
    SumDense<BN_SUM_XI + 1, 0, 2> t;
    if (!signed_sum_dense(t, a, nullptr, o, rows, B)) return 1;
    signed_sum_grid(t, m);
    return 0;
  }
  if (op == OP_FQ2_SQ_TEAM || op == OP_FQ2_SQ_TEAM_REVERSE) {  // kernels_fq.cu's team, warps in order or reversed
    team_run(Fq2SqTeam{a, o}, rows, B, m, op == OP_FQ2_SQ_TEAM_REVERSE, [](int, Fq2SqTeam::Shared&) {});
    return 0;
  }
  for (int64_t t = 0; t < rows * B; t++) {
    int64_t row = t / B, bb = t % B;
    int64_t o1 = row * BN_NLIMB * B + bb, o2 = 2 * row * BN_NLIMB * B + bb,
            o4 = 4 * row * BN_NLIMB * B + bb, o6 = 6 * row * BN_NLIMB * B + bb,
            o12 = 12 * row * BN_NLIMB * B + bb;
    switch (op) {
      case OP_MONT_MUL: fq_store(o + o1, B, fq_mont_mul_inline(fq_load(a + o1, B), fq_load(b + o1, B), m)); break;
      case OP_MOD_ADD: fq_store(o + o1, B, fq_add(fq_load(a + o1, B), fq_load(b + o1, B), m)); break;
      case OP_FQ2_MUL: fq2_store(o + o2, B, fq2_mul(fq2_load(a + o2, B), fq2_load(b + o2, B), m)); break;
      case OP_FQ2_SQ: fq2_store(o + o2, B, fq2_sq(fq2_load(a + o2, B), m)); break;
      case OP_FQ12_MUL: fq12_store(o + o12, B, fq12_mul(fq12_load(a + o12, B), fq12_load(b + o12, B), m)); break;
      case OP_FQ12_SQ: fq12_store(o + o12, B, fq12_sq(fq12_load(a + o12, B), m)); break;
      case OP_FQ12_CYCLO_SQ: fq12_store(o + o12, B, fq12_cyclo_sq(fq12_load(a + o12, B), m)); break;
      case OP_FQ12_MUL024_PRE: {
        const int32_t* s = c + 4 * row * BN_NLIMB * B + bb;
        fq12_store(o + o12, B,
                   fq12_mul_by_024(fq12_load(a + o12, B), fq2_load(b + o2, B),
                                   fq2_load(s + 2 * BN_NLIMB * B, B), fq2_load(s, B), m));
        break;
      }
      case OP_POW_FIXED: {
        Exp e;
        for (int i = 0; i < BN_NW; i++) e.w[i] = extra[i];
        e.nd = n;
        uint32_t tab[16 * BN_NW];
        fq_store(o + o1, B, fq_pow_fixed(fq_load(a + o1, B), words_fq(extra + BN_NW), e, tab, 1, m));
        break;
      }
      case OP_FQ12_CYCLO_SQ_CHAIN: {
        Fq12 v = fq12_load(a + o12, B);
        for (int i = 0; i < n; i++) v = fq12_cyclo_sq(v, m);
        fq12_store(o + o12, B, v);
        break;
      }
      case OP_DOUBLE_STEP: {
        G2Proj p = g2_load(a + o6, B);
        EllCoeffs co;
        Fq2 tb;
        tb.c0 = words_fq(extra + BN_NW);
        tb.c1 = words_fq(extra + 2 * BN_NW);
        g2_double_step(p, co, words_fq(extra), tb, m);
        g2_store(o + o6, B, p);
        ell_store(out2 + o6, B, co);
        break;
      }
      case OP_MADD_STEP: {
        G2Proj p = g2_load(a + o6, B);
        EllCoeffs co;
        g2_madd_step(p, co, fq2_load(b + o4, B), fq2_load(b + o4 + 2 * BN_NLIMB * B, B), m);
        g2_store(o + o6, B, p);
        ell_store(out2 + o6, B, co);
        break;
      }
      case OP_FQ12_MUL024:
        fq12_store(o + o12, B, fq12_mul_by_line(fq12_load(a + o12, B), ell_load(b + o6, B), m));
        break;
      default: return 1;
    }
  }
  return 0;
}

// miller_step: f (a), the step's coefficients (c), the G1 point (px, py);
// square = 1 squares f first, as on a doubling step.
// fq12_mul_team.cuh's plan and the constants its bounds are stated in:
// terms (12 x 24 codes), counts (12), and consts = K, BN_DW_SUM_BITS,
// BN_DW_REDC_BITS, BN_DW_EST_LOW, BN_DW_EST_SHIFT, est, BN_MUL_NINE.
extern "C" int host_fq12_mul_plan(int8_t* terms, int8_t* counts, uint32_t* consts) {
  const Fq12MulPlan& p = kFq12MulPlan;
  memcpy(terms, p.term, sizeof p.term);
  memcpy(counts, p.terms, sizeof p.terms);
  const uint32_t c[7] = {BN_MUL_OFFSET_K, BN_DW_SUM_BITS, BN_DW_REDC_BITS, BN_DW_EST_LOW, BN_DW_EST_SHIFT, p.est,
                         BN_MUL_NINE};
  memcpy(consts, c, sizeof c);
  return 0;
}

// fq_dw.cuh on n values: op 0 dw_mul of a[i] and b[i] (8 words each) into
// out (16 words); op 1 dw_redc then dw_canonical of a[i] (17 words) into out
// (8 words), with the modulus q.
extern "C" int host_dw(int op, long long n, const uint32_t* a, const uint32_t* b, uint32_t* out) {
  Mod m;
  const DwInt q = dw_q();
  for (int i = 0; i < BN_NW; i++) m.w[i] = q.w[i];
  m.inv = dw_q_inv();
  for (long long i = 0; i < n; i++) {
    if (op == 0) {
      dw_mul(out + i * BN_DW, a + i * BN_NW, b + i * BN_NW);
    } else {
      uint32_t t[BN_DW_ACC], r[BN_NW + 1];
      memcpy(t, a + i * BN_DW_ACC, sizeof t);
      dw_redc(r, t, m);
      const Fq v = dw_canonical(r, kFq12MulPlan.est, m);
      memcpy(out + i * BN_NW, v.w, sizeof v.w);
    }
  }
  return 0;
}

extern "C" int host_miller_step(int square, const int32_t* f, const int32_t* c, const int32_t* px,
                                const int32_t* py, int32_t* o, long long rows, long long B, const uint32_t* mod,
                                uint32_t inv) {
  Mod m;
  for (int i = 0; i < BN_NW; i++) m.w[i] = mod[i];
  m.inv = inv;
  for (int64_t t = 0; t < rows * B; t++) {
    int64_t row = t / B, bb = t % B;
    int64_t o1 = row * BN_NLIMB * B + bb, o6 = 6 * row * BN_NLIMB * B + bb, o12 = 12 * row * BN_NLIMB * B + bb;
    Fq12 a = fq12_load(f + o12, B);
    EllCoeffs co = ell_load(c + o6, B);
    Fq x = fq_load(px + o1, B), y = fq_load(py + o1, B);
    fq12_store(o + o12, B, square ? fq12_miller_step<true>(a, co, x, y, m) : fq12_miller_step<false>(a, co, x, y, m));
  }
  return 0;
}

// kernel_miller_step.cu's team (miller_team): the same operands, members in
// order (reverse = 0) or last to first.
extern "C" int host_miller_team(int square, int reverse, const int32_t* f, const int32_t* c, const int32_t* px,
                                const int32_t* py, int32_t* o, long long rows, long long B, const uint32_t* mod,
                                uint32_t inv) {
  Mod m;
  for (int i = 0; i < BN_NW; i++) m.w[i] = mod[i];
  m.inv = inv;
  if (square)
    miller_team<true>(f, c, px, py, o, rows, B, m, reverse);
  else
    miller_team<false>(f, c, px, py, o, rows, B, m, reverse);
  return 0;
}

// point_add (add = 1: six coordinate arrays in, three out) and point_double
// (add = 0: three in, three out) over Fq (fq2 = 0) or Fq2, with the kernels'
// offsets: every coordinate is its own array.
template <class F>
static void curve_run(int add, const int32_t* const* in, int32_t* const* out, long long rows, long long B,
                      const Mod& m) {
  for (int64_t t = 0; t < rows * B; t++) {
    int64_t off = (t / B) * FieldIO<F>::width * BN_NLIMB * B + (t % B);
    Jac<F> p, q, r;
    p.x = FieldIO<F>::load(in[0] + off, B);
    p.y = FieldIO<F>::load(in[1] + off, B);
    p.z = FieldIO<F>::load(in[2] + off, B);
    if (add) {
      q.x = FieldIO<F>::load(in[3] + off, B);
      q.y = FieldIO<F>::load(in[4] + off, B);
      q.z = FieldIO<F>::load(in[5] + off, B);
      r = jac_add(p, q, m);
    } else {
      r = jac_double(p, m);
    }
    FieldIO<F>::store(out[0] + off, B, r.x);
    FieldIO<F>::store(out[1] + off, B, r.y);
    FieldIO<F>::store(out[2] + off, B, r.z);
  }
}

extern "C" int host_curve(int add, int fq2, const int32_t* const* in, int32_t* const* out, long long rows,
                          long long B, const uint32_t* mod, uint32_t inv) {
  Mod m;
  for (int i = 0; i < BN_NW; i++) m.w[i] = mod[i];
  m.inv = inv;
  if (fq2)
    curve_run<Fq2>(add, in, out, rows, B, m);
  else
    curve_run<Fq>(add, in, out, rows, B, m);
  return 0;
}

// kernels_curve.cu's teams (curve_team.cuh) on team_run: point_add (add = 1)
// or point_double with the one-thread kernels' arguments, over Fq (fq2 = 0)
// or Fq2; the warps of each phase in order or, with `reverse`, last to
// first, the state poisoned at every block.
template <class F, bool kAdd>
static void curve_team_run(const int32_t* const* in, int32_t* const* out, long long rows, long long B, const Mod& m,
                           bool reverse) {
  CurveTeam<F, kAdd> team;
  for (int k = 0; k < CurveTeam<F, kAdd>::kInputs; k++) team.in[k] = in[k];
  for (int k = 0; k < 3; k++) team.out[k] = out[k];
  team_run(team, rows, B, m, reverse, [](int, typename CurveTeam<F, kAdd>::Shared&) {});
}

template <class F>
static void curve_team_law(int add, const int32_t* const* in, int32_t* const* out, long long rows, long long B,
                           const Mod& m, bool reverse) {
  if (add)
    curve_team_run<F, true>(in, out, rows, B, m, reverse);
  else
    curve_team_run<F, false>(in, out, rows, B, m, reverse);
}

extern "C" int host_curve_team(int add, int fq2, int reverse, const int32_t* const* in, int32_t* const* out,
                               long long rows, long long B, const uint32_t* mod, uint32_t inv) {
  Mod m;
  for (int i = 0; i < BN_NW; i++) m.w[i] = mod[i];
  m.inv = inv;
  if (fq2)
    curve_team_law<Fq2>(add, in, out, rows, B, m, reverse);
  else
    curve_team_law<Fq>(add, in, out, rows, B, m, reverse);
  return 0;
}

// carry.cuh's primitives (their host twins), in the order of CARRY_OPS in
// tests/test_torch_csrc_host.py, element by element: the flag starts at
// cin[k], d[k] is the result and cout[k] the flag after it.  Two-operand
// primitives ignore c.
extern "C" int host_carry(int op, long long n, const uint32_t* a, const uint32_t* b, const uint32_t* c,
                          const uint32_t* cin, uint32_t* d, uint32_t* cout) {
  for (long long k = 0; k < n; k++) {
    Carry f;
    f.cf = cin[k];
    switch (op) {
      case 0: d[k] = add_cc(f, a[k], b[k]); break;
      case 1: d[k] = addc_cc(f, a[k], b[k]); break;
      case 2: d[k] = addc(f, a[k], b[k]); break;
      case 3: d[k] = sub_cc(f, a[k], b[k]); break;
      case 4: d[k] = subc_cc(f, a[k], b[k]); break;
      case 5: d[k] = subc(f, a[k], b[k]); break;
      case 6: d[k] = mad_lo_cc(f, a[k], b[k], c[k]); break;
      case 7: d[k] = madc_lo_cc(f, a[k], b[k], c[k]); break;
      case 8: d[k] = mad_hi_cc(f, a[k], b[k], c[k]); break;
      case 9: d[k] = madc_hi_cc(f, a[k], b[k], c[k]); break;
      case 10: d[k] = madc_hi(f, a[k], b[k], c[k]); break;
      default: return 1;
    }
    cout[k] = f.cf;
  }
  return 0;
}
