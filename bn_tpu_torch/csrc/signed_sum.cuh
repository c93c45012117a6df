// A level of signed sums: out[k] = sum_j s_kj * src[j] mod m, s_kj in {-1, 0, +1},
// or over Fq2 also s_kj in {-xi, +xi} (xi = 9 + u).
//
// A tower formula's sums, differences, negations and conjugations come in
// levels: every sum of a level reads only what earlier levels wrote.  The
// kernel of kernels_fq.cu (k_signed_sum) computes a whole level in one launch,
// so the launch floor is paid once a level rather than once an operation, and
// writes each result where its consumer reads it (a slice of a stacked or
// packed tensor), so no concatenation follows.  mod_sub and mod_neg are its
// two-term and one-term cases.
//
// Two forms.  A base-field level's element is one field element: a thread
// owns one lane of one output.  An Fq2 level's element is an Fq2, and a term
// may multiply its source by xi = 9 + u, (9 c0 - c1, c0 + 9 c1), which mixes
// the two coefficients: a thread owns one Fq2 lane of one output, loads both
// coefficients of each term's source and stores both of the output.  So a
// tower formula's products by xi join the level that reads or writes their
// operands, and fq2_xi alone is the Fq2 form's one-term case.
//
// The level travels as a table (SumTable) in the kernel's parameters, by
// value: the C entry copies it from host arrays before the launch, so a
// captured CUDA graph holds the table itself and no pointer to a host or
// device buffer that could be freed.
//
// Operands.  Every source and every output is a tensor of elements (rows, 16,
// B) whose (16, B) block is dense (limb i of lane b at i*B + b), or for the
// Fq2 form (rows, 2, 16, B) whose (2, 16, B) block is dense (limb i of
// coefficient c of lane b at (c*16 + i)*B + b), and whose rows
// are spread by up to three strides: row r = (r0, r1, r2), r2 fastest, lies
// at r0*s[0] + r1*s[1] + r2*s[2] elements from the operand's base.  So a slice
// such as the second half of an Fq12 with leading batch axes is read in
// place, and an output lands in the slice of the tensor its consumer reads.
//
// This header is plain C++ outside a CUDA compile, so the per-thread body
// (signed_sum_element) and the tables the C entries build are checked on the
// host by tests/test_torch_csrc_host.py.
#pragma once

#include "tower.cuh"

#define BN_SUM_MAX_TERMS 4     // terms of one output
#define BN_SUM_MAX_SOURCES 16  // sources of one level
#define BN_SUM_MAX_OUTPUTS 16  // outputs of one level
#define BN_SUM_ROW_DIMS 3      // strides that spread an operand's rows
#define BN_SUM_XI 32           // a term's flag: xi times its source (the Fq2 form only)

struct SumOperand {
  int32_t* p;                  // element (0, 0, 0), limb 0, lane 0
  int64_t s[BN_SUM_ROW_DIMS];  // element strides of the row axes r0, r1, r2
};

struct SumRow {
  int32_t r0, r1, r2;
};

BN_DEV int32_t* sum_at(const SumOperand& op, SumRow r, int64_t b) {
  return op.p + r.r0 * op.s[0] + r.r1 * op.s[1] + r.r2 * op.s[2] + b;
}

// A term's code: +(i + 1) adds source i, -(i + 1) subtracts it (as a first
// term: negates it), and with BN_SUM_XI added to i + 1 the same of xi times
// source i; 0 ends an output's terms.
BN_CONSTEXPR int sum_source(int code) { return ((code < 0 ? -code : code) & (BN_SUM_XI - 1)) - 1; }
BN_CONSTEXPR bool sum_xi(int code) { return ((code < 0 ? -code : code) & BN_SUM_XI) != 0; }

// An element of a level: one field element (width 1) or an Fq2 (width 2),
// with its loads, stores and sums.
template <int W>
struct SumValue;
template <>
struct SumValue<1> {
  using T = Fq;
  static BN_DEV T load(const int32_t* p, int64_t B) { return fq_load(p, B); }
  static BN_DEV void store(int32_t* p, int64_t B, const T& v) { fq_store(p, B, v); }
  static BN_DEV T neg(const T& a, const Mod& m) { return fq_neg(a, m); }
  static BN_DEV T add(const T& a, const T& b, const Mod& m) { return fq_add(a, b, m); }
  static BN_DEV T sub(const T& a, const T& b, const Mod& m) { return fq_sub(a, b, m); }
};
template <>
struct SumValue<2> {
  using T = Fq2;
  static BN_DEV T load(const int32_t* p, int64_t B) { return fq2_load(p, B); }
  static BN_DEV void store(int32_t* p, int64_t B, const T& v) { fq2_store(p, B, v); }
  static BN_DEV T neg(const T& a, const Mod& m) { return fq2_neg(a, m); }
  static BN_DEV T add(const T& a, const T& b, const Mod& m) { return fq2_add(a, b, m); }
  static BN_DEV T sub(const T& a, const T& b, const Mod& m) { return fq2_sub(a, b, m); }
};

// A level's table, read at run time: its terms, sources and outputs.  Its
// element is a field element; Fq2SumTable's, the same table, an Fq2.
struct SumTable {
  static constexpr int kWidth = 1;
  SumOperand src[BN_SUM_MAX_SOURCES];
  SumOperand out[BN_SUM_MAX_OUTPUTS];
  // output k's term j, as sum_source and sum_xi read it
  int8_t term[BN_SUM_MAX_OUTPUTS][BN_SUM_MAX_TERMS];
  int32_t n1, n2;  // extents of the row axes r1 and r2
  int32_t rows;    // rows of every operand: r0's extent times n1 n2
  int32_t n_out;
  int64_t B;

  BN_DEV SumRow row_at(int32_t row) const {
    SumRow r = {row, 0, 0};
    if (n1 > 1 || n2 > 1) {  // the same for every thread: no divisions for rows on r0 alone
      r.r2 = row % n2;
      r.r0 = row / n2;
      r.r1 = r.r0 % n1;
      r.r0 /= n1;
    }
    return r;
  }
  BN_DEV int code(int k, int j) const { return term[k][j]; }
  BN_DEV const int32_t* src_at(int i, SumRow r, int64_t b) const { return sum_at(src[i], r, b); }
  BN_DEV int32_t* out_at(int k, SumRow r, int64_t b) const { return sum_at(out[k], r, b); }
};

struct Fq2SumTable : SumTable {
  static constexpr int kWidth = 2;
};

// The table of a single operation on dense (rows, W, 16, B) tensors (W = 1:
// (rows, 16, B)), its terms fixed at compile time (mod_sub: +1, -2; mod_neg:
// -1; fq2_xi: +xi): one output, no indirection, so no load waits on a read of
// the table.
template <int C0, int C1, int W>
struct SumDense {
  static constexpr int kWidth = W;
  const int32_t* a;
  const int32_t* b;  // unused by a one-term table
  int32_t* o;
  int32_t rows, n_out;
  int64_t B;

  BN_DEV SumRow row_at(int32_t row) const { return {row, 0, 0}; }
  BN_DEV int code(int, int j) const { return j == 0 ? C0 : j == 1 ? C1 : 0; }
  BN_DEV const int32_t* src_at(int i, SumRow r, int64_t lane) const {
    return (i == 0 ? a : b) + r.r0 * (W * BN_NLIMB * B) + lane;
  }
  BN_DEV int32_t* out_at(int, SumRow r, int64_t lane) const { return o + r.r0 * (W * BN_NLIMB * B) + lane; }
};

static_assert(BN_SUM_MAX_SOURCES < BN_SUM_XI && 2 * BN_SUM_XI <= 127, "a term's code is a signed byte");
static_assert(BN_SUM_MAX_TERMS >= 2, "mod_sub is a level of one two-term output");
// by-value kernel parameters are limited to 4 KB
static_assert(sizeof(SumTable) + sizeof(Mod) <= 4096, "the table must fit the kernel's parameters");

// Output k of lane b of row `row`: every term's operand is loaded first, so
// that the loads of all terms are in flight together (a single sum's time is
// mostly their latency), then the xi terms' operands are multiplied by xi
// (tower.cuh's fq2_xi, a doubling chain), and the terms are combined in
// table order, reduced after every term, so each partial result is below m
// and the result is the canonical residue whatever the order of the terms.
template <class Table>
BN_DEV void signed_sum_element(const Table& t, int k, int32_t row, int64_t b, const Mod& m) {
  using V = SumValue<Table::kWidth>;
  const SumRow r = t.row_at(row);
  int code[BN_SUM_MAX_TERMS];
  typename V::T x[BN_SUM_MAX_TERMS] = {};
#pragma unroll
  for (int j = 0; j < BN_SUM_MAX_TERMS; j++) {
    code[j] = t.code(k, j);
    if (code[j] != 0) x[j] = V::load(t.src_at(sum_source(code[j]), r, b), t.B);
  }
  if constexpr (Table::kWidth == 2) {
#pragma unroll
    for (int j = 0; j < BN_SUM_MAX_TERMS; j++) {
      if (sum_xi(code[j])) x[j] = fq2_xi(x[j], m);
    }
  }
  typename V::T acc = code[0] < 0 ? V::neg(x[0], m) : x[0];
#pragma unroll
  for (int j = 1; j < BN_SUM_MAX_TERMS; j++) {
    if (code[j] != 0) acc = code[j] < 0 ? V::sub(acc, x[j], m) : V::add(acc, x[j], m);
  }
  V::store(t.out_at(k, r, b), t.B, acc);
}

// The table of a level from the C entry's host arrays: desc holds four
// int64 a operand, the sources then the outputs (address, s[0], s[1], s[2]);
// terms holds BN_SUM_MAX_TERMS codes an output.  False when a count or a
// code is out of range, or a base-field level has a xi term: nothing is
// launched then.
template <class Table>
static inline bool signed_sum_table(Table& t, const long long* desc, const int8_t* terms, int n_src, int n_out,
                                    int n1, int n2, long long rows, long long B) {
  if (n_src < 1 || n_src > BN_SUM_MAX_SOURCES || n_out < 1 || n_out > BN_SUM_MAX_OUTPUTS || n1 < 1 || n2 < 1 ||
      rows < 0 || rows > INT32_MAX || rows % ((long long)n1 * n2) != 0 || B < 0)
    return false;
  t = Table{};
  for (int i = 0; i < n_src + n_out; i++) {
    SumOperand& op = i < n_src ? t.src[i] : t.out[i - n_src];
    op.p = (int32_t*)(intptr_t)desc[4 * i];
    for (int d = 0; d < BN_SUM_ROW_DIMS; d++) op.s[d] = desc[4 * i + 1 + d];
  }
  for (int k = 0; k < n_out; k++) {
    for (int j = 0; j < BN_SUM_MAX_TERMS; j++) {
      const int c = terms[k * BN_SUM_MAX_TERMS + j];
      const int a = c < 0 ? -c : c;
      if (a >= 2 * BN_SUM_XI || (c != 0 && (sum_source(c) >= n_src || sum_source(c) < 0)) ||
          (sum_xi(c) && Table::kWidth != 2) || (j == 0 && c == 0) ||
          (j > 0 && c != 0 && terms[k * BN_SUM_MAX_TERMS + j - 1] == 0))
        return false;
      t.term[k][j] = (int8_t)c;
    }
  }
  t.n1 = n1;
  t.n2 = n2;
  t.rows = (int32_t)rows;
  t.n_out = n_out;
  t.B = B;
  return true;
}

// The table of a single operation on dense (rows, W, 16, B) tensors.  False
// when `rows` is out of range.
template <int C0, int C1, int W>
static inline bool signed_sum_dense(SumDense<C0, C1, W>& t, const int32_t* a, const int32_t* b, int32_t* o,
                                    long long rows, long long B) {
  if (rows < 0 || rows > INT32_MAX || B < 0) return false;
  t = SumDense<C0, C1, W>{a, b, o, (int32_t)rows, 1, B};
  return true;
}
