// A level of signed sums: out[k] = sum_j s_kj * src[j] mod m, s_kj in {-1, 0, +1}.
//
// A tower formula's sums, differences, negations and conjugations come in
// levels: every sum of a level reads only what earlier levels wrote.  The
// kernel of kernels_fq.cu (k_signed_sum) computes a whole level in one launch,
// so the launch floor is paid once a level rather than once an operation, and
// writes each result where its consumer reads it (a slice of a stacked or
// packed tensor), so no concatenation follows.  mod_sub and mod_neg are its
// two-term and one-term cases.
//
// The level travels as a table (SumTable) in the kernel's parameters, by
// value: the C entry copies it from host arrays before the launch, so a
// captured CUDA graph holds the table itself and no pointer to a host or
// device buffer that could be freed.
//
// Operands.  Every source and every output is a tensor of elements (rows, 16,
// B) whose (16, B) block is dense (limb i of lane b at i*B + b) and whose rows
// are spread by up to three strides: row r = (r0, r1, r2), r2 fastest, lies
// at r0*s[0] + r1*s[1] + r2*s[2] elements from the operand's base.  So a slice
// such as the second half of an Fq12 with leading batch axes is read in
// place, and an output lands in the slice of the tensor its consumer reads.
//
// This header is plain C++ outside a CUDA compile, so the per-thread body
// (signed_sum_element) and the tables the C entries build are checked on the
// host by tests/test_torch_csrc_host.py.
#pragma once

#include "fq.cuh"

#define BN_SUM_MAX_TERMS 4     // terms of one output
#define BN_SUM_MAX_SOURCES 16  // sources of one level
#define BN_SUM_MAX_OUTPUTS 16  // outputs of one level
#define BN_SUM_ROW_DIMS 3      // strides that spread an operand's rows

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

// A level's table, read at run time: its terms, sources and outputs.
struct SumTable {
  SumOperand src[BN_SUM_MAX_SOURCES];
  SumOperand out[BN_SUM_MAX_OUTPUTS];
  // output k's term j: +(i + 1) adds source i, -(i + 1) subtracts it (as a
  // first term: negates it), 0 ends the output's terms
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

// The table of a single operation on dense (rows, 16, B) tensors, its terms
// fixed at compile time (mod_sub: +1, -2; mod_neg: -1): one output, no
// indirection, so no load waits on a read of the table.
template <int C0, int C1>
struct SumDense {
  const int32_t* a;
  const int32_t* b;  // unused by a one-term table
  int32_t* o;
  int32_t rows, n_out;
  int64_t B;

  BN_DEV SumRow row_at(int32_t row) const { return {row, 0, 0}; }
  BN_DEV int code(int, int j) const { return j == 0 ? C0 : j == 1 ? C1 : 0; }
  BN_DEV const int32_t* src_at(int i, SumRow r, int64_t lane) const {
    return (i == 0 ? a : b) + r.r0 * (BN_NLIMB * B) + lane;
  }
  BN_DEV int32_t* out_at(int, SumRow r, int64_t lane) const { return o + r.r0 * (BN_NLIMB * B) + lane; }
};

static_assert(BN_SUM_MAX_SOURCES <= 127, "a term is a source index in a signed byte");
static_assert(BN_SUM_MAX_TERMS >= 2, "mod_sub is a level of one two-term output");
// by-value kernel parameters are limited to 4 KB
static_assert(sizeof(SumTable) + sizeof(Mod) <= 4096, "the table must fit the kernel's parameters");

// Output k of lane b of row `row`: every term's operand is loaded first, so
// that the loads of all terms are in flight together (a single sum's time is
// mostly their latency), then the terms are combined in table order, reduced
// after every term, so each partial result is below m and the result is the
// canonical residue whatever the order of the terms.
template <class Table>
BN_DEV void signed_sum_element(const Table& t, int k, int32_t row, int64_t b, const Mod& m) {
  const SumRow r = t.row_at(row);
  int code[BN_SUM_MAX_TERMS];
  Fq x[BN_SUM_MAX_TERMS] = {};
#pragma unroll
  for (int j = 0; j < BN_SUM_MAX_TERMS; j++) {
    code[j] = t.code(k, j);
    if (code[j] != 0) x[j] = fq_load(t.src_at((code[j] < 0 ? -code[j] : code[j]) - 1, r, b), t.B);
  }
  Fq acc = code[0] < 0 ? fq_neg(x[0], m) : x[0];
#pragma unroll
  for (int j = 1; j < BN_SUM_MAX_TERMS; j++) {
    if (code[j] != 0) acc = code[j] < 0 ? fq_sub(acc, x[j], m) : fq_add(acc, x[j], m);
  }
  fq_store(t.out_at(k, r, b), t.B, acc);
}

// The table of a level from the C entry's host arrays: desc holds four
// int64 a operand, the sources then the outputs (address, s[0], s[1], s[2]);
// terms holds BN_SUM_MAX_TERMS codes an output.  False when a count or a
// code is out of range: nothing is launched then.
static inline bool signed_sum_table(SumTable& t, const long long* desc, const int8_t* terms, int n_src, int n_out,
                                    int n1, int n2, long long rows, long long B) {
  if (n_src < 1 || n_src > BN_SUM_MAX_SOURCES || n_out < 1 || n_out > BN_SUM_MAX_OUTPUTS || n1 < 1 || n2 < 1 ||
      rows < 0 || rows > INT32_MAX || rows % ((long long)n1 * n2) != 0 || B < 0)
    return false;
  t = SumTable{};
  for (int i = 0; i < n_src + n_out; i++) {
    SumOperand& op = i < n_src ? t.src[i] : t.out[i - n_src];
    op.p = (int32_t*)(intptr_t)desc[4 * i];
    for (int d = 0; d < BN_SUM_ROW_DIMS; d++) op.s[d] = desc[4 * i + 1 + d];
  }
  for (int k = 0; k < n_out; k++) {
    for (int j = 0; j < BN_SUM_MAX_TERMS; j++) {
      const int c = terms[k * BN_SUM_MAX_TERMS + j];
      if (c < -n_src || c > n_src || (j == 0 && c == 0) || (j > 0 && c != 0 && terms[k * BN_SUM_MAX_TERMS + j - 1] == 0))
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

// The table of a single operation on dense (rows, 16, B) tensors.  False
// when `rows` is out of range.
template <int C0, int C1>
static inline bool signed_sum_dense(SumDense<C0, C1>& t, const int32_t* a, const int32_t* b, int32_t* o, long long rows,
                                    long long B) {
  if (rows < 0 || rows > INT32_MAX || B < 0) return false;
  t = SumDense<C0, C1>{a, b, o, (int32_t)rows, 1, B};
  return true;
}
