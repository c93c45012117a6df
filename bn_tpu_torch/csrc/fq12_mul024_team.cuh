// The sparse line multiply split over a team of 13 members, for
// kernel_fq12_mul024_pre.cu, kernel_fq12_mul024.cu and the second half of
// kernel_miller_step.cu (layouts: fq12_team.cuh; lanes: team.cuh).
//
// Member order.  tower.cuh's fq12_mul_by_024 (src/fields/fq12.rs:107-176)
// takes 13 independent Fq2 products of the coefficients z0..z5 of f, in
// memory order, and the line's x0, x2, x4.  Member w, 0 <= w < 13, computes
//   w  0: d0 = z0 x0     1: d2 = z2 x2     2: d4 = z4 x4
//      3: z1 x2          4: z5 x4          5: z1 x0
//      6: (z0+z2)(x0+x2) 7: z3 x4          8: (z2+z4)(x2+x4)
//      9: z3 x0         10: z5 x2         11: (z0+z4)(x0+x4)
//     12: (z1+z3+z5)(x0+x2+x4)
// into the scratch.  After the barrier, combine c, 0 <= c < 6, returns new
// coefficient z_c from the products p_w alone, xi taken once an output:
//   nz0 = xi(p3 + d4) + d0        nz3 = xi(p8 - d2 - d4) + p9
//   nz1 = xi(p4 + d2) + p5        nz4 = xi(p10) + p11 - d0 - d4
//   nz2 = p6 - d0 - d2 + p7       nz5 = p12 - (p3 + p4 + p5 + p7 + p9 + p10).
//
// Sources.  The member reads f through an Fq12 source (fq12_team.cuh) and
// the line's x0, x2, x4 through a line source, line.at(e, B)(i) for i = 0,
// 1, 2; the three kernels differ only there:
//   LineScaled   fq12_mul024_pre: ell0 (rows, 2, 16, B) and the scaled
//                (rows, 2, 2, 16, B), x0 = ell0, x2 = scaled[1] = ell_vv
//                g1.x, x4 = scaled[0] = ell_vw g1.y;
//   LineCoeffs   fq12_mul024: the precompute's unscaled (rows, 3, 2, 16, B)
//                struct (ell_0, ell_vw, ell_vv), x0 = slot 0, x2 = slot 2,
//                x4 = slot 1 (fq12_mul_by_line in tower.cuh);
//   the Miller step's, x2 and x4 from the block's shared memory
//                (miller_step_team.cuh).
#pragma once

#include "fq12_team.cuh"
#include "team.cuh"

#define BN_MUL024_MEMBERS 13  // Fq2 products of one sparse line multiply
#define BN_MUL024_BLOCK (BN_TEAM_LANES * BN_MUL024_MEMBERS)  // threads of a block: 13 warps
#ifndef BN_MUL024_MIN_BLOCKS
#define BN_MUL024_MIN_BLOCKS 2  // blocks a multiprocessor that __launch_bounds__ asks registers for
#endif

// Member w's operands as bit masks: bit k of (masks >> 3) names z_k, bits 0,
// 1, 2 of masks name x0, x2, x4.
BN_DEV int fq12_mul024_masks(int w) {
  switch (w) {
    case 0: return 0b000001 << 3 | 0b001;
    case 1: return 0b000100 << 3 | 0b010;
    case 2: return 0b010000 << 3 | 0b100;
    case 3: return 0b000010 << 3 | 0b010;
    case 4: return 0b100000 << 3 | 0b100;
    case 5: return 0b000010 << 3 | 0b001;
    case 6: return 0b000101 << 3 | 0b011;
    case 7: return 0b001000 << 3 | 0b100;
    case 8: return 0b010100 << 3 | 0b110;
    case 9: return 0b001000 << 3 | 0b001;
    case 10: return 0b100000 << 3 | 0b010;
    case 11: return 0b010001 << 3 | 0b101;
    default: return 0b101010 << 3 | 0b111;
  }
}

// Line sources, as the Fq12 sources: line.at(e, B)(i) is x0, x2 or x4
// (i = 0, 1, 2) of element e's line, its offsets taken once in at().
struct LineScaled {
  const int32_t* ell0;
  const int32_t* scaled;
  struct Element {
    const int32_t* x0;
    const int32_t* s;
    int64_t B;
    BN_DEV Fq2 operator()(int i) const {
      return i == 0 ? fq2_load(x0, B) : fq2_load(s + (i == 1 ? 2 * BN_NLIMB * B : 0), B);
    }
  };
  BN_DEV Element at(int64_t e, int64_t B) const {
    const int64_t row = e / B, b = e % B;
    return Element{ell0 + row * 2 * BN_NLIMB * B + b, scaled + row * 4 * BN_NLIMB * B + b, B};
  }
};

// Element e's (rows, 3, 2, 16, B) step coefficients (ell_0, ell_vw, ell_vv).
BN_DEV const int32_t* line_coeffs_at(const int32_t* coeff, int64_t e, int64_t B) {
  return coeff + (e / B) * 6 * BN_NLIMB * B + (e % B);
}

struct LineCoeffs {
  const int32_t* coeff;
  struct Element {
    const int32_t* p;
    int64_t B;
    BN_DEV Fq2 operator()(int i) const { return fq2_load(p + (int64_t)(i == 0 ? 0 : 3 - i) * 2 * BN_NLIMB * B, B); }
  };
  BN_DEV Element at(int64_t e, int64_t B) const { return Element{line_coeffs_at(coeff, e, B), B}; }
};

// Member w's two Fq2 operands: the sums its masks name, each term read by
// this thread for its own element (f and line: the element's views).
template <class FElement, class LineElement>
BN_DEV void fq12_mul024_operands(int w, const FElement& f, const LineElement& line, const Mod& m, Fq2& z, Fq2& x) {
  const int masks = fq12_mul024_masks(w);
  bool any = false;
  for (int k = 0; k < 6; k++)
    if (masks >> (3 + k) & 1) {
      const Fq2 v = f(k);
      z = any ? team_add(z, v, m) : v;
      any = true;
    }
  any = false;
  for (int i = 0; i < 3; i++)
    if (masks >> i & 1) {
      const Fq2 v = line(i);
      x = any ? team_add(x, v, m) : v;
      any = true;
    }
}

// The member as fq12_team_block calls it.
template <class FSrc, class LineSrc>
struct Fq12Mul024Member {
  FSrc f;
  LineSrc line;
  BN_DEV Fq2 operator()(int w, int64_t e, int64_t B, const Mod& m) const {
    Fq2 z, x;
    fq12_mul024_operands(w, f.at(e, B), line.at(e, B), m, z, x);
    return fq2_mul(z, x, m);
  }
};

template <class FSrc, class LineSrc>
BN_DEV Fq12Mul024Member<FSrc, LineSrc> fq12_mul024_member(const FSrc& f, const LineSrc& line) {
  return Fq12Mul024Member<FSrc, LineSrc>{f, line};
}

// New coefficient z_c from the 13 products in the scratch.
struct Fq12Mul024Combine {
  BN_DEV Fq2 operator()(int c, int64_t, int64_t, const uint32_t* prods, int stride, const Mod& m) const {
    const Fq2 d0 = fq2_tab_load(prods, stride, 0), d2 = fq2_tab_load(prods, stride, 1),
              d4 = fq2_tab_load(prods, stride, 2);
    if (c == 2)
      return team_add(team_sub(fq2_tab_load(prods, stride, 6), team_add(d0, d2, m), m), fq2_tab_load(prods, stride, 7), m);
    if (c == 5) {
      const Fq2 s = team_add(team_add(team_add(fq2_tab_load(prods, stride, 3), fq2_tab_load(prods, stride, 4), m),
                                      team_add(fq2_tab_load(prods, stride, 5), fq2_tab_load(prods, stride, 7), m), m),
                             team_add(fq2_tab_load(prods, stride, 9), fq2_tab_load(prods, stride, 10), m), m);
      return team_sub(fq2_tab_load(prods, stride, 12), s, m);
    }
    Fq2 x, y;  // out = xi(x) + y
    if (c == 0) {
      x = team_add(fq2_tab_load(prods, stride, 3), d4, m);
      y = d0;
    } else if (c == 1) {
      x = team_add(fq2_tab_load(prods, stride, 4), d2, m);
      y = fq2_tab_load(prods, stride, 5);
    } else if (c == 3) {
      x = team_sub(fq2_tab_load(prods, stride, 8), team_add(d2, d4, m), m);
      y = fq2_tab_load(prods, stride, 9);
    } else {
      x = fq2_tab_load(prods, stride, 10);
      y = team_sub(fq2_tab_load(prods, stride, 11), team_add(d0, d4, m), m);
    }
    return team_add(team_xi(x, m), y, m);
  }
};
