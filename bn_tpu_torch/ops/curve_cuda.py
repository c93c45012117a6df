"""Whole Jacobian additions and doublings of G1 and G2: CUDA kernels with their
plain versions.

Counterpart of the JAX package's ops/curve_pallas.py.  Two functions —
point_add, point_double — each with a wrapper that sends CPU tensors to the
plain version and CUDA tensors to its kernel (csrc/kernels_curve.cu), and
`<name>_plain`, the same function in plain PyTorch.  Each kernel has two
designs, a team of warps on 32 elements and one thread a point; the wrapper
picks one by the number of lanes (`design_for`).  A point is a tuple
(x, y, z) of coordinate tensors, (..., 16, B) int32 for G1 and (..., 2, 16, B)
for G2, batch last; the coordinates stay separate tensors all the way into
the kernel (nothing is stacked around a call).

The two formulas are written once, on a field namespace F (`jac_double`,
`jac_add`): bound to the plain limb engine they are the plain versions, bound
to the views of curve.py (one kernel per field operation) they are the
per-field-op group law the kernels are held against.

The wrappers allocate their results, so a result is never one of the
operands: `acc = point_add(name, acc, g)` leaves the old `acc` untouched.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from .. import params as P
from . import limbs as lb
from .mont_cuda import _m_limbs, _on_card, broadcast, fq2_mul_plain, fq2_sq_plain, launch

STRUCTS = {"G1": (), "G2": (2,)}

# The designs of the curve kernels, by the C entries' design argument: one
# thread a point (0), the team of csrc/curve_team.cuh (1).
DESIGNS = ("thread", "team")
# Lanes (rows * B) from which a call of each kernel goes to the one-thread
# design, for G1 and G2; below, to the team.  tools/torch_kernel_variants.py
# times both designs in turns from 1 to 2^20 lanes on an H100 (PERF.md): the
# team wins from a batch of one (the MSM's Horner doublings) to 8448 lanes,
# one wave of its blocks (132 multiprocessors, two blocks of 32 lanes each),
# curve.mul's 8192 among them.  Past that wave the doubling loses; the
# addition wins up to 12,288 and loses from 2^14 on, the MSM's 2^20 included.
THREAD_FROM_LANES = {"point_add": 1 << 14, "point_double": 132 * 2 * 32 + 1}


# ---------------------------------------------------------------------------
# masks and selects over Fq2 coordinates (..., 2, 16, B); masks are (..., B)
# ---------------------------------------------------------------------------


def fq2_is_zero(a):
    return torch.all(a == 0, dim=-2).all(dim=-2)


def fq2_eq(a, b):
    return torch.all(a == b, dim=-2).all(dim=-2)


def fq2_select(mask, a, b):
    return torch.where(mask[..., None, None, :], a, b)


# ---------------------------------------------------------------------------
# the formulas, on a field namespace F with add, sub, mul, sq, mul_many,
# is_zero, eq, select
# ---------------------------------------------------------------------------


def _mul_small(F, a, k: int):
    """k * a for a small k >= 1 by double-and-add on F.add."""
    res = a
    for bit in P.bits_msb_first(k)[1:]:
        res = F.add(res, res)
        if bit:
            res = F.add(res, a)
    return res


def jac_double(F, p):
    """dbl-2009-l (src/groups/mod.rs:228-247).  Safe at infinity (z3 = 2yz = 0
    keeps the point at infinity)."""
    x, y, z = p
    a, b, yz = F.mul_many([(x, x), (y, y), (y, z)])
    xb = F.add(x, b)
    c, xb2 = F.mul_many([(b, b), (xb, xb)])
    d = F.sub(F.sub(xb2, a), c)
    d = F.add(d, d)
    e = _mul_small(F, a, 3)
    f = F.sq(e)
    x3 = F.sub(f, F.add(d, d))
    eight_c = _mul_small(F, c, 8)
    ed = F.mul(e, F.sub(d, x3))
    return (x3, F.sub(ed, eight_c), F.add(yz, yz))


def jac_add(F, p, q):
    """2007-bl Jacobian add with branchless degenerate handling
    (src/groups/mod.rs:272-312)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    p_inf = F.is_zero(z1)
    q_inf = F.is_zero(z2)

    z1s, z2s = F.mul_many([(z1, z1), (z2, z2)])
    u1, u2, z1c, z2c = F.mul_many([(x1, z2s), (x2, z1s), (z1, z1s), (z2, z2s)])
    s1, s2 = F.mul_many([(y1, z2c), (y2, z1c)])

    do_double = F.eq(u1, u2) & F.eq(s1, s2)

    h = F.sub(u2, u1)
    ss = F.sub(s2, s1)
    hh = F.add(h, h)
    i = F.sq(hh)
    j, v = F.mul_many([(h, i), (u1, i)])
    r = F.add(ss, ss)
    z12 = F.add(z1, z2)
    s1j, rsq, zz = F.mul_many([(s1, j), (r, r), (z12, z12)])
    x3 = F.sub(F.sub(rsq, j), F.add(v, v))
    rv = F.mul(r, F.sub(v, x3))
    y3 = F.sub(rv, F.add(s1j, s1j))
    z3 = F.mul(F.sub(F.sub(zz, z1s), z2s), h)
    # NB when same x and different y (p = -q): h = 0 -> z3 = 0, the point at
    # infinity, automatically correct.

    dx, dy, dz = jac_double(F, p)
    x3 = F.select(do_double, dx, x3)
    y3 = F.select(do_double, dy, y3)
    z3 = F.select(do_double, dz, z3)

    # infinity passthrough: after the doubling's select, so that infinity +
    # infinity (where every u and s is 0 and do_double holds) returns p as
    # it came
    x3 = F.select(q_inf, x1, F.select(p_inf, x2, x3))
    y3 = F.select(q_inf, y1, F.select(p_inf, y2, y3))
    z3 = F.select(q_inf, z1, F.select(p_inf, z2, z3))
    return (x3, y3, z3)


# ---------------------------------------------------------------------------
# the plain field namespaces
# ---------------------------------------------------------------------------


class PlainFq:
    """Fq coordinates (..., 16, B) on the plain limb engine."""

    def __init__(self, modulus: int):
        m = _m_limbs(modulus)
        self.add = lambda a, b: lb.mod_add(a, b, m)
        self.sub = lambda a, b: lb.mod_sub(a, b, m)
        self.mul = lambda a, b: lb.mont_mul(a, b, m)
        self.sq = lambda a: lb.mont_mul(a, a, m)
        self.is_zero, self.eq, self.select = lb.is_zero, lb.eq, lb.select

    def mul_many(self, pairs):
        """Independent products of one shape in one Montgomery product."""
        return list(self.mul(torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])))


class PlainFq2(PlainFq):
    """Fq2 coordinates (..., 2, 16, B): sums are coefficient-wise, products go
    through the plain Fq2 product and square."""

    def __init__(self, modulus: int):
        super().__init__(modulus)
        self.mul = lambda a, b: fq2_mul_plain(a, b, modulus)
        self.sq = lambda a: fq2_sq_plain(a, modulus)
        self.is_zero, self.eq, self.select = fq2_is_zero, fq2_eq, fq2_select


@functools.lru_cache(maxsize=None)
def _plain_field(spec_name: str):
    return PlainFq(P.Q) if STRUCTS[spec_name] == () else PlainFq2(P.Q)


# ---------------------------------------------------------------------------
# point_double, point_add
# ---------------------------------------------------------------------------


def _coords(spec_name: str, *points):
    """The coordinates of `points` as one flat tuple, brought to one shape."""
    if spec_name not in STRUCTS:
        raise ValueError(f"unknown group {spec_name!r}: the groups are {tuple(STRUCTS)}")
    return broadcast(*(t for pt in points for t in pt))


def design_for(name: str, lanes: int) -> str:
    """The design a call of kernel `name` on `lanes` points (rows * B) of
    either group launches: the shape decides, nothing else (`forced_design`
    aside)."""
    return "thread" if lanes >= THREAD_FROM_LANES[name] else "team"


@contextlib.contextmanager
def forced_design(design: str):
    """Every curve launch in the block of `design`, whatever its width: the
    hook of the checks and tools that hold or time one design at any width
    (chip_smoke.py, tools/torch_kernel_variants.py)."""
    global design_for
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}: the designs are {DESIGNS}")
    rule = design_for
    design_for = lambda name, lanes: design  # noqa: E731
    try:
        yield
    finally:
        design_for = rule


def _launch(name: str, spec_name: str, coords):
    st = STRUCTS[spec_name]
    design = design_for(name, coords[0].numel() // (P.NLIMBS * (len(st) + 1)))
    return launch(name, coords, (st,) * len(coords), P.Q, extra=(len(st), DESIGNS.index(design)),
                  out_structs=(st,) * 3, instance=design)


def point_double_plain(spec_name: str, p):
    return jac_double(_plain_field(spec_name), _coords(spec_name, p))


def point_double(spec_name: str, p):
    """2p for a batch of Jacobian points of G1 or G2 (`spec_name`); one launch,
    of the design design_for picks."""
    coords = _coords(spec_name, p)
    if not _on_card(*coords):
        return jac_double(_plain_field(spec_name), coords)
    return _launch("point_double", spec_name, coords)


def point_add_plain(spec_name: str, p, q):
    coords = _coords(spec_name, p, q)
    return jac_add(_plain_field(spec_name), coords[:3], coords[3:])


def point_add(spec_name: str, p, q):
    """p + q for batches of Jacobian points of G1 or G2, with every degenerate
    case (an infinite operand, p = q, p = -q); one launch, of the design
    design_for picks."""
    coords = _coords(spec_name, p, q)
    if not _on_card(*coords):
        return jac_add(_plain_field(spec_name), coords[:3], coords[3:])
    return _launch("point_add", spec_name, coords)
