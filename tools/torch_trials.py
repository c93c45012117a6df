#!/usr/bin/env python3
"""The reference's deep field and group property trials, run on bn_tpu_torch.

tests/test_field_trials.py and tests/test_group_trials.py hold the JAX
package to the reference crate's field_trials::<F>() (src/fields/tests.rs,
for Fr, Fq, Fq2, Fq6 and Fq12) and group_trials::<G>() (src/groups/tests.rs,
for G1 and G2), each trial's population one batch axis.  This module runs the
same properties on the port, with the same seeds and the same draws (a value
is int.from_bytes(rng.bytes(40), "big") reduced mod the modulus, in the
order the tests draw them): through fields/fp.py and fields/tower.py for the
fields (fq6_sq among them), through curve.add, double, neg, mul, eq and
is_zero for the groups.  Each trial is a function of (field or group,
device, n, seed), seed defaulting to the test's, and returns a Result: its
name, the lanes it checked and the lanes that failed.  On top of the
reference's trials, one product a field and one point a group are held
against the pure-Python oracle at lanes 0, n // 2 and n - 1.

A random element goes to the device as bytes: its 40-byte value v is split
into the low 240 bits and the rest, and Montgomery products by R^2 and by
2^240 R^2 and one sum give v R mod m, so that 10,000-lane Fq12 draws cost no
Python integer work.  The oracle's inputs are read from the same bytes.

    python3 tools/torch_trials.py [--n 10000] [--device cuda] [--only fq2 g1 ...]

prints one JSON line a trial (its seconds on the host clock around a
synchronise) and exits 1 if any lane failed.  Imports torch, numpy and the
port only.
"""

from __future__ import annotations

import argparse
import functools
import json
import pathlib
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from bn_tpu_torch import curve  # noqa: E402
from bn_tpu_torch import oracle as O  # noqa: E402
from bn_tpu_torch import params as P  # noqa: E402
from bn_tpu_torch.fields import fp, tower  # noqa: E402
from bn_tpu_torch.ops import limbs as lb  # noqa: E402
from bn_tpu_torch.ops import mont_cuda as mc  # noqa: E402

N = 10000  # the reference's field trial width (src/fields/tests.rs:4-21, 91-98)
DRAW_BYTES = 40  # bytes of one random value, as the tests draw it
LOW_BITS = 240  # a value's low part: below both moduli


class Result(NamedTuple):
    name: str  # "<field or group>.<trial>"
    lanes: int  # lanes checked
    failed: list  # lanes that failed, ascending


def sample_lanes(n: int) -> list:
    return sorted({0, n // 2, n - 1})


def _trial(fn):
    """A trial body returns (lanes checked, lanes failed); the trial returns
    them as a Result named after its field or group and itself."""

    @functools.wraps(fn)
    def trial(x, device, n=N, **seed):
        lanes, failed = fn(x, device, n, **seed)
        return Result(f"{x.name}.{fn.__name__}", lanes, failed)

    return trial


def _failed(*masks) -> list:
    """Lanes where any of the (n,) bool masks is false."""
    ok = masks[0]
    for m in masks[1:]:
        ok = ok & m
    return torch.nonzero(~ok).flatten().tolist()


def _same(x, y):
    """(n,) mask: lanes where the limb tensors x and y are equal."""
    n = x.shape[-1]
    return (x == y).reshape(-1, n).all(dim=0)


def _values(buf: bytes, modulus: int, idx) -> list:
    """Values idx of the draw buf, as the tests reduce them."""
    return [int.from_bytes(buf[DRAW_BYTES * j : DRAW_BYTES * (j + 1)], "big") % modulus for j in idx]


def _montgomery(buf: bytes, modulus: int, device):
    """The values of the draw buf in Montgomery form: (16, count) limbs on
    device.  v = lo + hi 2^240 with lo < 2^240 and hi < 2^80, both below m;
    mont(lo, R^2) + mont(hi, 2^240 R^2) = v R mod m."""
    digits = np.frombuffer(buf, dtype=">u2").reshape(-1, DRAW_BYTES // 2)[:, ::-1]  # least significant first
    low = LOW_BITS // P.LIMB_BITS
    parts = np.zeros((2, P.NLIMBS, digits.shape[0]), dtype=np.int32)
    parts[0, :low] = digits[:, :low].T
    parts[1, : digits.shape[1] - low] = digits[:, low:].T
    r2 = pow(2, 2 * P.NLIMBS * P.LIMB_BITS, modulus)
    k = torch.stack([lb.const(P.int_to_limbs(c), device) for c in (r2, (r2 << LOW_BITS) % modulus)])
    prod = mc.mont_mul(torch.from_numpy(parts).to(device), k, modulus)
    return mc.mod_add(prod[0], prod[1], modulus)


# ---------------------------------------------------------------------------
# the fields
# ---------------------------------------------------------------------------


class BaseField:
    """Fr or Fq."""

    struct = ()
    ncoef = 1

    def __init__(self, name: str, spec):
        self.name = name
        self.spec = spec
        self.modulus = spec.modulus

    def embed(self, ints, device):
        return fp.to_device(self.spec, ints, device)

    def element(self, buf: bytes, n: int, device):
        return _montgomery(buf, self.modulus, device)

    def random(self, rng, n: int, device):
        return self.element(rng.bytes(DRAW_BYTES * self.ncoef * n), n, device)

    def one(self, n, device):
        return fp.ones(self.spec, (n,), device)

    def zero(self, n, device):
        return fp.zeros(self.spec, self.struct + (n,), device)

    def add(self, a, b):
        return fp.add(self.spec, a, b)

    def sub(self, a, b):
        return fp.sub(self.spec, a, b)

    def neg(self, a):
        return fp.neg(self.spec, a)

    def mul(self, a, b):
        return fp.mul(self.spec, a, b)

    def sq(self, a):
        return fp.sqr(self.spec, a)

    def inv(self, a):
        return fp.inv(self.spec, a)

    def host(self, buf: bytes, n: int, lane: int):
        """The oracle's value of lane `lane` of element(buf, n)."""
        return _values(buf, self.modulus, [lane])[0]

    def oracle_mul(self, x, y):
        return x * y % self.modulus

    def to_device(self, vals, device):
        return fp.to_device(self.spec, vals, device)


class TowerField(BaseField):
    """Fq2, Fq6 or Fq12 (sums as BaseField's over Fq, coefficient by
    coefficient); an int embeds into the c0...0 coefficient."""

    def __init__(self, degree: int):
        super().__init__(f"fq{degree}", fp.FQ)
        self.degree = degree
        self.struct = {2: (2,), 6: (3, 2), 12: (2, 3, 2)}[degree]
        self.ncoef = degree
        self._mul = {2: tower.fq2_mul, 6: tower.fq6_mul, 12: tower.fq12_mul}[degree]
        self._sq = {2: tower.fq2_sq, 6: tower.fq6_sq, 12: tower.fq12_sq}[degree]
        self._inv = {2: tower.fq2_inv, 6: tower.fq6_inv, 12: tower.fq12_inv}[degree]
        self._one = {2: tower.ones2, 6: tower.ones6, 12: tower.ones12}[degree]
        self._oracle_mul = {2: O.fq2_mul, 6: O.fq6_mul, 12: O.fq12_mul}[degree]
        self._to_device = {2: tower.fq2_to_device, 6: tower.fq6_to_device, 12: tower.fq12_to_device}[degree]

    def embed(self, ints, device):
        out = self.zero(len(ints), device)
        out[(0,) * len(self.struct)] = fp.to_device(fp.FQ, ints, device)
        return out

    def element(self, buf: bytes, n: int, device):
        """The draw's values coefficient-major, as the tests lay them out:
        value c n + b is coefficient c (flattened struct) of lane b."""
        x = _montgomery(buf, self.modulus, device)
        return x.reshape(P.NLIMBS, self.ncoef, n).transpose(0, 1).reshape(self.struct + (P.NLIMBS, n))

    def one(self, n, device):
        return self._one((n,), device)

    def mul(self, a, b):
        return self._mul(a, b)

    def sq(self, a):
        return self._sq(a)

    def inv(self, a):
        return self._inv(a)

    def host(self, buf: bytes, n: int, lane: int):
        c = _values(buf, self.modulus, [k * n + lane for k in range(self.ncoef)])
        fq2s = [tuple(c[i : i + 2]) for i in range(0, self.ncoef, 2)]
        if self.degree == 2:
            return fq2s[0]
        fq6s = [tuple(fq2s[i : i + 3]) for i in range(0, len(fq2s), 3)]
        return fq6s[0] if self.degree == 6 else tuple(fq6s)

    def oracle_mul(self, x, y):
        return self._oracle_mul(x, y)

    def to_device(self, vals, device):
        return self._to_device(vals, device)


FIELDS = {F.name: F for F in (BaseField("fr", fp.FR), BaseField("fq", fp.FQ), TowerField(2), TowerField(6), TowerField(12))}


def _inv_suite(F, a, b):
    """(a a^-1, (a b) a^-1)."""
    ai = F.inv(a)
    return F.mul(a, ai), F.mul(F.mul(a, b), ai)


@_trial
def invert_walk(F, device, n=N, seed=None):
    """a a^-1 = 1 for a = 1..n and a = -1..-n, and (a b) a^-1 = b
    (src/fields/tests.rs:4-21)."""
    up = F.embed(list(range(1, n + 1)), device)
    down = F.embed([-i for i in range(1, n + 1)], device)
    one = F.one(n, device)
    prod, cancel = _inv_suite(F, up, down)
    prod_down, _ = _inv_suite(F, down, up)
    return n, _failed(_same(prod, one), _same(cancel, down), _same(prod_down, one))


@_trial
def zero_inverse(F, device, n=N, seed=None):
    """0^-1 = 0, the batch-safe encoding of the reference's None."""
    a = F.embed([0] * n, device)
    prod, _ = _inv_suite(F, a, a)
    return n, _failed(_same(prod, F.zero(n, device)))


@_trial
def rand_inverse(F, device, n=N, seed=103245):
    """n random inversions and cancellations (src/fields/tests.rs:91-98)."""
    rng = np.random.default_rng(seed)
    a, b = F.random(rng, n, device), F.random(rng, n, device)
    prod, cancel = _inv_suite(F, a, b)
    return n, _failed(_same(prod, F.one(n, device)), _same(cancel, b))


@_trial
def associativity(F, device, n=N, seed=191922):
    """(a b) c = a (b c) (src/fields/tests.rs:100-111)."""
    rng = np.random.default_rng(seed)
    a, b, c = (F.random(rng, n, device) for _ in range(3))
    return n, _failed(_same(F.mul(F.mul(a, b), c), F.mul(a, F.mul(b, c))))


@_trial
def squaring(F, device, n=N, seed=1293):
    """a^2 = a a for random a and for a = 0..n-1 (src/fields/tests.rs:37-50)."""
    a = F.random(np.random.default_rng(seed), n, device)
    w = F.embed(list(range(n)), device)
    return n, _failed(_same(F.sq(a), F.mul(a, a)), _same(F.sq(w), F.mul(w, w)))


@_trial
def distributivity(F, device, n=N, seed=192103):
    """(a + b)(c + d) = ac + bc + ad + bd (src/fields/tests.rs:23-35)."""
    rng = np.random.default_rng(seed)
    a, b, c, d = (F.random(rng, n, device) for _ in range(4))
    lhs = F.mul(F.add(a, b), F.add(c, d))
    rhs = F.add(F.add(F.mul(a, c), F.mul(b, c)), F.add(F.mul(a, d), F.mul(b, d)))
    return n, _failed(_same(lhs, rhs))


@_trial
def add_neg_walk(F, device, n=N, seed=424242):
    """Two accumulators that differ by r0 stay in step through 10 rounds of
    mixed add / sub / neg (src/fields/tests.rs:52-89)."""
    rng = np.random.default_rng(seed)
    a = F.random(rng, n, device)
    r0 = F.random(rng, n, device)
    rs = [[F.random(rng, n, device) for _ in range(5)] for _ in range(10)]
    b = F.add(a, r0)
    for r in rs:
        a, b = F.add(a, r[0]), F.add(b, r[0])
        a, b = F.sub(a, r[1]), F.sub(b, r[1])
        nn = F.neg(F.neg(r[2]))
        a, b = F.add(a, nn), F.add(b, nn)
        a, b = F.sub(a, r[3]), F.add(b, F.neg(r[3]))
        a, b = F.add(a, F.neg(r[4])), F.sub(b, r[4])
    return n, _failed(_same(a, F.sub(b, r0)))


@_trial
def neg_cancels(F, device, n=N, seed=7):
    """a + (-a) = 0.  The test draws for all five fields from one generator in
    FIELDS' order: the draws of the fields before this one are skipped."""
    rng = np.random.default_rng(seed)
    for G in FIELDS.values():
        if G is F:
            break
        rng.bytes(DRAW_BYTES * G.ncoef * n)
    a = F.random(rng, n, device)
    return n, _failed(_same(F.add(a, F.neg(a)), F.zero(n, device)))


@_trial
def inverse_spot(F, device, n=N, seed=None):
    """Fq2 only: a = 12345 + 67u and b = 98765 + 4321u on every lane,
    a a^-1 = 1 and (a b) a^-1 = b, which the oracle reproduces."""
    av, bv = (12345, 67), (98765, 4321)
    a = tower.fq2_to_device([av], device).expand(2, P.NLIMBS, n).contiguous()
    b = tower.fq2_to_device([bv], device).expand(2, P.NLIMBS, n).contiguous()
    prod, cancel = _inv_suite(F, a, b)
    ok = O.fq2_mul(O.fq2_mul(av, bv), O.fq2_inv(av)) == bv
    return n, _failed(_same(prod, F.one(n, device)), _same(cancel, b)) + ([] if ok else [0])


@_trial
def oracle_product(F, device, n=N, seed=191922):
    """a b against the oracle at lanes 0, n // 2 and n - 1, on the first two
    draws of the associativity trial."""
    rng = np.random.default_rng(seed)
    bufs = [rng.bytes(DRAW_BYTES * F.ncoef * n) for _ in range(2)]
    got = F.mul(F.element(bufs[0], n, device), F.element(bufs[1], n, device))
    lanes = sample_lanes(n)
    want = F.to_device([F.oracle_mul(F.host(bufs[0], n, b), F.host(bufs[1], n, b)) for b in lanes], device)
    return len(lanes), [b for k, b in enumerate(lanes) if not torch.equal(got[..., b], want[..., k])]


FIELD_TRIALS = (invert_walk, zero_inverse, rand_inverse, associativity, squaring, distributivity,
                add_neg_walk, neg_cancels, oracle_product)
FIELD_ONLY = {"fq2": (inverse_spot,)}


# ---------------------------------------------------------------------------
# the groups
# ---------------------------------------------------------------------------


class Group(NamedTuple):
    name: str
    spec: curve.CurveSpec
    ops: O.FieldOps  # the oracle's coordinate field
    gen: tuple  # the oracle's generator


GROUPS = {G.name: G for G in (Group("g1", curve.g1_spec(), O.FQ_OPS, O.G1_ONE),
                               Group("g2", curve.g2_spec(), O.FQ2_OPS, O.G2_ONE))}
INV2 = pow(2, P.R_SCALAR - 2, P.R_SCALAR)


def scalars(rng, n: int) -> list:
    """n scalars mod r, drawn as the group trials draw them."""
    return _values(rng.bytes(DRAW_BYTES * n), P.R_SCALAR, range(n))


def _fr(ints, device):
    return fp.to_device(fp.FR, ints, device)


def times(G, p, k, device):
    """The points p times the host scalars k, lane by lane: one ladder.  (A
    CPU test may put the oracle's products in its place, to keep ladders off
    the CPU.)"""
    return curve.mul(G.spec, p, _fr(k, device))


def _points(G, rng, n, device):
    """n random points, as the tests draw them: the generator times random
    scalars."""
    return times(G, curve.one(G.spec, (n,), device), scalars(rng, n), device)


@_trial
def addition(G, device, n=N, seed=103245):
    """(r1 + r2) + r3 = r1 + (r2 + r3), and undone by -r2, -r3, -r1 to
    infinity (src/groups/tests.rs:5-14)."""
    s = G.spec
    rng = np.random.default_rng(seed)
    r1, r2, r3 = (_points(G, rng, n, device) for _ in range(3))
    lhs = curve.add(s, curve.add(s, r1, r2), r3)
    rhs = curve.add(s, r1, curve.add(s, r2, r3))
    undone = curve.add(s, curve.add(s, curve.add(s, lhs, curve.neg(s, r2)), curve.neg(s, r3)), curve.neg(s, r1))
    return n, _failed(curve.eq(s, lhs, rhs), curve.is_zero(s, undone))


@_trial
def doubling(G, device, n=N, seed=191922):
    """(r1 + r2) + r1 = 2 r1 + r2, and 2 r1 times 2^-1 mod r is r1
    (src/groups/tests.rs:16-25)."""
    s = G.spec
    rng = np.random.default_rng(seed)
    r1, r2 = _points(G, rng, n, device), _points(G, rng, n, device)
    lhs = curve.add(s, curve.add(s, r1, r2), r1)
    rhs = curve.add(s, curve.double(s, r1), r2)
    back = times(G, curve.double(s, r1), [INV2] * n, device)
    return n, _failed(curve.eq(s, lhs, rhs), curve.eq(s, back, r1))


@_trial
def dh(G, device, n=N, seed=1293):
    """Diffie-Hellman agreement over n key pairs (src/groups/tests.rs:27-40)."""
    s = G.spec
    rng = np.random.default_rng(seed)
    a_sk, b_sk = scalars(rng, n), scalars(rng, n)
    g = curve.one(s, (n,), device)
    a_pk, b_pk = times(G, g, a_sk, device), times(G, g, b_sk, device)
    return n, _failed(curve.eq(s, times(G, b_pk, a_sk, device), times(G, a_pk, b_sk, device)))


@_trial
def do_undo_walk(G, device, n=N, seed=192103):
    """10 rounds of {* a, neg, + b, * c, neg, - d, double}, then the inverse
    sequence back to the start (src/groups/tests.rs:42-83); the scalar
    inverses are host integers."""
    s = G.spec
    rng = np.random.default_rng(seed)
    begin = _points(G, rng, n, device)
    a_int, c_int = scalars(rng, n), scalars(rng, n)
    b, d = _points(G, rng, n, device), _points(G, rng, n, device)
    a, c = _fr(a_int, device), _fr(c_int, device)
    ai = _fr([pow(x, P.R_SCALAR - 2, P.R_SCALAR) for x in a_int], device)
    ci = _fr([pow(x, P.R_SCALAR - 2, P.R_SCALAR) for x in c_int], device)
    ti = _fr([INV2] * n, device)
    acc = begin  # the walk's scalars go to the device once: curve.mul, not times()
    for _ in range(10):
        acc = curve.neg(s, curve.mul(s, acc, a))
        acc = curve.neg(s, curve.mul(s, curve.add(s, acc, b), c))
        acc = curve.double(s, curve.add(s, acc, curve.neg(s, d)))
    for _ in range(10):
        acc = curve.neg(s, curve.add(s, curve.mul(s, acc, ti), d))
        acc = curve.neg(s, curve.add(s, curve.mul(s, acc, ci), curve.neg(s, b)))
        acc = curve.mul(s, acc, ai)
    return n, _failed(curve.eq(s, acc, begin))


@_trial
def oracle_points(G, device, n=N, seed=7):
    """(k G) a against the oracle at lanes 0, n // 2 and n - 1 (the spot
    check of tests/test_group_trials.py, on a whole batch)."""
    s = G.spec
    rng = np.random.default_rng(seed)
    k, a = scalars(rng, n), scalars(rng, n)
    got = times(G, times(G, curve.one(s, (n,), device), k, device), a, device)
    lanes = sample_lanes(n)
    host = curve.from_device(s, tuple(t[..., lanes] for t in got))
    want = [O.g_mul(G.ops, O.g_mul(G.ops, G.gen, k[b]), a[b]) for b in lanes]
    return len(lanes), [b for b, x, y in zip(lanes, host, want) if not O.g_eq(G.ops, x, y)]


GROUP_TRIALS = (addition, doubling, dh, do_undo_walk, oracle_points)


# ---------------------------------------------------------------------------
# running them
# ---------------------------------------------------------------------------


def trials(only=None) -> list:
    """Every trial as (trial, field or group), the fields' then the groups',
    of those named in `only` if given."""
    out = [(t, F) for F in FIELDS.values() for t in FIELD_TRIALS + FIELD_ONLY.get(F.name, ())]
    out += [(t, G) for G in GROUPS.values() for t in GROUP_TRIALS]
    return [(t, x) for t, x in out if only is None or x.name in only]


def timed(trial, x, device, n) -> tuple:
    """(Result, seconds on the host clock, the device's work included)."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    res = trial(x, device, n)
    sync()
    return res, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", nargs="*", choices=list(FIELDS) + list(GROUPS))
    args = ap.parse_args(argv)
    bad = 0
    for trial, x in trials(args.only):
        res, sec = timed(trial, x, args.device, args.n)
        bad += bool(res.failed)
        print(json.dumps({"trial": res.name, "lanes": res.lanes, "failed": res.failed[:20],
                          "n_failed": len(res.failed), "seconds": sec}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
