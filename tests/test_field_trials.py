"""Deep field property trials, batched TPU-style.

Mirrors the reference's generic `field_trials::<F>()` depth
(reference: src/fields/tests.rs:4-128, instantiated for Fr, Fq, Fq2, Fq6,
Fq12 at src/fields/mod.rs:52-81): the 10000-element sequential inversion
walk, 10000 random inversions + cancellations, associativity triples,
squaring and distributivity checks, and the 10-step add/neg random walks.
The reference iterates; here every trial population is one batch axis of
width 10000 and each property is ONE jitted device program (a single batch
width per field keeps the XLA:CPU compile surface small, and the jitted
programs land in the persistent compile cache so reruns are fast).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bn_tpu import oracle as O, params as P
from bn_tpu.fields import fp, tower

N = 10000  # the reference's trial width (src/fields/tests.rs:4-21, 91-98)


# ---------------------------------------------------------------------------
# per-field adapters: embed ints, random elements, device ops
# ---------------------------------------------------------------------------


class FqLike:
    def __init__(self, spec):
        self.spec = spec
        self.modulus = spec.modulus

    def embed(self, ints):
        return fp.to_device(self.spec, [i % self.modulus for i in ints])

    def random(self, rng, n):
        return self.embed([int.from_bytes(rng.bytes(40), "big") for _ in range(n)])

    def one(self, n):
        return fp.ones(self.spec, (n,))

    def zero(self, n):
        return fp.zeros(self.spec, (n,))

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


class TowerLike:
    """Fq2 / Fq6 / Fq12 adapter; ints embed into the c0...0 coefficient."""

    def __init__(self, degree):
        self.degree = degree  # 2, 6, or 12
        self.modulus = P.Q
        self._mul = {2: tower.fq2_mul, 6: tower.fq6_mul, 12: tower.fq12_mul}[degree]
        self._sq = {2: tower.fq2_sq, 6: tower.fq6_sq, 12: tower.fq12_sq}[degree]
        self._inv = {2: tower.fq2_inv, 6: tower.fq6_inv, 12: tower.fq12_inv}[degree]

    def _struct(self):
        return {2: (2,), 6: (3, 2), 12: (2, 3, 2)}[self.degree]

    def embed(self, ints):
        n = len(ints)
        coeffs = fp.to_device(fp.FQ, [i % P.Q for i in ints])
        out = fp.zeros(fp.FQ, self._struct() + (n,))
        idx = (0,) * len(self._struct())
        return out.at[idx].set(coeffs)

    def random(self, rng, n):
        struct = self._struct()
        ncoef = int(np.prod(struct))
        vals = [
            [int.from_bytes(rng.bytes(40), "big") % P.Q for _ in range(n)]
            for _ in range(ncoef)
        ]
        arr = np.stack([np.asarray(fp.to_device(fp.FQ, v)) for v in vals])
        return jnp.asarray(arr.reshape(struct + (P.NLIMBS, n)))

    def one(self, n):
        return {2: tower.ones2, 6: tower.ones6, 12: tower.ones12}[self.degree]((n,))

    def zero(self, n):
        return fp.zeros(fp.FQ, self._struct() + (n,))

    def add(self, a, b):
        return tower.add(a, b)

    def sub(self, a, b):
        return tower.sub(a, b)

    def neg(self, a):
        return tower.neg(a)

    def mul(self, a, b):
        return self._mul(a, b)

    def sq(self, a):
        return self._sq(a)

    def inv(self, a):
        return self._inv(a)


FIELDS = {
    "fr": FqLike(fp.FR),
    "fq": FqLike(fp.FQ),
    "fq2": TowerLike(2),
    "fq6": TowerLike(6),
    "fq12": TowerLike(12),
}


@functools.lru_cache(maxsize=None)
def _jitted(name):
    """One jitted program per property per field (persisted in the compile
    cache — this file is compile-bound on CPU, not compute-bound)."""
    F = FIELDS[name]

    def inv_suite(a, b):
        ai = F.inv(a)
        return F.mul(a, ai), F.mul(F.mul(a, b), ai)

    def assoc(a, b, c):
        return F.mul(F.mul(a, b), c), F.mul(a, F.mul(b, c))

    def squaring(a):
        return F.sq(a), F.mul(a, a)

    def distrib(a, b, c, d):
        lhs = F.mul(F.add(a, b), F.add(c, d))
        rhs = F.add(
            F.add(F.mul(a, c), F.mul(b, c)), F.add(F.mul(a, d), F.mul(b, d))
        )
        return lhs, rhs

    def walk(a, b, r0, rs):
        """One scanned step = the reference's 5-op round
        (src/fields/tests.rs:57-84); rs: (10, 5, elem...)."""
        b = F.add(b, r0)

        def step(carry, r):
            a, b = carry
            a, b = F.add(a, r[0]), F.add(b, r[0])
            a, b = F.sub(a, r[1]), F.sub(b, r[1])
            nn = F.neg(F.neg(r[2]))
            a, b = F.add(a, nn), F.add(b, nn)
            a, b = F.sub(a, r[3]), F.add(b, F.neg(r[3]))
            a, b = F.add(a, F.neg(r[4])), F.sub(b, r[4])
            return (a, b), None

        (a, b), _ = jax.lax.scan(step, (a, b), rs)
        return a, F.sub(b, r0)

    return {
        "inv_suite": jax.jit(inv_suite),
        "assoc": jax.jit(assoc),
        "squaring": jax.jit(squaring),
        "distrib": jax.jit(distrib),
        "walk": jax.jit(walk),
    }


def slow_at(*names):
    """FIELDS' names, those given marked slow: their programs compile for
    minutes on XLA:CPU."""
    return [pytest.param(n, marks=pytest.mark.slow) if n in names else n for n in FIELDS]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
@pytest.mark.parametrize("name", list(FIELDS))
def test_can_invert_10000_walk(name):
    """a * a^-1 == 1 for a = 1..10000 and a = -1..-10000
    (reference: src/fields/tests.rs:4-21), as two 10000-wide batches; the
    cancellation (a*b)*a^-1 == b rides along in the same program."""
    F = FIELDS[name]
    J = _jitted(name)
    up = F.embed(list(range(1, N + 1)))
    down = F.embed([-i for i in range(1, N + 1)])
    prod, cancel = J["inv_suite"](up, down)
    _eq(prod, F.one(N))
    _eq(cancel, down)
    prod, cancel = J["inv_suite"](down, up)
    _eq(prod, F.one(N))


@pytest.mark.slow
@pytest.mark.parametrize("name", list(FIELDS))
def test_zero_has_no_inverse_convention(name):
    """The reference returns None for 0^-1; the branchless device Fermat
    chain returns 0 (0^(p-2) = 0), the batch-safe encoding of 'no inverse'.
    Zero lanes embedded in a full-width batch (one shape per field)."""
    F = FIELDS[name]
    J = _jitted(name)
    a = F.embed([0] * N)
    prod, _ = J["inv_suite"](a, a)
    _eq(prod, F.zero(N))


@pytest.mark.slow
@pytest.mark.parametrize("name", list(FIELDS))
def test_rand_inverse_10000(name):
    """10000 random inversions + cancellation (a*b)*a^-1 == b
    (reference: src/fields/tests.rs:91-98)."""
    F = FIELDS[name]
    J = _jitted(name)
    rng = np.random.default_rng(103245)
    a = F.random(rng, N)
    b = F.random(rng, N)
    prod, cancel = J["inv_suite"](a, b)
    _eq(prod, F.one(N))
    _eq(cancel, b)


@pytest.mark.parametrize("name", slow_at("fq12"))
def test_rand_multiplication_associativity(name):
    """(a*b)*c == a*(b*c) over 10000 random triples (the reference runs 250,
    src/fields/tests.rs:100-111; batching makes more free)."""
    F = FIELDS[name]
    J = _jitted(name)
    rng = np.random.default_rng(191922)
    a, b, c = (F.random(rng, N) for _ in range(3))
    lhs, rhs = J["assoc"](a, b, c)
    _eq(lhs, rhs)


@pytest.mark.parametrize("name", slow_at("fq12"))
def test_rand_squaring(name):
    """a.squared() == a*a for random a and a 0..N sequential walk
    (reference: src/fields/tests.rs:37-50)."""
    F = FIELDS[name]
    J = _jitted(name)
    rng = np.random.default_rng(1293)
    a = F.random(rng, N)
    lhs, rhs = J["squaring"](a)
    _eq(lhs, rhs)
    w = F.embed(list(range(N)))
    lhs, rhs = J["squaring"](w)
    _eq(lhs, rhs)


@pytest.mark.parametrize("name", slow_at("fq12"))
def test_rand_distributivity(name):
    """(a+b)*(c+d) == ac+bc+ad+bd over 10000 random tuples
    (reference: src/fields/tests.rs:23-35 runs 100)."""
    F = FIELDS[name]
    J = _jitted(name)
    rng = np.random.default_rng(192103)
    a, b, c, d = (F.random(rng, N) for _ in range(4))
    lhs, rhs = J["distrib"](a, b, c, d)
    _eq(lhs, rhs)


@pytest.mark.parametrize("name", slow_at("fq12"))
def test_add_neg_random_walks(name):
    """The 10-step add/neg do/undo trial (reference: src/fields/tests.rs:
    52-89): two accumulators that differ by a fixed r stay in lockstep
    through 10 rounds of mixed add/sub/neg ops — all walks batched (the
    reference runs 100 walks; this runs 10000) and the rounds scanned."""
    F = FIELDS[name]
    J = _jitted(name)
    rng = np.random.default_rng(424242)
    a = F.random(rng, N)
    r0 = F.random(rng, N)
    rs = jnp.stack(
        [jnp.stack([F.random(rng, N) for _ in range(5)]) for _ in range(10)]
    )
    a_out, b_out = J["walk"](a, a, r0, rs)
    _eq(a_out, b_out)


def test_neg_cancels():
    """a + (-a) == 0 across all five fields (one width per field)."""
    rng = np.random.default_rng(7)
    for name, F in FIELDS.items():
        a = F.random(rng, N)
        _eq(F.add(a, F.neg(a)), F.zero(N))


@pytest.mark.slow
def test_inverse_matches_oracle_spot():
    """A device inverse value agrees with the exact host oracle on sampled
    lanes (ties the batched trials back to Python-int ground truth):
    inv(a) recovered as (a*b)*inv(a) with b = inv_oracle(a)*a*b'... kept
    simple — check a*inv(a) == 1 AND the oracle's inverse reproduces the
    device cancellation for a known value."""
    F = FIELDS["fq2"]
    av, bv = (12345, 67), (98765, 4321)
    n = N
    a = jnp.asarray(
        np.broadcast_to(np.asarray(tower.fq2_to_device([av])), (2, P.NLIMBS, n))
    )
    b = jnp.asarray(
        np.broadcast_to(np.asarray(tower.fq2_to_device([bv])), (2, P.NLIMBS, n))
    )
    prod, cancel = _jitted("fq2")["inv_suite"](a, b)
    assert tower.fq2_from_device(prod[..., :1])[0] == (1, 0)
    got = tower.fq2_from_device(cancel[..., :1])[0]
    expect = O.fq2_mul(O.fq2_mul(av, bv), O.fq2_inv(av))
    assert got == expect == bv
