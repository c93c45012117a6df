"""The port's public API, wire format and host codec on the CPU: the ports of
tests/test_api.py, tests/test_serialization.py and tests/test_native.py, and
the slice as a whole against the JAX package.

Everything runs on `device="cpu"`, where each group operation is the plain
version of its kernel.  A 256-step ladder costs seconds there, so the objects
the tests share (random points, the pairing's operands, the decoded batches)
are module fixtures and each is computed once.  Against the JAX package:
`G1.random(3, 2)`, `G2.random(4, 2)`, `Fr.random(5, 3)` must give the same
bytes, `pairing(p, q).pow(s)` with the scalars 777, 888, 12345 the same Gt
element, and every encoder the same bytes on the same oracle points.
Tolerance: none.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bn_tpu
from bn_tpu import serialization as JS
from bn_tpu_torch import Fr, G1, G2, Gt, convert, pairing
from bn_tpu_torch import oracle as O
from bn_tpu_torch import params as P
from bn_tpu_torch import serialization as S
from bn_tpu_torch.ops import build
from bn_tpu_torch.utils import native

torch.set_num_threads(1)  # tiny tensors: threads only add overhead

CPU = "cpu"


def _lanes(obj, lo, hi):
    """Lanes lo..hi-1 of a group or Gt object as an object of its class."""
    if isinstance(obj.dev, tuple):
        return type(obj)(tuple(t[..., lo:hi] for t in obj.dev))
    return type(obj)(obj.dev[..., lo:hi])


def _cat(*objs):
    return type(objs[0])(tuple(torch.cat(ts, dim=-1) for ts in zip(*(o.dev for o in objs))))


# ---------------------------------------------------------------------------
# Fr
# ---------------------------------------------------------------------------


def test_fr_ops():
    a = Fr.from_ints([3, 5], CPU)
    b = Fr.from_ints([10, P.R_SCALAR - 1], CPU)
    assert (a + b).to_ints() == [13, 4]
    assert (a * b).to_ints() == [30, (5 * (P.R_SCALAR - 1)) % P.R_SCALAR]
    assert (-a).to_ints() == [P.R_SCALAR - 3, P.R_SCALAR - 5]
    assert (a - b).to_ints() == [(3 - 10) % P.R_SCALAR, 6]
    assert (a * a.inverse()).to_ints() == [1, 1]
    assert Fr.zero(2, CPU).inverse().is_zero().all()  # zeros map to zero
    assert Fr.from_str("1901", device=CPU).to_ints() == [1901]
    assert Fr.from_str("19x1", device=CPU) is None and Fr.from_str("", device=CPU) is None
    # -1 == from_str(r-1) (test_str, src/fields/mod.rs:68-71)
    assert (-Fr.one(1, CPU)) == Fr.from_str(str(P.R_SCALAR - 1), device=CPU)
    assert a.batch == 2 and a.dev.dtype == torch.int32 and a.dev.device.type == "cpu"


def test_fr_interpret():
    assert Fr.interpret((123456789).to_bytes(64, "big"), CPU).to_ints() == [123456789]
    big = ((1 << 512) - 1).to_bytes(64, "big")
    assert Fr.interpret(big, CPU).to_ints() == [((1 << 512) - 1) % P.R_SCALAR]


def test_fr_pow():
    a = Fr.from_ints([3, 7], CPU)
    e = Fr.from_ints([20, P.R_SCALAR - 2], CPU)
    assert a.pow(e).to_ints() == [pow(3, 20, P.R_SCALAR), pow(7, P.R_SCALAR - 2, P.R_SCALAR)]


def test_fr_random_draws_the_scalars_of_the_jax_package():
    ours, theirs = Fr.random(5, 3, CPU), bn_tpu.Fr.random(5, 3)
    assert ours.to_ints() == theirs.to_ints()
    assert ours.to_bytes() == theirs.to_bytes()
    rng = random.Random(5)
    assert ours.to_ints() == [rng.getrandbits(512) % P.R_SCALAR for _ in range(3)]
    assert Fr.from_bytes(ours.to_bytes(), CPU) == ours
    with pytest.raises(S.DecodeError):
        Fr.from_bytes([P.R_SCALAR.to_bytes(32, "big")], CPU)
    with pytest.raises(S.DecodeError):
        Fr.from_bytes([bytes(31)], CPU)


# ---------------------------------------------------------------------------
# the host codec against the Python-int paths (tests/test_native.py)
# ---------------------------------------------------------------------------


def test_native_builds_under_its_own_key_and_does_not_give_way(monkeypatch):
    assert not hasattr(native, "available")
    path = build.build_host()
    assert path == build.host_lib_path() and path.exists() and path.parent == build.BUILD and path.name.startswith("libbn_host.")
    assert "bn_host" not in build.sources() and build.HOST_SOURCE.suffix == ".cpp"
    # another source text is another library, and a compiler that is not there raises
    monkeypatch.setattr(build, "HOST_FLAGS", build.HOST_FLAGS + ["-DBN_OTHER_KEY"])
    assert build.host_lib_path() != path
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError):
        build.build_host()


def test_native_fp_decode_encode_roundtrip():
    random.seed(21)
    for field, m in ((native.FIELD_FQ, P.Q), (native.FIELD_FR, P.R_SCALAR)):
        xs = [random.randrange(m) for _ in range(64)] + [0, 1, m - 1]
        data = b"".join(v.to_bytes(32, "big") for v in xs)
        rows = native.fp_decode_batch(data, field)
        assert np.array_equal(rows, np.stack([P.int_to_limbs(P.to_mont(v, m)) for v in xs]))
        assert native.fp_encode_batch(rows, field) == data
        # the bytes of the pure-Python codec
        encode = S.encode_fq if field == native.FIELD_FQ else S.encode_fr
        assert data == b"".join(encode(v) for v in xs)


def test_native_fp_decode_rejects():
    with pytest.raises(ValueError):
        native.fp_decode_batch(P.Q.to_bytes(32, "big"), native.FIELD_FQ)
    with pytest.raises(ValueError):
        native.fp_decode_batch(((1 << 256) - 1).to_bytes(32, "big"), native.FIELD_FR)
    with pytest.raises(ValueError):
        native.fp_decode_batch(bytes(33), native.FIELD_FR)
    with pytest.raises(ValueError):
        native.fp_encode_batch(np.zeros((2, 15), np.uint32), native.FIELD_FR)


def test_native_fq2_roundtrip_and_reject():
    random.seed(22)
    pairs = [(random.randrange(P.Q), random.randrange(P.Q)) for _ in range(32)]
    pairs += [(0, 0), (P.Q - 1, P.Q - 1)]
    data = b"".join(S.encode_fq2(v) for v in pairs)
    assert data == b"".join((c1 * P.Q + c0).to_bytes(64, "big") for c0, c1 in pairs)
    rows = native.fq2_decode_batch(data)
    assert np.array_equal(rows[:, :16], np.stack([P.int_to_limbs(P.to_mont(c0, P.Q)) for c0, _ in pairs]))
    assert np.array_equal(rows[:, 16:], np.stack([P.int_to_limbs(P.to_mont(c1, P.Q)) for _, c1 in pairs]))
    assert native.fq2_encode_batch(rows) == data
    with pytest.raises(ValueError):
        native.fq2_decode_batch((P.Q * P.Q).to_bytes(64, "big"))


def test_native_interpret_matches_python():
    random.seed(23)
    bufs = [random.getrandbits(512).to_bytes(64, "big") for _ in range(16)]
    rows = native.fp_interpret_batch(b"".join(bufs), native.FIELD_FR)
    expect = np.stack([P.int_to_limbs(P.to_mont(int.from_bytes(b, "big") % P.R_SCALAR, P.R_SCALAR)) for b in bufs])
    assert np.array_equal(rows, expect)


# ---------------------------------------------------------------------------
# the wire format on the host (tests/test_serialization.py)
# ---------------------------------------------------------------------------


def test_fr_roundtrip_and_reject():
    random.seed(1)
    for v in [0, 1, P.R_SCALAR - 1] + [random.randrange(P.R_SCALAR) for _ in range(8)]:
        assert S.decode_fr(S.encode_fr(v)) == v and S.encode_fr(v) == JS.encode_fr(v)
    for bad in (P.R_SCALAR, (1 << 256) - 1):
        with pytest.raises(S.DecodeError):
            S.decode_fr(bad.to_bytes(32, "big"))


def test_fq2_packing():
    """Fq2 packs as the single U512 c1*q + c0 (fq2.rs:31-53)."""
    random.seed(2)
    for _ in range(8):
        v = (random.randrange(P.Q), random.randrange(P.Q))
        enc = S.encode_fq2(v)
        assert len(enc) == 64 and int.from_bytes(enc, "big") == v[1] * P.Q + v[0]
        assert S.decode_fq2(enc) == v and enc == JS.encode_fq2(v)
    with pytest.raises(S.DecodeError):
        S.decode_fq2((P.Q * P.Q).to_bytes(64, "big"))
    assert S.decode_fq2((P.Q * P.Q - 1).to_bytes(64, "big")) == (P.Q - 1, P.Q - 1)


def test_g1_roundtrip():
    random.seed(3)
    for k in [1, 2, random.randrange(P.R_SCALAR)]:
        p = O.g1_mul(O.G1_ONE, k)
        enc = S.encode_g1(p)
        assert enc[0] == 4 and len(enc) == 65 and enc == JS.encode_g1(p)
        assert O.g_eq(O.FQ_OPS, S.decode_g1(enc), p)
    assert S.encode_g1(O.g_zero(O.FQ_OPS)) == b"\x00" == JS.encode_g1(O.g_zero(O.FQ_OPS))
    assert O.g_is_zero(O.FQ_OPS, S.decode_g1(b"\x00"))


def test_g1_rejects():
    with pytest.raises(S.DecodeError):
        S.decode_g1(bytes([7]) + bytes(64))  # bad tag
    with pytest.raises(S.DecodeError):  # off-curve point: x=0, y=1 -> 1 != 0 + 3
        S.decode_g1(bytes([4]) + (0).to_bytes(32, "big") + (1).to_bytes(32, "big"))
    with pytest.raises(S.DecodeError):  # non-canonical coordinate (>= q)
        S.decode_g1(bytes([4]) + P.Q.to_bytes(32, "big") + (2).to_bytes(32, "big"))
    with pytest.raises(S.DecodeError):
        S.decode_g1(b"\x00\x00")  # trailing bytes after the infinity tag
    with pytest.raises(S.DecodeError):
        S.decode_g1(b"")


def test_g2_structural_rejects_need_no_device():
    for bad in (b"", b"\x00\x00", bytes([7]) + bytes(128), bytes([4]) + bytes(100),
                bytes([4]) + S.encode_fq2((0, 0)) + S.encode_fq2((1, 1)),  # off curve
                bytes([4]) + (P.Q * P.Q).to_bytes(64, "big") + S.encode_fq2((1, 1))):
        with pytest.raises(S.DecodeError):
            S.decode_g2(bad, CPU)
    assert O.g_is_zero(O.FQ2_OPS, S.decode_g2(b"\x00", CPU))
    assert S.encode_g2(O.g_zero(O.FQ2_OPS)) == b"\x00"


# ---------------------------------------------------------------------------
# groups, pairing, serialization through the API (tests/test_api.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def g1_multiples():
    """5 G, 7 G, 777 G by one ladder."""
    return G1.one(3, CPU) * Fr.from_ints([5, 7, 777], CPU)


@pytest.fixture(scope="module")
def random_points():
    """(G1.random(3, 2), G2.random(4, 2)) and their bytes."""
    p, q = G1.random(3, 2, CPU), G2.random(4, 2, CPU)
    return p, q, p.to_bytes(), q.to_bytes()


def test_group_api(g1_multiples):
    p = _lanes(g1_multiples, 0, 2)
    for g, e in zip(p.to_oracle(), [O.g1_mul(O.G1_ONE, 5), O.g1_mul(O.G1_ONE, 7)]):
        assert O.g_eq(O.FQ_OPS, g, e)
    assert (p - p).is_zero().all()
    assert (p + G1.zero(2, CPU)) == p
    assert p.double() == p + p and not (p.double() == p)
    n = p.normalize()
    assert n == p
    assert torch.equal(n.dev[2], G1.one(2, CPU).dev[2])  # normalized z == 1
    z = G1.zero(2, CPU).normalize()
    assert z.is_zero().all() and torch.equal(z.dev[1], G1.zero(2, CPU).dev[1])  # (0, 1, 0) stays


def test_pairing_api_bilinear_and_equal_to_the_jax_package(g1_multiples):
    s = Fr.from_ints([12345], CPU)
    p = _lanes(g1_multiples, 2, 3)
    q = G2.one(1, CPU) * Fr.from_ints([888], CPU)
    # the three pairings of the bilinearity check as one batch of three
    e = pairing(_cat(p * s, p, p), _cat(q, q * s, q))
    a, b = _lanes(e, 0, 1), _lanes(e, 1, 2)
    c = _lanes(e, 2, 3).pow(s)
    assert a == b and b == c
    assert not (a == Gt.one(1, CPU))
    assert a * a.inverse() == Gt.one(1, CPU)
    # the same pairing and power in the JAX package, on the same points: state
    # carried across in both directions (the two packages' ladders are held
    # against each other in the serialization test below)
    jp = bn_tpu.G1(tuple(jnp.asarray(t) for t in convert.object_to_numpy(p)))
    jq = bn_tpu.G2(tuple(jnp.asarray(t) for t in convert.object_to_numpy(q)))
    assert jp.to_bytes() == p.to_bytes() == [JS.encode_g1(O.g1_mul(O.G1_ONE, 777))]
    assert jq.to_bytes() == q.to_bytes() == [JS.encode_g2(O.g2_mul(O.G2_ONE, 888))]
    jc = bn_tpu.pairing(jp, jq).pow(bn_tpu.Fr.from_ints([12345]))
    assert c.to_oracle() == jc.to_oracle()
    assert convert.object_from_jax(Gt, np.asarray(jc.dev), CPU) == c
    assert convert.object_from_jax(G1, tuple(np.asarray(t) for t in jp.dev), CPU) == p
    assert not hasattr(Gt, "to_bytes")  # Gt is not serializable (lib.rs:165)


def test_serialization_api_and_the_bytes_of_the_jax_package(random_points):
    p, q, p_bytes, q_bytes = random_points
    assert G1.from_bytes(p_bytes, CPU) == p
    assert [len(b) for b in p_bytes + q_bytes] == [65, 65, 129, 129]
    assert p_bytes == bn_tpu.G1.random(3, 2).to_bytes()
    assert q_bytes == bn_tpu.G2.random(4, 2).to_bytes()
    assert p_bytes == [JS.encode_g1(pt) for pt in p.to_oracle()]
    assert q_bytes == [JS.encode_g2(pt) for pt in q.to_oracle()]


def test_g2_roundtrip_through_the_batched_subgroup_check(random_points):
    """One decode call, one ladder: two random points, a multiple of the
    generator from the oracle, and infinity."""
    _, q, _, q_bytes = random_points
    random.seed(4)
    extra = O.g2_mul(O.G2_ONE, random.randrange(P.R_SCALAR))
    enc = S.encode_g2(extra)
    assert enc[0] == 4 and len(enc) == 129 and enc == JS.encode_g2(extra)
    got = G2.from_bytes(q_bytes + [enc, b"\x00"], CPU)
    assert _lanes(got, 0, 2) == q
    pts = got.to_oracle()
    assert O.g_eq(O.FQ2_OPS, pts[2], extra) and O.g_is_zero(O.FQ2_OPS, pts[3])


def test_g2_rejects_out_of_subgroup(random_points):
    """The consensus-critical check_order path (src/groups/mod.rs:186-195,
    399): an on-curve point of E'(Fq2) outside the r-order subgroup must be
    refused on decode, and the error names its place in the batch."""
    found = None
    for i in range(1, 200):
        x = (i, 1)
        rhs = O.fq2_add(O.fq2_mul(O.fq2_sq(x), x), O.twist_b())
        y = O.fq2_sqrt(rhs)
        if y is None:
            continue
        assert O.fq2_sq(y) == rhs
        if not O.g2_in_subgroup((x, y)):
            found = (x, y)
            break
    assert found is not None, "no out-of-subgroup point found in 200 candidates"
    assert O.g2_on_curve(found)
    bad = bytes([4]) + S.encode_fq2(found[0]) + S.encode_fq2(found[1])
    with pytest.raises(S.DecodeError, match=r"batch index 2\)"):
        S.decode_g2_batch([random_points[3][0], b"\x00", bad], CPU)
