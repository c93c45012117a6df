"""The frozen reference, its plain-PyTorch arithmetic, the judge, and what
the harness imports."""

import ast
import json
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bn_tpu_torch import oracle as O
from cardbench import inputs, judge
from cardbench.reference import field as rf
from cardbench.reference import limbs as rl

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


@pytest.mark.parametrize("k1,k2", [(1, 1), (5, 7), (2**200 + 3, 3**150 + 1)])
def test_reference_pairing_equals_the_ports_oracle(k1, k2):
    p, q = O.g1_mul(O.G1_ONE, k1), O.g2_mul(O.G2_ONE, k2)
    assert rf.Ref().pairing(p, q) == O.pairing(p, q)


def test_stored_work_equals_what_the_reference_counts():
    stored = json.loads((HERE / "reference" / "work.json").read_text())["products_per_pair"]
    assert stored == rf.count_work()
    per_stage = {}
    rf.Ref().pairing(O.g1_mul(O.G1_ONE, 99), O.g2_mul(O.G2_ONE, 101), per_stage)
    assert per_stage == stored


def _randoms(n, seed=7):
    rng = random.Random(seed)
    return [0, 1, rf.Q - 1, rf.Q - 2, (1 << 255) % rf.Q] + [rng.randrange(rf.Q) for _ in range(n)]


def test_limb_field_ops_equal_pythons_integers():
    xs, ys = _randoms(40), _randoms(40, seed=8)[::-1]
    a, b = torch.from_numpy(rl.ints_to_limbs(xs)), torch.from_numpy(rl.ints_to_limbs(ys))
    assert rl.limbs_to_ints(rl.mont_mul(a, b)) == [x * y % rf.Q for x, y in zip(xs, ys)]
    assert rl.limbs_to_ints(rl.add(a, b)) == [(x + y) % rf.Q for x, y in zip(xs, ys)]
    assert rl.limbs_to_ints(rl.sub(a, b)) == [(x - y) % rf.Q for x, y in zip(xs, ys)]
    assert rl.is_canonical(a).all()
    raw = torch.from_numpy(rl.ints_to_limbs([rf.Q, rf.Q + 5, (1 << 256) - 1, rf.Q - 1], mont=False))
    assert rl.is_canonical(raw).tolist() == [False, False, False, True]


def test_limb_fq12_product_equals_the_reference():
    ref, g = rf.Ref(), judge._base()[1]
    a, b = g, ref.f12_pow(g, 12345)
    got = rl.fq12_mul(rl.fq12_from_ints(rf.fq12_ints(a), "cpu"), rl.fq12_from_ints(rf.fq12_ints(b), "cpu"))
    assert torch.equal(got, rl.fq12_from_ints(rf.fq12_ints(ref.f12_mul(a, b)), "cpu"))


def _pairings(prog):
    ref = rf.Ref()
    return torch.cat([judge.gt_power(prog.exponent(i), "cpu") for i in range(prog.n)], dim=-1).to(torch.int32), ref


def test_judge_passes_the_reference_and_fails_each_kind_of_wrong_output():
    prog = inputs.progression(2**32 + 3, 0, 7)
    out, _ = _pairings(prog)
    assert judge.lanes_failed(out, prog) == 0
    flipped = out.clone()
    flipped[0, 2, 1, 5, 6] ^= 1
    assert judge.lanes_failed(flipped, prog) > 0
    first = out.clone()
    first[1, 0, 0, 0, 0] ^= 4
    assert judge.lanes_failed(first, prog) > 0
    assert judge.lanes_failed(out[..., [0, 1, 3, 2, 4, 5, 6]], prog) > 0
    zeroed = out.clone()
    zeroed[..., 4:] = 0
    assert judge.lanes_failed(zeroed, prog) > 0
    redundant = rl._carry(out.to(torch.int64) + rl.const(rf.Q, "cpu", mont=False))
    assert judge.lanes_failed(redundant.to(torch.int32), prog) == 7


def test_judge_of_a_product():
    prog = inputs.progression(2**32 + 4, 0, 6)
    want = judge.gt_power(prog.exponent_sum(), "cpu").to(torch.int32)
    assert judge.product_failed(want, prog) == 0
    assert judge.product_failed(judge.gt_power(prog.exponent_sum() + 1, "cpu").to(torch.int32), prog) == 1


def _run(code: str) -> str:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, capture_output=True, text=True).stdout


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; import cardbench.run, cardbench.control, cardbench.reference.field, cardbench.reference.limbs; "
            "from cardbench import cells, trace; from pathlib import Path; "
            "[trace.resolve(cells.load(w, Path('.')).config['entry']) for w in "
            "('pairing.b65536', 'product.4card.b262144')]; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'bn_tpu'}), "
            "'bn_tpu_torch' in sys.modules)")
    assert _run(code).split() == ["[]", "True"]


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; import cardbench.reference.field, cardbench.reference.limbs, cardbench.judge, "
            "cardbench.inputs; print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'bn_tpu', 'bn_tpu_torch'}))")
    assert _run(code).strip() == "[]"
    for path in (HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level else [])
            assert not any(n.split(".")[0] in ("jax", "bn_tpu", "bn_tpu_torch") for n in names), (path, names)
