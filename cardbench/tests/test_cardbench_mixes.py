"""Cells added by files and entries alone: a traffic mix of data alone (G2
one of a few fixed points), a mix with a generator module of its own, and
the product configuration on one rank, each in a copy of the
benchmark's tree that only gains files and entries, run whole on the CPU
with the stand-in pairing (tests/standin.py)."""

import copy
import json
import shutil
from pathlib import Path

import pytest
import torch

from bn_tpu_torch import curve
from bn_tpu_torch import oracle as O
from cardbench import cells, judge, run
from cardbench.reference import field as rf

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
STANDIN = "cardbench.tests.standin:install"
SEED = 2**34 + 9


def _tree(tmp_path: Path, workload: dict, traffic: dict, generator: Path | None = None) -> Path:
    """A copy of BENCHMARK.json and the benchmark's data files with one more
    cell, its mix in a new file (and its generator module beside it)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(workload)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "cardbench" / sub, tmp_path / "cardbench" / sub)
    (tmp_path / "cardbench" / "traffic" / f"{workload['traffic']}.json").write_text(json.dumps(traffic))
    if generator is not None:
        shutil.copy(generator, tmp_path / "cardbench" / "traffic" / f"{workload['traffic']}.py")
    return tmp_path


def _standin_final_step(cell):
    cell.config = copy.deepcopy(cell.config)
    cell.config["paths"]["final_step"] = "cardbench.tests.standin.final_exp"
    return cell


def _run(cell, faults=()):
    return run.run_cell(cell, SEED, 0.2, False, {"rehearsal": True, "hooks": [STANDIN, *faults]})


@pytest.fixture
def g2fixed(tmp_path):
    """A mix of data alone: inputs.py's fixed-G2 mode."""
    workload = {"name": "pairing.g2fixed", "config": "pairing_batch", "traffic": "closed2.g2fixed", "chips": 1,
                "why": "G2 one of two fixed points"}
    traffic = {"about": "two fixed G2 points", "pairs_per_call": 7, "in_flight": 2, "pool": 2, "g2_fixed_points": 2}
    return _standin_final_step(cells.load("pairing.g2fixed", _tree(tmp_path, workload, traffic)))


@pytest.fixture
def g1fixed(tmp_path):
    """A mix with a generator module of its own."""
    workload = {"name": "pairing.g1fixed", "config": "pairing_batch", "traffic": "closed2.g1fixed", "chips": 1,
                "why": "G1 one fixed point"}
    traffic = {"about": "one fixed G1 point", "pairs_per_call": 6, "in_flight": 2, "pool": 2}
    return _standin_final_step(cells.load("pairing.g1fixed", _tree(tmp_path, workload, traffic, HERE / "mix_g1fixed.py")))


def _points(cell, index):
    generator = cells.generator(cell)
    desc = generator.draw(SEED, index, cell.traffic)
    p, q = generator.make_batch(desc, "cpu")
    return desc, curve.from_device(curve.g1_spec(), p), curve.from_device(curve.g2_spec(), q)


def test_a_mix_of_data_alone_gives_g2_fixed_points(g2fixed):
    assert g2fixed.generator is None
    desc, g1, g2 = _points(g2fixed, 0)
    for i in range(desc.n):
        assert O.g_eq(O.FQ_OPS, g1[i], O.g1_mul(O.G1_ONE, desc.k0 + (i + 1) * desc.d1))
        assert O.g_eq(O.FQ2_OPS, g2[i], O.g2_mul(O.G2_ONE, desc.keys[i % 2]))
        assert g2[i][2] != O.FQ2_ONE
    assert desc.keys[0] == 1 and desc.keys[1] != 1
    assert desc.exponent_sum() == sum(desc.exponent(i) for i in range(desc.n)) % rf.R


def test_a_mix_with_its_own_generator_makes_its_points(g1fixed):
    assert g1fixed.generator is not None and g1fixed.generator.endswith("closed2.g1fixed.py")
    desc, g1, g2 = _points(g1fixed, 1)
    for i in range(desc.n):
        assert O.g_eq(O.FQ_OPS, g1[i], O.g1_mul(O.G1_ONE, desc.h)) and g1[i][2] != 1
        assert O.g_eq(O.FQ2_OPS, g2[i], O.g2_mul(O.G2_ONE, desc.m0 + (i + 1) * desc.d2))
    assert desc.exponent_sum() == sum(desc.exponent(i) for i in range(desc.n)) % rf.R


def test_the_judge_takes_the_descriptions_stride(g2fixed):
    desc = cells.generator(g2fixed).draw(SEED, 1, g2fixed.traffic)
    out = torch.cat([judge.gt_power(desc.exponent(i), "cpu") for i in range(desc.n)], dim=-1)
    assert desc.stride == 2 and judge.lanes_failed(out, desc) == 0
    assert judge.lanes_failed(out[..., [0, 1, 2, 3, 5, 4, 6]], desc) > 0
    assert judge.lanes_failed(out[..., [0, 1, 2, 3, 4, 6, 5]], desc) > 0


@pytest.mark.parametrize("mix", ["g2fixed", "g1fixed"])
@pytest.mark.parametrize("fault", [None, "answer_altered", "state_unchanged"])
def test_a_new_mix_runs_whole(request, mix, fault):
    result = _run(request.getfixturevalue(mix), [fault] if fault else [])
    assert result["correct"] == (fault is None)
    assert result["checks"]["lanes_failed"]["value"] == 0 if fault is None else result["failed"] > 0


@pytest.mark.parametrize("fault", [None, "half_batch", "state_unchanged"])
def test_the_product_on_one_rank_is_a_data_file_and_an_entry(tmp_path, fault):
    workload = {"name": "product.b8", "config": "pairing_product", "traffic": "closed2.b8", "chips": 1,
                "why": "the product on one rank"}
    traffic = {"about": "8 pairs a call", "pairs_per_call": 8, "in_flight": 2, "pool": 2}
    cell = _standin_final_step(cells.load("product.b8", _tree(tmp_path, workload, traffic)))
    assert cell.generator is None
    result = _run(cell, [fault] if fault else [])
    assert result["device"]["count"] == 1 and result["correct"] == (fault is None)
