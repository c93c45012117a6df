"""A whole run on the CPU with the timed path broken underneath: `correct`
must come out false for the control and for every fault a cell can have, and
true without one.  The look for a card is skipped (`rehearsal`), and a
stand-in built on the reference (tests/standin.py) takes the package's
pairing, whose plain versions take tens of seconds a call here; the faults
break it where they break the package."""

import copy
from pathlib import Path

import pytest

from cardbench import cells, run

ROOT = Path(__file__).resolve().parents[2]
STANDIN = "cardbench.tests.standin:install"
SEED = 2**33 + 1


def _cell(workload, pairs):
    cell = cells.load(workload, ROOT)
    cell.traffic = dict(cell.traffic, pairs_per_call=pairs)
    cell.config = copy.deepcopy(cell.config)
    cell.config["paths"]["final_step"] = "cardbench.tests.standin.final_exp"
    return cell


def _run(cell, faults, traced=False):
    return run.run_cell(cell, SEED, 0.2, traced, {"rehearsal": True, "hooks": [STANDIN] + faults})


@pytest.mark.parametrize("traced", [False, True])
def test_pairing_cell_without_a_fault_is_correct(traced):
    result = _run(_cell("pairing.b65536", 5), [], traced)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 4
    assert list(result)[-1] == "checks" and result["checks"]["lanes_failed"] == {"value": 0, "limit": 0}
    cell = cells.load("pairing.b65536", ROOT)
    if traced:  # the stand-in runs none of the package's stages: only the host's readings are there
        assert {"enqueue_ms", "launches_per_batch"} <= set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("fault", ["lazy_reduction", "state_unchanged", "half_batch", "answer_altered",
                                   "later_answer_altered"])
def test_pairing_cell_with_a_fault_is_not_correct(fault):
    result = _run(_cell("pairing.b65536", 5), [fault])
    assert not result["correct"] and result["failed"] > 0


@pytest.mark.parametrize("fault", [None, "lazy_reduction", "state_unchanged", "half_batch", "exchange_left_out",
                                   "answer_altered"])
def test_product_cell_over_four_gloo_ranks(fault):
    result = _run(_cell("product.4card.b262144", 8), [fault] if fault else [])
    assert result["device"]["count"] == 4
    assert result["correct"] == (fault is None)
