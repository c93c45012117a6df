"""On the card: the package itself through the harness at a small size, sound
and with the control.  Run on a host with a CUDA card:
    python -m pytest cardbench/tests -m card"""

import copy
from pathlib import Path

import pytest

from cardbench import cells, run

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("fault", [None, "lazy_reduction", "state_unchanged", "half_batch", "answer_altered"])
def test_pairing_on_the_card(card, fault):
    cell = cells.load("pairing.b65536", ROOT)
    cell.traffic = dict(cell.traffic, pairs_per_call=1024)
    cell.config = copy.deepcopy(cell.config)
    result = run.run_cell(cell, 2**32 + 77, 0.5, False, {"hooks": [fault] if fault else []})
    assert result["device"]["platform"] == "gpu"
    assert result["correct"] == (fault is None)
