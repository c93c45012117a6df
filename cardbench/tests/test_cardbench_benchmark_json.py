"""BENCHMARK.json against the rules its checker applies before any run."""

import json
import re
from pathlib import Path

import pytest

from cardbench import cells

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head|_dim$|_rank$|expansion|per_tok)")


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and all(1 <= len(w) <= 200 for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and (ROOT / p).is_dir()
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    names = [m["name"] for m in _metrics()] + [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names), names
    for group in (_metrics(), BENCH["workloads"], BENCH["configs"]):
        assert len({x["name"] for x in group}) == len(group)
    for m in _metrics():
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert not any(WIDTHS.search(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for w in BENCH["workloads"]:
        cell = cells.load(w["name"], ROOT)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_moves_names_an_end_to_end_metric_every_cell_of_the_layer_metric_reports():
    for m in BENCH["per_layer"]:
        for w in m.get("workloads", [x["name"] for x in BENCH["workloads"]]):
            assert m["moves"] in {e["name"] for e in cells.load(w, ROOT).end_to_end}, (m["name"], w)


def test_four_chip_cells_are_at_most_a_quarter_or_one():
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_are_found_by_name(workload):
    cell = cells.load(workload, ROOT)
    for m in cell.per_layer:
        assert callable(cells.reader(m["name"]).read)
    config_entry = next(c for c in BENCH["configs"] if c["name"] == cell.config["name"])
    assert (ROOT / config_entry["file"]).is_file() and config_entry["file"].startswith("cardbench/configs/")
    assert config_entry["reduced"] == cell.config["reduced"]
    assert {"pairs_per_call", "in_flight", "pool"} <= set(cell.traffic)
