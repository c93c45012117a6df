"""The cell a run measures, found by name: its entry in BENCHMARK.json, its
configuration (the file BENCHMARK.json names for it), its traffic mix
(<home>/traffic/<traffic>.json, with an optional generator module
<home>/traffic/<traffic>.py beside it, else inputs.py generates) and the
readers of its per-layer metrics (<home>/metrics/<metric>.py), where <home>
is the first of BENCHMARK.json's `paths`.  Adding any of these is adding a
file and an entry; nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the BENCHMARK.json entries the cell reports
    per_layer: list
    home: str = str(HERE)  # the folder of traffic/ and metrics/
    generator: str | None = None  # path of the mix's generator module; None: inputs.py

    def reader(self, metric: str):
        return reader(metric, Path(self.home))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path) -> Cell:
    """The cell `name` of the BENCHMARK.json in `root`."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (there are {sorted(by_name)})")
    w = by_name[name]
    home = root / bench["paths"][0]
    config_file = {c["name"]: c["file"] for c in bench["configs"]}[w["config"]]
    config = json.loads((root / config_file).read_text())
    traffic = json.loads((home / "traffic" / f"{w['traffic']}.json").read_text())
    generator = home / "traffic" / f"{w['traffic']}.py"
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)],
                str(home.resolve()), str(generator.resolve()) if generator.is_file() else None)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # as an import would: dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def generator(cell: Cell):
    """The module that makes the cell's inputs: the mix's own generator, else
    inputs.py.  It has `draw(seed, index, traffic)`, the description of input
    batch `index` (the judge's hooks: see inputs.Progression), and
    `make_batch(description, device)`, the batch itself."""
    if cell.generator is None:
        from . import inputs
        return inputs
    return _module(Path(cell.generator), f"cardbench.traffic.{Path(cell.generator).stem}")


def reader(metric: str, home: Path = HERE):
    """The module <home>/metrics/<metric>.py: `read(records, context)`,
    and optionally SPANS {span: dotted path} and COUNTERS {counter: dotted
    path} that a traced run must record for it."""
    return _module(home / "metrics" / f"{metric}.py", f"cardbench.metrics.{metric}")
