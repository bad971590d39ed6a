"""What the harness finds by name: BENCHMARK.json at the repository root,
and under benchmark/ a configuration's file, a traffic mix's file, a
cell's limits, a traffic kind's module and a metric's reader.

- configs/<config>.json: the model's sizes, precision, source, `reduced`
  and `assumed`, and the job (sampling or training) it is run in;
- traffic/<traffic>.json: the mix's parameters, with `kind` naming its
  generator, kinds/<kind>.py (a module whose KIND is the class that runs it);
- workloads/<cell>.json: the limits of the numbers that decide
  `correct`;
- metrics/<metric>.py: a reader `read(run) -> float or None` for each
  metric of BENCHMARK.json, end-to-end or per layer.

A later change adds a configuration, a mix, a cell or a metric by adding
such files and its entries in BENCHMARK.json; nothing here names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def checked_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """BENCHMARK.json and the files it names, under `root`."""

    def __init__(self, root: Path = ROOT, here: Optional[Path] = None):
        self.root = Path(root)
        self.here = Path(here) if here else self.root / "benchmark"
        self.spec = read_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return read_json(self.here / "configs" / f"{checked_name(name)}.json")

    def traffic(self, name: str) -> dict:
        return read_json(self.here / "traffic" / f"{checked_name(name)}.json")

    def limits(self, cell: str) -> Dict[str, float]:
        path = self.here / "workloads" / f"{checked_name(cell)}.json"
        return read_json(path)["limits"] if path.exists() else {}

    def metrics(self, cell: str, per_layer: bool) -> List[dict]:
        """The metrics this cell reports: those that list it, or list no
        cells."""
        group = self.spec["per_layer" if per_layer else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        path = self.here / "metrics" / f"{checked_name(metric)}.py"
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + re.sub(r"\W", "_", metric), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def kind_class(kind: str):
    """The class that runs a traffic kind: benchmark.kinds.<kind>.KIND."""
    return importlib.import_module(
        f"benchmark.kinds.{checked_name(kind)}").KIND
