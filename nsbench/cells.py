"""Finds a cell's pieces by the names in ``BENCHMARK.json``.

- a configuration: the file its ``configs`` entry names
  (``nsbench/configs/<config>.json``);
- a traffic mix: ``nsbench/traffic/<traffic>.json``, and the callback of
  a reduce step in ``nsbench/traffic/<traffic>.py``;
- a per-layer metric: the reader ``nsbench/metrics/<metric>.py``, whose
  ``read(record)`` returns a number or None.

Adding a configuration, a mix or a metric adds files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def active_pairs(config: dict) -> list:
    """The configuration's active (query set, candidate set) pairs."""
    n = len(config["sets"])
    if config["active"] == "all":
        return [(i, j) for i in range(n) for j in range(n)]
    return [tuple(p) for p in config["active"]]


class Cell:
    """One entry of ``workloads`` with its configuration and traffic."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench = load_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = load_json(self.root / configs[self.entry["config"]]
                                ["file"])
        here = self.root / "nsbench"
        self.traffic = load_json(here / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.callback = None
        reduce = self.traffic.get("reduce")
        if reduce:
            module = load_module(here / "traffic"
                                 / f"{self.entry['traffic']}.py",
                                 f"nsbench_traffic_{self.entry['traffic']}")
            self.callback = module.callback(self.config["radius"])

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        return load_module(self.root / "nsbench" / "metrics"
                           / f"{metric}.py", f"nsbench_metric_{metric}")
