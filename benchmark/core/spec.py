"""The benchmark's data: BENCHMARK.json at the root of the checkout, one
file per configuration, one per traffic mix, one per kind of traffic and
one reader per metric.

A cell is found by its name in BENCHMARK.json's `workloads`; its
configuration's file is the `file` that BENCHMARK.json names, its traffic
mix `benchmark/traffic/<traffic>.json`, the mix's kind
`benchmark/kinds/<kind>.py`, a module whose `LOAD` is a subclass of
core/loads.py's `Load`, and each metric's reader
`benchmark/metrics/<metric name>.py`, a module with `read(run)` that
returns a number or None.  Adding a cell, a configuration, a mix, a kind
or a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

#: the benchmark's own directory (this file is benchmark/core/spec.py)
BENCH_DIR = Path(__file__).resolve().parents[1]
#: the checkout's root, which holds BENCHMARK.json and the program
ROOT = BENCH_DIR.parent


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    #: the kind's Load subclass: load(config, traffic, seed, device)
    load: type
    end_to_end: List[Metric]
    per_layer: List[Metric]

    def make_load(self, seed: int, device):
        return self.load(self.config, self.traffic, seed, device)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(bench_dir: Path, folder: str, name: str):
    """benchmark/<folder>/<name>.py as a module (the name may hold dots)."""
    path = bench_dir / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """metrics/<name>.py's `read`."""
    return _module(bench_dir, "metrics", name).read


def load_kind(name: str, bench_dir: Path = BENCH_DIR) -> type:
    """kinds/<name>.py's `LOAD`."""
    return _module(bench_dir, "kinds", name).LOAD


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def find_cell(name: str, root: Path = ROOT,
              bench_dir: Optional[Path] = None) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its configuration, its
    traffic mix and the readers of the metrics it reports."""
    bench_dir = bench_dir or root / "benchmark"
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}: the workloads are "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")

    def metrics(key: str) -> List[Metric]:
        return [Metric(m["name"], m["unit"], load_reader(m["name"],
                                                        bench_dir))
                for m in spec[key] if _applies(m, name)]

    return Cell(name, int(w["chips"]), config, traffic,
                load_kind(traffic["kind"], bench_dir),
                metrics("end_to_end"), metrics("per_layer"))

