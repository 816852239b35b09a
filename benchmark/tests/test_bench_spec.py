"""BENCHMARK.json against the benchmark's contract, and the harness
finding a configuration, a traffic mix and a metric added as files."""

import json
import re
import shutil
import time

import pytest
import torch

from benchmark.core.harness import measure
from benchmark.core.spec import BENCH_DIR, ROOT, find_cell, load_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_check_fits_its_budget_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end",
                                 "per_layer"])
def test_names_and_units(key):
    names = [e["name"] for e in SPEC[key]]
    assert len(names) == len(set(names))
    for e in SPEC[key]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            assert text is None or (0 < len(text) <= 200
                                    and "\n" not in text and "\t" not in text)


def test_cells_and_metrics():
    configs = {c["name"]: c for c in SPEC["configs"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        cell = find_cell(w["name"])
        assert cell.end_to_end[-1].name == "setup_s" or \
            "setup_s" in [m.name for m in cell.end_to_end]
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        moved = {m["moves"] for m in SPEC["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])}
        assert moved <= {m.name for m in cell.end_to_end}
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        assert c["reduced"] == json.loads(
            (ROOT / c["file"]).read_text())["reduced"]


def test_every_metric_has_a_reader():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(load_reader(m["name"]))


def test_new_files_are_found(tmp_path):
    """A cell, a configuration, a traffic mix and a metric added as new
    files and entries, with no file of the benchmark edited."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "goldilocks.json").read_text())
    cfg["name"] = "goldilocks_plonky2"
    (bench / "configs" / "goldilocks_plonky2.json").write_text(
        json.dumps(cfg))
    (bench / "traffic" / "ntt_batch2.json").write_text(json.dumps(
        {"kind": "transform", "lg": 20, "ring": 2, "batch": 2,
         "trace_steps": 1}))
    (bench / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n    return run.calls / run.window_s\n")
    spec = dict(SPEC)
    spec["configs"] = SPEC["configs"] + [{
        "name": "goldilocks_plonky2", "source": "https://example.org/x",
        "file": "benchmark/configs/goldilocks_plonky2.json", "reduced": [],
        "why": "a second Goldilocks generator"}]
    spec["workloads"] = SPEC["workloads"] + [{
        "name": "goldilocks_plonky2.ntt2", "config": "goldilocks_plonky2",
        "traffic": "ntt_batch2", "chips": 1, "why": "two columns"}]
    spec["end_to_end"] = SPEC["end_to_end"] + [{
        "name": "calls_per_s", "unit": "1/s", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["goldilocks_plonky2.ntt2"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = find_cell("goldilocks_plonky2.ntt2", root=tmp_path)
    assert cell.config["name"] == "goldilocks_plonky2"
    assert cell.traffic["batch"] == 2
    names = [m.name for m in cell.end_to_end]
    assert "calls_per_s" in names and "setup_s" in names
    reader = cell.end_to_end[names.index("calls_per_s")].read

    class Run:
        calls, window_s = 10, 2.0
    assert reader(Run()) == 5.0
    assert {m.name for m in cell.per_layer} == {
        m["name"] for m in SPEC["per_layer"] if "workloads" not in m}


#: a kind of traffic that no cell has: the sum of a vector, checked
#: against Python's own sum
SUM_KIND = """
import torch

from benchmark.core.loads import Load


class Sum(Load):
    def make_inputs(self):
        self.x = torch.randint(0, 1000, (self.traffic["n"],),
                               generator=self.gen, device=self.device)

    def warmup(self):
        self.step()

    def step(self):
        self.out = int(self.x.sum())
        return 1

    def check(self):
        wrong = int(self.out != sum(self.x.tolist()))
        return 1, wrong, {"sum_wrong": (wrong, 0)}


LOAD = Sum
"""


def test_a_new_kind_is_a_new_file(tmp_path):
    """A kind of traffic that needs new code: one file under kinds/, a mix
    of it, a cell, and a run of that cell, with no file of the benchmark
    edited."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = tmp_path / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "kinds" / "vector_sum.py").write_text(SUM_KIND)
    (bench / "traffic" / "sum_small.json").write_text(json.dumps(
        {"kind": "vector_sum", "n": 1000}))
    spec = dict(SPEC)
    spec["workloads"] = SPEC["workloads"] + [{
        "name": "goldilocks.sum", "config": "goldilocks",
        "traffic": "sum_small", "chips": 1, "why": "a new kind"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = find_cell("goldilocks.sum", root=tmp_path)
    assert cell.load.__name__ == "Sum"
    r = measure(cell, 2 ** 33 + 1, 0.0, False, torch.device("cpu"),
                time.perf_counter(), {})
    assert r["correct"] and r["checks"] == {"sum_wrong": {"value": 0,
                                                          "limit": 0}}
    assert all(p.read_bytes() == b for p, b in before.items())
