"""One run of one cell: set-up, the measured window, the check, the
result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up runs from the process's start to the window's start and is split
on an earlier line (imports, CUDA init, the build of the cell's CUDA
sources, inputs from the seed, the program's resident state, warm-up).
The window runs steps of the cell's load until `--seconds` have passed
and the last step has ended; a `window` line on standard error then says
what the host did meanwhile (HostWatch).  With `--trace 1` the first `trace_steps`
steps of the window run under `torch.profiler`, and the result reports the
per-layer metrics instead of the end-to-end ones.  After the window the
peak memory is read, the program's state dropped and what the window
produced checked against the plain reference; each number compared is
printed beside its limit on the last lines of standard error and, last,
in the result line, the last line of standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

#: top-level module names that no run may load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "sppark_tpu")
#: launch counters the program keeps, printed on an earlier line
COUNTERS = (("sppark_tpu_torch.ntt.kernels",
             ("launches", "narrow_launches", "wide_launches")),
            ("sppark_tpu_torch.ec.kernels", ("launches", "fp2_launches")),
            ("sppark_tpu_torch.ff.kernels", ("launches",)))


@dataclass
class Run:
    """What the metrics' readers read: the window's host clock figures and,
    in a traced run, the trace."""

    setup_s: float
    window_s: float = 0.0
    calls: int = 0
    latencies_s: List[float] = field(default_factory=list)
    peak_bytes: int = 0
    trace: Optional[object] = None


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared as whole names."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def _counters() -> Dict[str, int]:
    out = {}
    for mod, attrs in COUNTERS:
        m = sys.modules.get(mod)
        for a in attrs:
            out.update(getattr(m, a, {}) if m else {})
    return {k: v for k, v in out.items() if v}


class HostWatch:
    """What the host did during the window, for the `window` line: the
    steps' spread, this process's CPU seconds and its main thread's, and
    the garbage collector's pauses."""

    def __init__(self):
        self.gc_s, self.gc_n, self._t = 0.0, 0, 0.0
        gc.callbacks.append(self._gc)
        self.proc0, self.thread0 = time.process_time(), time.thread_time()

    def _gc(self, phase, info) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n += 1

    def close(self, run: Run) -> dict:
        gc.callbacks.remove(self._gc)
        lat = sorted(run.latencies_s)
        q = (lambda f: lat[min(len(lat) - 1, int(f * len(lat)))] * 1e3) \
            if lat else (lambda f: None)
        return {"window_s": run.window_s, "steps": len(lat),
                "step_ms_min": q(0), "step_ms_median": q(0.5),
                "step_ms_max": q(1), "process_cpu_s":
                time.process_time() - self.proc0,
                "main_thread_cpu_s": time.thread_time() - self.thread0,
                "gc_pauses": self.gc_n, "gc_s": self.gc_s}


def run_window(load, seconds: float, run: Run, trace_steps: int = 0) -> None:
    """Steps of `load` until `seconds` have passed since the window opened
    and the step under way has ended; the first `trace_steps` steps under
    the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .trace import STEP, read_profile

    prof = None
    if trace_steps:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    traced_calls = 0
    t_open = time.perf_counter()
    steps = 0
    while True:
        t0 = time.perf_counter()
        if prof is not None:
            with record_function(STEP):
                calls = load.step()
            traced_calls += calls
        else:
            calls = load.step()
        t1 = time.perf_counter()
        run.calls += calls
        run.latencies_s.append(t1 - t0)
        steps += 1
        if prof is not None and steps == trace_steps:
            prof.__exit__(None, None, None)
            run.trace = read_profile(prof, traced_calls)
            run.trace.work = load.work(traced_calls)
            prof = None
        if t1 - t_open >= seconds and prof is None:
            break
    run.window_s = t1 - t_open
    if load.device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(load.device)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(cell, seed: int, seconds: float, trace: bool, dev,
            t_start: float, split: Dict[str, float]) -> dict:
    """Set-up, window and check of `cell` on `dev`; the result line's
    object.  `split` holds the set-up parts timed before the call."""
    import torch
    from sppark_tpu_torch import _build

    load = cell.make_load(seed, dev)
    t = time.perf_counter()
    if dev.type == "cuda":
        _build.build(load.sources())
    split["build"] = time.perf_counter() - t
    for part, fn in (("inputs", load.make_inputs),
                     ("resident", load.prepare), ("warmup", load.warmup)):
        t = time.perf_counter()
        fn()
        _sync(dev)
        split[part] = time.perf_counter() - t
    run = Run(setup_s=time.perf_counter() - t_start)
    split["other"] = run.setup_s - sum(split.values())
    _err("setup_s " + json.dumps({"total": run.setup_s, **split}))

    trace_steps = int(cell.traffic.get("trace_steps", 1)) if trace else 0
    watch = HostWatch()
    run_window(load, seconds, run, trace_steps)
    _err("window " + json.dumps(watch.close(run)))
    _err("counters " + json.dumps(_counters()))

    # the check, once the window has closed and the peak has been read
    load.free()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checked, failed, numbers = load.check()
    _err(f"check: {checked} of {run.calls} calls checked, {failed} wrong, "
         f"{time.perf_counter() - t:.3f} s")
    correct = failed == 0 and checked > 0 and all(
        v <= lim for v, lim in numbers.values())

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(run)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    result = {"correct": correct, "attempted": run.calls, "failed": failed,
              "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in numbers.items()}
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = t_start if t_start is not None else time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    split: Dict[str, float] = {}
    t = time.perf_counter()
    import torch
    split["torch_import"] = time.perf_counter() - t
    from .spec import find_cell
    cell = find_cell(args.workload)
    t = time.perf_counter()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _err(f"benchmark: cell {cell.name} needs {cell.chips} CUDA "
             f"device(s); found {torch.cuda.device_count()}")
        return 3
    import sppark_tpu_torch  # noqa: F401  (the program under test)
    split["imports"] = time.perf_counter() - t
    t = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    torch.zeros(1, device=dev)
    split["cuda_init"] = time.perf_counter() - t

    result = measure(cell, args.seed, args.seconds, bool(args.trace), dev,
                     t_start, split)
    found = forbidden_modules()
    if found:
        _err("benchmark: forbidden modules loaded: " + ", ".join(found))
        return 4
    result["device"]["power_limit"] = _power_limit()
    for k, c in result["checks"].items():
        _err(f"check {k} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0
