"""Readings that set the limits of a cell's `correct`: the program's on
many seeds and the control's on a few, in one process (the benchmark's
own runs never run this).

    python3 benchmark/calibrate.py --workload <cell> --seeds S1 S2 ... \
        [--control 3] [--steps 1]

For each seed the cell's load is made from that seed at the cell's own
sizes, runs the timed path until it has made `--steps` times `ring` calls
(every input of the ring once a pass) and is checked as a run checks it;
the first `--control` seeds then put the control in the program's place:
the plain reference in the precision just below the configuration's,
which breaks its guarantee of exact field results.  Each kind says what
its control is (`control_numbers`, benchmark/kinds/<kind>.py): for the
transforms every product left without its final reduction, for the MSM
the scalars cut to their low 240 bits.  Each line printed is one JSON
object: the seed, the program's numbers and the control's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def calibrate(cell, seeds, n_control: int, steps: int, dev, out=print):
    import torch

    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        load = cell.make_load(seed, dev)
        load.make_inputs()
        load.prepare()
        calls = 0
        while calls < steps * cell.traffic.get("ring", 1):
            calls += load.step()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        checked, failed, numbers = load.check()
        row = {"seed": seed, "checked": checked, "failed": failed,
               "program": {k: v for k, (v, _) in numbers.items()}}
        if i < n_control:
            row["control"] = load.control_numbers()
        row["seconds"] = time.perf_counter() - t0
        out(json.dumps(row))
        load.free()
        del load
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--steps", type=int, default=1)
    args = ap.parse_args(argv)

    import torch
    from benchmark.core.spec import find_cell
    from sppark_tpu_torch import _build

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = find_cell(args.workload)
    dev = torch.device("cuda", 0)
    _build.build(cell.traffic.get("sources", []))
    calibrate(cell, args.seeds, args.control, args.steps, dev,
              out=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
