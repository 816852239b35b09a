"""The benchmark's cells at sizes a CPU test run can hold: each cell of
BENCHMARK.json with its traffic's sizes cut, and `measure` on a device
without the harness's look for a card."""

import time

import torch

from benchmark.core.harness import measure
from benchmark.core.spec import find_cell

#: traffic overrides: tiny domains; the MSM also takes 4-bit windows (a
#: short integrate on the plain path) and a ring of 2
SMALL = {"bls12_381.msm_g1": {"lg": 6, "lg_base": 4, "context_wbits": 4,
                              "ring": 2},
         "goldilocks.ntt": {"lg": 10},
         "goldilocks.lde": {"lg": 10},
         "bls12_381.lde_fr": {"lg": 8}}


def small_cell(name):
    cell = find_cell(name)
    cell.traffic = {**cell.traffic, **SMALL[name], "sources": []}
    return cell


def run_small(name, seed=2 ** 31 + 12345, trace=False, device="cpu",
              load=None):
    """One run of the cell at its small size: the window is one step.
    `load` puts another Load class (a fault) in the kind's place."""
    cell = small_cell(name)
    cell.load = load or cell.load
    return measure(cell, seed, 0.0, trace, torch.device(device),
                   time.perf_counter(), {})
