"""What every kind of traffic shares.  A traffic mix
(`benchmark/traffic/<mix>.json`) is data: its `kind` and the parameters
that kind reads.  A kind is code: `benchmark/kinds/<kind>.py`, found by
that name (core/spec.py), holds a subclass of `Load` bound to the module
name `LOAD`, which turns the mix's parameters, over a configuration, into
the inputs (from the seed), the program's set-up, the timed steps, the
work they need and the check of what they produced.  A new mix of a kind
that is there adds a data file; a new kind adds a file of its own; no
file here changes.

A load's life in a run (core/harness.py): `make_inputs`, `prepare`,
`warmup` (set-up), then `step` until the window closes, `work` for a
traced stretch, `free`, and `check` once the window has closed.
`control_numbers` gives the check's numbers with the control in the
program's place (benchmark/calibrate.py).  Only the kinds and the
configurations name the program's entry points.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

import torch

M32 = 0xFFFFFFFF

#: what `check` returns: (calls checked, calls failed, {number: (value,
#: limit)})
Checked = Tuple[int, int, Dict[str, Tuple[float, float]]]


def generator(seed: int, device) -> torch.Generator:
    """A torch generator on `device` seeded from the run's seed (which may
    pass 2^63)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def u32_words(g: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform u32 words as int32."""
    return torch.randint(-(1 << 31), 1 << 31, shape, generator=g,
                         device=device, dtype=torch.int64).to(torch.int32)


def canonical_words(modulus: int, n_words: int, n: int, g, device):
    """(n_words, n) int32 u32 words below the modulus: uniform words, the
    top one reduced below the modulus's top word (the reference benches'
    protocol)."""
    w = u32_words(g, (n_words, n), device)
    top = modulus >> (32 * (n_words - 1))
    w[-1] = ((w[-1].to(torch.int64) & M32) % top).to(torch.int32)
    return w


class Load:
    """The seed, the device and the parameters; a kind fills in the rest.
    `rng` (Python) and `gen` (torch, on the device) both start from the
    seed."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.rng = random.Random(seed)
        self.gen = generator(seed, self.device)

    def sources(self) -> List[str]:
        """The program's CUDA sources this load's calls need built."""
        return list(self.traffic.get("sources", []))

    def make_inputs(self) -> None:
        raise NotImplementedError

    def prepare(self) -> None:
        """The program's resident state (set-up)."""

    def warmup(self) -> None:
        """Every shape the window will use, once."""
        raise NotImplementedError

    def step(self) -> int:
        """One step of the timed loop; returns the program calls it made."""
        raise NotImplementedError

    def work(self, calls: int) -> Dict[str, Tuple[float, float]]:
        """{name: (operations, bytes)} that the last `calls` calls needed,
        for the rooflines (core/roofline.py)."""
        return {}

    def free(self) -> None:
        """Drop the program's state before the check."""

    def check(self) -> Checked:
        raise NotImplementedError

    def control_numbers(self) -> Dict[str, float]:
        """The check's numbers with the control in the program's place, on
        this load's inputs."""
        raise NotImplementedError
