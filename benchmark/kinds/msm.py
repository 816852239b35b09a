"""Kind "msm": `MSMContext(curve, 2^lg, mode=...)` over 2^lg_base random
points of the r-torsion, the base points at `infinity_at` set to infinity,
tiled to 2^lg and resident on the card (sppark's msm-cuda bench,
src/util.rs: `points[3] = zero` on the base, then the base repeated), and
a ring of `ring` scalar sets drawn on the card; one caller invokes in a
closed loop, a set at a time.

Parameters: lg, lg_base, infinity_at (indices into the base), ring, mode,
wbits (the signed window of the madd count), trace_steps, sources, and
`context_wbits`, the window size handed to MSMContext (absent, as in every
cell: the program's own policy; the CPU tests set it to keep the plain
path short).

The check: every invoke of the window against the reference MSM of its
scalar set (benchmark/reference/ec.py).  Point i is base[i mod 2^lg_base],
so the MSM is sum_j c_j base[j] with c_j the sum of the scalars of the
points i = j mod 2^lg_base, summed on the card in int64.  The control
keeps only the scalars' low CONTROL_BITS bits (the top window dropped).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.profiler import record_function

from benchmark.core import roofline
from benchmark.core.loads import M32, Checked, Load, canonical_words
from benchmark.core.trace import CALL
from benchmark.reference.ec import Curve

#: the scalar bits the control keeps
CONTROL_BITS = 240


class _Point:
    """An affine point as the program's `affine_from_ints` reads one."""

    def __init__(self, x, y):
        self.x, self.y, self.inf = x, y, False


class MSM(Load):
    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        cv = config["curve"]
        self.curve = Curve(int(cv["p"], 0), cv["b"], int(cv["r"], 0),
                           int(cv["h_eff"], 0))
        self.n = 1 << traffic["lg"]
        self.nbase = 1 << min(traffic["lg_base"], traffic["lg"])
        self.infinity = sorted(set(traffic.get("infinity_at", [])))
        self.n_words = (self.curve.r.bit_length() + 31) // 32
        self.results: List[Tuple[int, tuple]] = []
        self.calls = 0

    def make_inputs(self) -> None:
        """The base points (host; None at infinity) and the ring of scalar
        sets (card)."""
        self.base = self.curve.random_points(self.rng, self.nbase)
        for i in self.infinity:
            self.base[i] = None
        self.scalars = [canonical_words(self.curve.r, self.n_words, self.n,
                                        self.gen, self.device)
                        for _ in range(self.traffic["ring"])]

    def prepare(self) -> None:
        """The program's context and its resident points: the base, its
        points at infinity zeroed, tiled on the card."""
        from sppark_tpu_torch.ec import get_curve_ops
        from sppark_tpu_torch.msm import MSMContext

        name = self.config["program"]["curve"]
        ops = get_curve_ops(name)
        some = next(q for q in self.base if q is not None)
        bx, by = ops.affine_from_ints(
            [_Point(*(q or some)) for q in self.base], self.device)
        bx[:, self.infinity] = 0
        by[:, self.infinity] = 0
        reps = self.n // self.nbase
        px, py = bx.repeat(1, reps), by.repeat(1, reps)
        self.ctx = MSMContext(name, self.n,
                              wbits=self.traffic.get("context_wbits", 0),
                              mode=self.traffic["mode"],
                              device=self.device)
        self.ctx.set_points((px, py))
        del bx, by, px, py

    def call(self, slot: int):
        with record_function(CALL):
            return self.ctx.invoke(self.scalars[slot])

    def step(self) -> int:
        slot = self.calls % len(self.scalars)
        pt = self.call(slot)
        self.results.append((slot, (pt.x, pt.y, bool(pt.inf))))
        self.calls += 1
        return 1

    def warmup(self) -> None:
        self.call(0)

    def free(self) -> None:
        self.ctx = None

    def work(self, calls: int) -> Dict[str, Tuple[float, float]]:
        """The madds the last `calls` invokes needed, and their bytes: the
        point row (x, y) and its 4-byte slot index a madd."""
        n32 = self.config["program"]["base_n32"]
        madds = 0
        for slot, _ in self.results[-calls:]:
            madds += roofline.msm_madds(self.scalars[slot], self.curve.r,
                                        self.traffic["wbits"],
                                        self.infinity, self.nbase)
        return {"msm_madd": (madds * roofline.madd_ops(n32),
                             madds * (8 * n32 + 4))}

    # -- the check -----------------------------------------------------------------
    def class_scalars(self, words: torch.Tensor, bits: int = 0) -> List[int]:
        """c_j, the sum of the scalars of the points i = j mod nbase.
        `bits` keeps only the low bits of each scalar (the control)."""
        w = words.to(torch.int64) & M32
        if bits:
            for i in range(w.shape[0]):
                keep = max(0, min(32, bits - 32 * i))
                w[i] &= (1 << keep) - 1
        sums = w.reshape(w.shape[0], -1, self.nbase).sum(1).cpu().tolist()
        return [sum(sums[k][j] << (32 * k) for k in range(len(sums)))
                % self.curve.r for j in range(self.nbase)]

    def reference(self, slot: int, bits: int = 0):
        q = self.curve.msm(self.base, self.class_scalars(self.scalars[slot],
                                                         bits))
        return (0, 0, True) if q is None else (q[0], q[1], False)

    def check(self) -> Checked:
        """Every invoke of the window against the reference MSM of its
        scalar set."""
        want = {s: self.reference(s) for s in sorted({s for s, _ in
                                                      self.results})}
        wrong = sum(1 for s, got in self.results if got != want[s])
        return len(self.results), wrong, {"points_wrong": (wrong, 0)}

    def control_numbers(self) -> Dict[str, float]:
        wrong = sum(self.reference(s, bits=CONTROL_BITS) != self.reference(s)
                    for s in range(len(self.scalars)))
        return {"points_wrong": wrong}


LOAD = MSM
