"""Kind "transform": `ntt.base_dev` (forward, natural order; `lg_blowup`
0 or absent) or `ntt.lde_dev(..., lg_blowup)` over the configuration's NTT
field, on a ring of `ring` inputs of 2^lg elements drawn on the card;
`batch` calls are dispatched ahead and closed by one synchronise (a step).

Parameters: lg, lg_blowup, ring, batch, trace_steps, sources.  The
field's `word_bytes` sets the program's word layout: 4, a (n,) int32
tensor of u32 words (the 31-bit fields); 8, a (n,) int64 tensor of u64
words (Goldilocks); more, (n32, n) int32 words (the wide fields).

The check: every output of the window's last step at once.  The transform
is linear, so with coefficients c_k drawn from the seed, sum_k c_k out_k
must equal the reference transform (benchmark/reference/ntt.py) of
sum_k c_k x_k word for word; an output wrong in a word makes the sums
differ there (but with probability about 1/p), swapped outputs too.
Linearity also lets the wide fields' Montgomery words be taken as plain
values: both sides carry the same factor R.  The control is the reference
with every product left without its final reduction (kept mod 2^(16 L)),
as a lazily reduced kernel would return it.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

import torch
from torch.profiler import record_function

from benchmark.core import roofline
from benchmark.core.loads import Checked, Load, canonical_words
from benchmark.core.trace import CALL
from benchmark.reference import ntt as ref_ntt
from benchmark.reference.field import (PlainField, limbs_from_u32_words,
                                       limbs_from_u64_words)


class Transform(Load):
    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        f = config["ntt_field"]
        self.field_name = config["program"]["ntt_field"]
        self.p, self.g = int(f["p"], 0), f["generator"]
        self.word_bytes = f["word_bytes"]
        self.lg = traffic["lg"]
        self.lg_blowup = traffic.get("lg_blowup", 0)
        self.batch = traffic["batch"]
        self.outs: List[Tuple[int, torch.Tensor]] = []
        self.calls = 0

    def make_inputs(self) -> None:
        n, ring = 1 << self.lg, []
        n_words = (self.p.bit_length() + 31) // 32
        for _ in range(self.traffic["ring"]):
            w = canonical_words(self.p, n_words, n, self.gen, self.device)
            if self.word_bytes == 4:
                w = w[0]
            elif self.word_bytes == 8:
                w = w.T.contiguous().view(torch.int64).reshape(n)
            ring.append(w)
        self.ring = ring

    def prepare(self) -> None:
        from sppark_tpu_torch import ntt
        self.ntt = ntt

    def call(self, slot: int) -> torch.Tensor:
        x = self.ring[slot]
        with record_function(CALL):
            if self.lg_blowup:
                return self.ntt.lde_dev(self.field_name, x, self.lg,
                                        self.lg_blowup)
            return self.ntt.base_dev(self.field_name, x, self.lg)

    def step(self) -> int:
        """`batch` calls over the ring dispatched ahead, one synchronise;
        the outputs of the last step are kept for the check."""
        self.outs = []
        for _ in range(self.batch):
            slot = self.calls % len(self.ring)
            self.outs.append((slot, self.call(slot)))
            self.calls += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.batch

    def warmup(self) -> None:
        self.step()
        self.outs, self.calls = [], 0

    def free(self) -> None:
        self.ntt = None

    def work(self, calls: int) -> Dict[str, Tuple[float, float]]:
        ops, nbytes = roofline.transform_work(self.config["ntt_field"],
                                              self.lg, self.lg_blowup)
        return {"ntt": (ops * calls, nbytes * calls)}

    # -- the check -----------------------------------------------------------------
    def limbs(self, t: torch.Tensor, s: int = 0, e=None) -> torch.Tensor:
        """(L, e - s) int32 limbs of elements [s, e) of a tensor of the
        program's words."""
        t = t[..., s:e]
        if self.word_bytes == 4:
            return limbs_from_u32_words(t[None])
        if self.word_bytes == 8:
            return limbs_from_u64_words(t)
        return limbs_from_u32_words(t)

    def transform(self, x: torch.Tensor, lazy: bool = False) -> torch.Tensor:
        """The reference transform of the limbs x (the cell's NTT or LDE)."""
        F = PlainField(self.p)
        if self.lg_blowup:
            return ref_ntt.lde(F, self.g, x, self.lg, self.lg_blowup, lazy)
        return ref_ntt.ntt(F, self.g, x, self.lg, lazy=lazy)

    def combine(self, items, coefs, to_limbs) -> torch.Tensor:
        """sum_k coefs[k] items[k] mod p as (L, n) int32 limbs, in chunks;
        `to_limbs(item, s, e)` gives an item's limbs [s, e)."""
        F = PlainField(self.p)
        n = items[0].shape[-1]
        out = torch.empty((F.L, n), dtype=torch.int32, device=self.device)
        consts = [F.const(c, self.device) for c in coefs]
        step = max(1, ref_ntt.CHUNK_LIMBS // F.L)
        for s in range(0, n, step):
            e = min(n, s + step)
            acc = None
            for item, c in zip(items, consts):
                term = F.mul(to_limbs(item, s, e), c)
                acc = term if acc is None else F.add(acc, term)
            out[:, s:e] = acc.to(torch.int32)
        return out

    def coefs(self, k: int) -> List[int]:
        """k nonzero coefficients below p, drawn from the seed."""
        rng = random.Random(self.seed * 7919 + 17)
        return [rng.randrange(1, self.p) for _ in range(k)]

    def check(self, outs=None, to_limbs=None) -> Checked:
        """`words_wrong` counts the words at which the two sums differ; a
        failed check fails every call checked.  `outs` and `to_limbs` put
        other outputs (the control's) in the program's place."""
        outs = self.outs if outs is None else outs
        to_limbs = to_limbs or self.limbs
        if not outs:
            return 0, 0, {}
        c = self.coefs(len(outs))
        x = self.combine([self.ring[s] for s, _ in outs], c, self.limbs)
        want = self.transform(x)
        del x
        got = self.combine([o for _, o in outs], c, to_limbs)
        self.outs = []
        words = int((got != want).any(0).sum()) \
            if got.shape == want.shape else want.shape[1]
        return len(outs), len(outs) if words else 0, \
            {"words_wrong": (words, 0)}

    def control_numbers(self) -> Dict[str, float]:
        slots = [k % len(self.ring) for k in range(self.batch)]
        outs = [(s, self.transform(self.limbs(self.ring[s]), lazy=True))
                for s in slots]
        _, _, numbers = self.check(outs, lambda t, s, e: t[:, s:e])
        return {k: v for k, (v, _) in numbers.items()}


LOAD = Transform
