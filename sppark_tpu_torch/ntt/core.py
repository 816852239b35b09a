"""Radix-2 NTT dataflow on word tensors: the bit-reversal permutation, the
plain Cooley-Tukey stages that the kernels' plain versions run, and the
element ops the NTT takes from each family of fields.

Two layouts, both with the domain on the last axis:
  * Goldilocks: one int64 word per element, (*batch, n) (ff/gl64.py);
  * the wide (multi-limb Montgomery) fields: n32 int32 words per element,
    limb-major (n32, *batch, n) (ff/bigmont.py).
`elem_ops(field)` gives either behind one interface; its `lead` is the
number of leading word axes (0 or 1), which every reshape of the batch
axes keeps in front.

`ct_stages` expects bit-reversed input along the last axis and returns
natural order, canonical words.  Goldilocks stages run lazily with one
`canon` at the end, as the gl64 kernels do; the wide stages use canonical
add/sub and the Montgomery product of the field kernels they were made
with (the plain versions: ff/kernels.PLAIN).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ff import gl64
from ..ff import kernels as FK
from ..ff.bigmont import get_field_ops
from ..params import FieldParams, get_field


class Gl64Ops:
    """Goldilocks words: int64, no leading axis, lazy butterflies."""

    lead = 0
    wide = False
    dtype = torch.int64

    def __init__(self, params: FieldParams):
        self.params = params

    mul = staticmethod(gl64.mul)
    sqr = staticmethod(gl64.sqr)
    const = staticmethod(gl64.const)
    ones = staticmethod(gl64.ones)
    addl = staticmethod(gl64.add_lazy)
    subl = staticmethod(gl64.sub_lazy)
    mull = staticmethod(gl64.mul_lazy)
    canon = staticmethod(gl64.canon)


class WideOps:
    """Multi-limb Montgomery words: (n32, *batch) int32, canonical
    throughout, products through the given field kernels."""

    lead = 1
    wide = True
    dtype = torch.int32

    def __init__(self, params: FieldParams, fk: FK.FieldKernels):
        self.params = params
        F = get_field_ops(params, fk)
        self.mul, self.sqr, self.const, self.ones = F.mul, F.sqr, F.const, \
            F.ones
        self.addl, self.subl, self.mull = F.add, F.sub, F.mul

    #: the words are canonical already; a copy, as gl64.canon returns one
    canon = staticmethod(torch.clone)


@functools.lru_cache(maxsize=None)
def elem_ops(field: str, fk: FK.FieldKernels = FK.KERNELS):
    """The element ops of an NTT field: Gl64Ops for the Goldilocks fields,
    WideOps (with the field kernels `fk`) for the others."""
    params = get_field(field)
    if params.modulus == gl64.P:
        return Gl64Ops(params)
    return WideOps(params, fk)


@functools.lru_cache(maxsize=None)
def bitrev_indices(lg_n: int) -> np.ndarray:
    n = 1 << lg_n
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(lg_n):
        rev |= ((idx >> b) & 1) << (lg_n - 1 - b)
    return rev


def bit_reverse(x: torch.Tensor, lg_n: int) -> torch.Tensor:
    """Bit-reverse permutation along the last axis."""
    idx = torch.from_numpy(bitrev_indices(lg_n)).to(x.device)
    return x.index_select(-1, idx)


def ct_stages(E, x: torch.Tensor, lg_n: int, tw: torch.Tensor) -> torch.Tensor:
    """All lg_n CT stages along the last axis of x, with the element ops E.
    `tw` is the power table [w^0 .. w^(n/2 - 1)] ((n32, n/2) words for a
    wide field); stage s takes its 2^(s-1) twiddles as the stride-2^(lg-s)
    slice."""
    n = 1 << lg_n
    lead = x.shape[:-1]
    ones = (1,) * (x.ndim - E.lead)         # stage axes + batch axes
    for s in range(1, lg_n + 1):
        half = 1 << (s - 1)
        v = x.reshape(lead + (n >> s, 2, half))
        lo, hi = v[..., 0, :], v[..., 1, :]
        w = tw[..., :: 1 << (lg_n - s)]
        w = w.reshape(w.shape[:E.lead] + ones + (half,))
        t = E.mull(hi, w)
        x = torch.stack([E.addl(lo, t), E.subl(lo, t)],
                        dim=-2).reshape(lead + (n,))
    return E.canon(x)
