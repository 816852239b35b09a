"""Radix-2 NTT dataflow on word tensors: the bit-reversal permutation, the
plain Cooley-Tukey stages that the kernels' plain versions run, and the
element ops the NTT takes from each family of fields.

Three families, each with the domain on the last axis:
  * Goldilocks: one int64 word per element, (*batch, n) (ff/gl64.py);
  * the 31-bit Montgomery fields (BabyBear): one int32 word per element,
    (*batch, n) (ff/mont32.py);
  * the wide (multi-limb Montgomery) fields: n32 int32 words per element,
    limb-major (n32, *batch, n) (ff/bigmont.py).
`elem_ops(field)` gives each behind one interface: the field ops (`add`
and `mul` canonical; `addl`, `subl`, `mull` the butterflies'), `lead`
(the number of leading word axes, 0 or 1, which every reshape of the
batch axes keeps in front), the wire converters, `words` (what the
family's tensors hold, for error messages), `rows`/`cols` (the family's
kernels of a row and a column pass, from the given `Kernels`) and
`factored_mid` (whether the middle twiddles stay factored, as the wide
fields keep them, or form one matrix multiplied in the column pass).

`ct_stages` expects bit-reversed input along the last axis and returns
natural order, canonical words.  Goldilocks stages run lazily with one
`canon` at the end, as the gl64 kernels do; the 31-bit and wide stages use
canonical add/sub and Montgomery products (for the wide fields those of
the field kernels they were made with; the plain versions: ff/kernels.PLAIN).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ff import gl64
from ..ff import kernels as FK
from ..ff.bigmont import get_field_ops
from ..ff.mont32 import get_mont32_ops
from ..params import FieldParams, get_field


class Gl64Ops:
    """Goldilocks words: int64, no leading axis, lazy butterflies."""

    lead = 0
    dtype = torch.int64
    factored_mid = False
    words = "int64 Goldilocks words"
    from_wire = staticmethod(gl64.from_wire)
    to_wire = staticmethod(gl64.to_wire)

    def __init__(self, params: FieldParams):
        self.params = params

    add = staticmethod(gl64.add)
    mul = staticmethod(gl64.mul)
    sqr = staticmethod(gl64.sqr)
    const = staticmethod(gl64.const)
    ones = staticmethod(gl64.ones)
    addl = staticmethod(gl64.add_lazy)
    subl = staticmethod(gl64.sub_lazy)
    mull = staticmethod(gl64.mul_lazy)
    canon = staticmethod(gl64.canon)

    @staticmethod
    def rows(kern, x, tw, lg: int, **opt):
        return kern.rows(x, tw, lg, **opt)

    @staticmethod
    def cols(kern, x, tw, lg: int, mid):
        return kern.cols(x, tw, lg, mid)


class Mont32Ops:
    """31-bit Montgomery words: int32, no leading axis, canonical
    throughout (the JAX package's kernels have no lazy mont32 ops)."""

    lead = 0
    dtype = torch.int32
    factored_mid = False
    words = "(*batch, n) int32 words of u32 Montgomery form"

    def __init__(self, params: FieldParams):
        self.params = params
        F = get_mont32_ops(params)
        self.add, self.mul, self.sqr = F.add, F.mul, F.sqr
        self.const, self.ones = F.const, F.ones
        self.addl, self.subl, self.mull = F.add, F.sub, F.mul
        self.from_wire, self.to_wire = F.from_wire_np, F.to_wire_np

    #: the words are canonical already; a copy, as gl64.canon returns one
    canon = staticmethod(torch.clone)

    def rows(self, kern, x, tw, lg: int, **opt):
        return kern.mont32_rows(self.params.name, x, tw, lg, **opt)

    def cols(self, kern, x, tw, lg: int, mid):
        return kern.mont32_cols(self.params.name, x, tw, lg, mid)


class WideOps:
    """Multi-limb Montgomery words: (n32, *batch) int32, canonical
    throughout, products through the given field kernels."""

    lead = 1
    dtype = torch.int32
    factored_mid = True

    def __init__(self, params: FieldParams, fk: FK.FieldKernels):
        self.params = params
        F = get_field_ops(params, fk)
        self.add, self.mul, self.sqr = F.add, F.mul, F.sqr
        self.const, self.ones = F.const, F.ones
        self.addl, self.subl, self.mull = F.add, F.sub, F.mul
        self.from_wire, self.to_wire = F.from_wire_np, F.to_wire_np
        self.words = f"({F.n32}, *batch, n) int32 Montgomery words"

    #: the words are canonical already; a copy, as gl64.canon returns one
    canon = staticmethod(torch.clone)

    def rows(self, kern, x, tw, lg: int, **opt):
        return kern.wide_rows(self.params.name, x, tw, lg, **opt)

    def cols(self, kern, x, tw, lg: int, mid):
        """The column pass, then the factored middle twiddles (A, B) in a
        pass of their own."""
        name = self.params.name
        return kern.wide_mid(name, kern.wide_cols(name, x, tw, lg), *mid)


@functools.lru_cache(maxsize=None)
def elem_ops(field: str, fk: FK.FieldKernels = FK.KERNELS):
    """The element ops of an NTT field: Gl64Ops for the Goldilocks fields,
    Mont32Ops for the 31-bit fields, WideOps (with the field kernels `fk`)
    for the others."""
    params = get_field(field)
    if params.modulus == gl64.P:
        return Gl64Ops(params)
    if params.bits <= 32:
        return Mont32Ops(params)
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


def ntt_nn(E, x: torch.Tensor, lg_n: int, tw: torch.Tensor) -> torch.Tensor:
    """Natural-in natural-out NTT along the last axis: the bit reversal,
    then `ct_stages`."""
    return ct_stages(E, bit_reverse(x, lg_n), lg_n, tw)
