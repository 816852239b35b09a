"""The quadratic extension F_p^2 = F_p[u]/(u^2 - nr) over a multi-limb
Montgomery field: the port of sppark_tpu/ff/ext.py:Fp2Field, the
coordinate field of the G2 curves.

An element is ONE tensor of `(2 n32, *batch)` int32 words: c0's n32
Montgomery words, then c1's.  That is the TPU kernels' stacked-plane order
(sppark_tpu/ec/pallas_ops.py:_KCtx, c0 || c1) and the wire order c0 || c1
of a G2 coordinate, so the point kernels' strided views, the MSM slab's
point-major rows (x0 || x1 || y0 || y1) and the wire converters carry over
with 2 n32 words per coordinate.  The zero tests and selects of the point
ops read the whole element at once: infinity is every word zero.

The base field's ops run on a pair axis, `(n32, 2, *batch)` or `(n32, 3,
*batch)`, so the three products of a Karatsuba multiply are ONE call of
the base field's mul (one bigmont_ew launch on the card), and the
nonresidue, a small signed integer (-1, -5 or 7), is applied by additions.
Inputs are canonical and so is every output, so any order of the same
modular operations gives the JAX package's words exactly.
"""

from __future__ import annotations

import functools
from typing import Iterable, List

import torch

from ..params import Fp2Params
from .bigmont import get_field_ops, wire_to_words, words_to_wire
from .kernels import KERNELS, FieldKernels


class Fp2Field:
    """Fp2 ops over (2 n32, *batch) int32 words, Montgomery form."""

    def __init__(self, params: Fp2Params, kern: FieldKernels = KERNELS):
        self.params = params
        self.base = get_field_ops(params.base, kern)
        self.p = self.base.p
        self.n32 = self.base.n32
        #: int32 words per element
        self.words = 2 * self.n32
        #: u^2, a small signed integer
        self.nr = params.nr_small

    # -- layout --------------------------------------------------------------------
    def _pair(self, x):
        """(2 n32, *b) -> the (n32, 2, *b) view: coefficient on axis 1."""
        return x.reshape((2, self.n32) + tuple(x.shape[1:])).movedim(0, 1)

    @staticmethod
    def _unpair(y):
        """(n32, k, *b) -> (k n32, *b): coefficient k's words after k-1's."""
        y = y.movedim(1, 0)
        return y.reshape((y.shape[0] * y.shape[1],) + tuple(y.shape[2:]))

    # -- ring ops ----------------------------------------------------------------
    def add(self, x, y):
        x, y = torch.broadcast_tensors(x, y)
        return self._unpair(self.base.add(self._pair(x), self._pair(y)))

    def sub(self, x, y):
        x, y = torch.broadcast_tensors(x, y)
        return self._unpair(self.base.sub(self._pair(x), self._pair(y)))

    def neg(self, x):
        return self._unpair(self.base.neg(self._pair(x)))

    def _nr_times(self, t):
        """|nr| * t by doubling and adding."""
        B, k = self.base, abs(self.nr)
        acc, run = None, t
        while k:
            if k & 1:
                acc = run if acc is None else B.add(acc, run)
            k >>= 1
            if k:
                run = B.add(run, run)
        return acc

    def _plus_nr(self, t0, t1, sign: int = 1):
        """t0 + sign * nr * t1 over base-field words."""
        m = self._nr_times(t1)
        return self.base.add(t0, m) if sign * self.nr > 0 else \
            self.base.sub(t0, m)

    def mul(self, x, y):
        """Karatsuba: c0 = a0 b0 + nr a1 b1, c1 = (a0 + a1)(b0 + b1) - a0 b0
        - a1 b1; the three products in one base-field call."""
        B = self.base
        x, y = torch.broadcast_tensors(x, y)
        a, b = self._pair(x), self._pair(y)
        s = B.add(torch.stack([a[:, 0], b[:, 0]], 1),
                  torch.stack([a[:, 1], b[:, 1]], 1))
        t = B.mul(torch.cat([a, s[:, :1]], 1), torch.cat([b, s[:, 1:]], 1))
        t0, t1, m = t[:, 0], t[:, 1], t[:, 2]
        return torch.cat([self._plus_nr(t0, t1), B.sub(B.sub(m, t0), t1)])

    def sqr(self, x):
        """c0 = a0^2 + nr a1^2, c1 = 2 a0 a1: two squarings and a product
        in one base-field call (a product of equal factors is the same
        canonical square)."""
        B = self.base
        a = self._pair(x)
        t = B.mul(torch.cat([a, a[:, :1]], 1), torch.cat([a, a[:, 1:]], 1))
        t0, t1, m = t[:, 0], t[:, 1], t[:, 2]
        return torch.cat([self._plus_nr(t0, t1), B.add(m, m)])

    def select(self, cond, x, y):
        """Lane-wise select; `cond` is a bool tensor over the batch shape."""
        return torch.where(cond, x, y)

    def is_zero(self, x):
        return (x == 0).all(dim=0)

    def eq(self, x, y):
        return (x == y).all(dim=0)

    # -- constants ---------------------------------------------------------------
    def zeros(self, batch_shape, device=None):
        return torch.zeros((self.words,) + tuple(batch_shape),
                           dtype=torch.int32, device=device)

    def const(self, value: int, batch_shape=(), device=None):
        """A canonical base-field int embedded as (value, 0), broadcast in
        Montgomery form."""
        return torch.cat([self.base.const(value, batch_shape, device),
                          self.base.const(0, batch_shape, device)])

    def ones(self, batch_shape=(), device=None):
        return self.const(1, batch_shape, device)

    # -- inversion -----------------------------------------------------------------
    def _inv_by_norm(self, x, base_inv):
        """1 / a = conj(a) / (a0^2 - nr a1^2), the norms inverted by
        `base_inv`, one base-field batch inversion
        (ff/alt_bn128-fp2.hpp:135-144)."""
        B = self.base
        a = self._pair(x)
        sq = B.mul(a, a)
        ninv = base_inv(self._plus_nr(sq[:, 0], sq[:, 1], sign=-1))
        r = B.mul(a, ninv[:, None])
        return torch.cat([r[:, 0], B.neg(r[:, 1])])

    def batch_inv(self, x):
        """Inversion along the last axis through the norm map and the base
        field's prefix/suffix batch inversion; zero lanes give zero."""
        return self._inv_by_norm(x, self.base.batch_inv)

    def batch_inv_tree(self, x):
        """Inversion along the last axis through the norm map and the base
        field's product tree (the port of sppark_tpu/ff/ext.py:
        Fp2Field.batch_inv_tree): a power-of-two axis, non-zero inputs."""
        return self._inv_by_norm(x, self.base.batch_inv_tree)

    # -- host conversion -----------------------------------------------------------
    def from_int_list(self, values: Iterable, batch_shape=None,
                      device=None) -> torch.Tensor:
        """Canonical (c0, c1) int pairs -> Montgomery words (2 n32, n), or
        (2 n32, *batch_shape)."""
        values = list(values)
        return torch.cat([self.base.from_int_list([v[k] for v in values],
                                                  batch_shape, device)
                          for k in (0, 1)])

    def to_int_list(self, t: torch.Tensor) -> List[tuple]:
        """Montgomery words -> canonical (c0, c1) pairs, lanes in flattened
        order."""
        c0, c1 = t.chunk(2)
        return list(zip(self.base.to_int_list(c0), self.base.to_int_list(c1)))

    def from_wire_np(self, arr, device=None) -> torch.Tensor:
        """Wire (*shape, 2 n32) u32 words, c0 || c1 -> (2 n32, *shape)."""
        return wire_to_words(arr, self.words, device)

    def to_wire_np(self, t: torch.Tensor):
        """(2 n32, *shape) words -> (*shape, 2 n32) wire words."""
        return words_to_wire(t)


@functools.lru_cache(maxsize=None)
def get_fp2_ops(params: Fp2Params, kern: FieldKernels = KERNELS
                ) -> Fp2Field:
    """The cached Fp2Field of an extension, with the given field kernels."""
    return Fp2Field(params, kern)
