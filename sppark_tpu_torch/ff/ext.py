"""Extension fields: the quadratic extension F_p^2 = F_p[u]/(u^2 - nr)
over a multi-limb Montgomery field, the port of
sppark_tpu/ff/ext.py:Fp2Field and the coordinate field of the G2 curves;
and BabyBear4Field, the quartic extension of BabyBear (below).

An element is ONE tensor of `(2 n32, *batch)` int32 words: c0's n32
Montgomery words, then c1's.  Over a one-word field (ff/lane.py: the
Goldilocks words of test_gl64_g2) it is `(2, *batch)`, c0's word then
c1's, with no kernel on any device, as the JAX package runs that tower.  That is the TPU kernels' stacked-plane order
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

import numpy as np
import torch

from ..params import Fp2Params
from . import inversion
from .bigmont import BigMontField, wire_to_words, words_to_wire
from .kernels import KERNELS, FieldKernels, add_small_multiple
from .lane import get_base_ops
from .mont32 import Mont32Field, get_mont32_ops


class Fp2Field:
    """Fp2 ops over (2 n32, *batch) int32 words, Montgomery form."""

    def __init__(self, params: Fp2Params, kern: FieldKernels = KERNELS):
        self.params = params
        self.base = get_base_ops(params.base, kern)
        self.p = self.base.p
        #: tensor rows per coefficient (n32 over a multi-limb field)
        self.n32 = self.base.rows
        #: 32-bit words per element, and its tensor rows
        self.words = 2 * self.base.words
        self.rows = 2 * self.n32
        self.dtype = self.base.dtype
        #: the base field's kernels serve the card's batch inversion
        self._kernels = isinstance(self.base, BigMontField)
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

    def _plus_nr(self, t0, t1, sign: int = 1):
        """t0 + sign * nr * t1 over base-field words, by additions."""
        k = sign * self.nr
        if self._kernels:
            return add_small_multiple(t0, t1, k, self.base.params)
        B, m, run = self.base, None, t1
        for bit in bin(abs(k))[:1:-1]:          # double and add, LSB first
            if bit == "1":
                m = run if m is None else B.add(m, run)
            run = B.add(run, run)
        return B.sub(t0, m) if k < 0 else B.add(t0, m)

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
        return torch.zeros((self.rows,) + tuple(batch_shape),
                           dtype=self.dtype, device=device)

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

    def _batch_inv_dev(self, x):
        """On the card: ONE degree-2 call of the field kernels' batch_inv
        (the norm, its inversion and the conjugate multiply in three
        launches, ff/kernels.py:mont_batch_inv)."""
        return self.base.kern.batch_inv(x, self.base.params, 2, self.nr)

    def inv(self, x):
        """1 / a through the norm map, the norm inverted by the base field's
        inv; 0 -> 0."""
        return self._inv_by_norm(x, self.base.inv)

    def batch_inv(self, x):
        """Inversion of every lane through the norm map, zero lanes giving
        zero: on the card `_batch_inv_dev`, on the CPU the base field's
        prefix/suffix batch inversion along the last axis."""
        if x.device.type != "cpu" and self._kernels:
            return self._batch_inv_dev(x)
        return self._inv_by_norm(x, self.base.batch_inv)

    def batch_inv_tree(self, x):
        """Inversion along the last axis with the contract of
        sppark_tpu/ff/ext.py:Fp2Field.batch_inv_tree (a power-of-two axis,
        non-zero inputs): on the card `_batch_inv_dev`, on the CPU through
        the norm map and the base field's product tree."""
        if x.device.type != "cpu" and self._kernels:
            inversion.check_pow2(x.shape[-1])
            return self._batch_inv_dev(x)
        return self._inv_by_norm(x, self.base.batch_inv_tree)

    # -- host conversion -----------------------------------------------------------
    def one_wire_int(self) -> tuple:
        """The wire ints of 1 as a (c0, c1) pair."""
        return (self.base.one_wire_int(), 0)

    def rand_ints(self, rng, n: int) -> List[tuple]:
        """n uniform (c0, c1) pairs, c0 drawn from `rng` before c1."""
        return [(rng.randrange(self.p), rng.randrange(self.p))
                for _ in range(n)]

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
        """Wire (*shape, 2 n32) u32 words, c0 || c1 -> (2 n32, *shape);
        over a one-word field (*shape, 2) words, c0 || c1."""
        if self._kernels:
            return wire_to_words(arr, self.words, device)
        a = np.asarray(arr)
        return torch.cat([self.base.from_wire_np(
            np.ascontiguousarray(a[..., k]), device) for k in (0, 1)])

    def to_wire_np(self, t: torch.Tensor):
        """(2 n32, *shape) words -> (*shape, 2 n32) wire words."""
        if self._kernels:
            return words_to_wire(t)
        return np.stack([self.base.to_wire_np(c) for c in t.chunk(2)], -1)


@functools.lru_cache(maxsize=None)
def get_fp2_ops(params: Fp2Params, kern: FieldKernels = KERNELS
                ) -> Fp2Field:
    """The cached Fp2Field of an extension, with the given field kernels."""
    return Fp2Field(params, kern)


class BabyBear4Field:
    """F_p[x]/(x^4 - beta) over BabyBear, beta = 11 (canonical) or -11
    (RISC Zero): the port of sppark_tpu/ff/ext.py:BabyBear4Field (bb31_4_t,
    ff/baby_bear.hpp).

    An element is ONE `(4, *batch)` int32 tensor of Montgomery words,
    coefficient axis first, as Fp2Field keeps its pair axis first; the
    base field's ops run on it elementwise.  Plain PyTorch: the JAX package
    has no kernel here either.  Inverses go through the norm tower: with
    y = x^2, a = A + B x, A = c0 + c2 y, B = c1 + c3 y, the subfield norm
    N = A^2 - y B^2 and its prime-field norm are inverted, then a^-1 = (A -
    B x) N^-1.  Inputs are canonical and so is every output."""

    degree = 4

    def __init__(self, canonical: bool = True, base: Mont32Field = None):
        self.base = base or get_mont32_ops("baby_bear")
        self.beta_int = 11 if canonical else self.base.p - 11

    def _beta(self, like):
        return self.base.const(self.beta_int, (1,) * (like.ndim - 1),
                               like.device)

    # -- ring ops ----------------------------------------------------------------
    def add(self, a, b):
        return self.base.add(a, b)

    def sub(self, a, b):
        return self.base.sub(a, b)

    def neg(self, a):
        return self.base.neg(a)

    def mul(self, a, b):
        """c_k = sum_{i+j=k} a_i b_j + beta sum_{i+j=k+4} a_i b_j; the 16
        products in one base-field call."""
        F = self.base
        a, b = torch.broadcast_tensors(a, b)
        m = F.mul(a[:, None], b[None, :])          # m[i, j] = a_i b_j

        def s(*ij):
            acc = m[ij[0]]
            for k in ij[1:]:
                acc = F.add(acc, m[k])
            return acc

        hi = torch.stack([s((1, 3), (2, 2), (3, 1)), s((2, 3), (3, 2)),
                          m[3, 3]])
        hi = F.mul(hi, self._beta(a))
        return torch.stack([F.add(m[0, 0], hi[0]),
                            F.add(s((0, 1), (1, 0)), hi[1]),
                            F.add(s((0, 2), (1, 1), (2, 0)), hi[2]),
                            s((0, 3), (1, 2), (2, 1), (3, 0))])

    def sqr(self, a):
        return self.mul(a, a)

    def select(self, cond, a, b):
        """Lane-wise select; `cond` is a bool tensor over the batch shape."""
        return torch.where(cond, a, b)

    def is_zero(self, a):
        return (a == 0).all(dim=0)

    def eq(self, a, b):
        return (a == b).all(dim=0)

    # -- constants ---------------------------------------------------------------
    def zeros(self, batch_shape, device=None):
        return torch.zeros((4,) + tuple(batch_shape), dtype=torch.int32,
                           device=device)

    def ones(self, batch_shape=(), device=None):
        z = self.zeros(batch_shape, device)
        z[0] = self.base.const(1, batch_shape, device)
        return z

    # -- inversion -----------------------------------------------------------------
    def _sub_mul(self, p, q, beta):
        """(p0 + p1 y)(q0 + q1 y) over F_p[y]/(y^2 - beta), on (2, *b)."""
        F = self.base
        m = F.mul(torch.stack([p[0], p[0], p[1], p[1]]),
                  torch.stack([q[0], q[1], q[1], q[0]]))
        return torch.stack([F.add(m[0], F.mul(beta, m[2])),
                            F.add(m[1], m[3])])

    def _inv_by_norm(self, a, base_inv):
        F = self.base
        beta = self._beta(a)[0]
        A, B = a[0::2], a[1::2]                    # (c0, c2), (c1, c3)
        A2, B2 = self._sub_mul(A, A, beta), self._sub_mul(B, B, beta)
        N = F.sub(A2, torch.stack([F.mul(beta, B2[1]), B2[0]]))
        sq = F.mul(N, N)
        ninv = base_inv(F.sub(sq[0], F.mul(beta, sq[1])))
        Ninv = F.mul(N, ninv)
        Ninv = torch.stack([Ninv[0], F.neg(Ninv[1])])
        Ai, Bi = self._sub_mul(A, Ninv, beta), self._sub_mul(B, Ninv, beta)
        return torch.stack([Ai[0], F.neg(Bi[0]), Ai[1], F.neg(Bi[1])])

    def inv(self, a):
        """a^-1 through the norm tower; zero gives zero."""
        return self._inv_by_norm(a, self.base.inv)

    def batch_inv(self, a):
        """Inversion along the last axis with ONE base-field batch inversion
        of the norms (ff/baby_bear.hpp:602-633); zero lanes give zero."""
        return self._inv_by_norm(a, self.base.batch_inv)

    def batch_inv_tree(self, a):
        """The same through the base field's product tree: a power-of-two
        axis, non-zero inputs."""
        return self._inv_by_norm(a, self.base.batch_inv_tree)

    # -- host conversion -----------------------------------------------------------
    def one_wire_int(self) -> tuple:
        """The wire ints of 1 as its four coefficients."""
        return (self.base.one_wire_int(), 0, 0, 0)

    def rand_ints(self, rng, n: int) -> List[tuple]:
        """n uniform elements as four canonical coefficients each, drawn
        from `rng` in order."""
        return [tuple(rng.randrange(self.base.p) for _ in range(4))
                for _ in range(n)]

    def from_int_list(self, values: Iterable, batch_shape=None,
                      device=None) -> torch.Tensor:
        """Canonical 4-tuples of ints -> (4, n), or (4, *batch_shape)."""
        values = list(values)
        return torch.stack([self.base.from_int_list([v[k] for v in values],
                                                    batch_shape, device)
                            for k in range(4)])

    def to_int_list(self, t: torch.Tensor) -> List[tuple]:
        return list(zip(*(self.base.to_int_list(c) for c in t)))

    def from_jax(self, coeffs, device=None) -> torch.Tensor:
        """The JAX package's 4-tuple of uint32 arrays -> (4, *batch)."""
        return torch.stack([self.base.from_wire_np(c, device)
                            for c in coeffs])

    def to_jax(self, t: torch.Tensor):
        return tuple(self.base.to_wire_np(c) for c in t)
