"""The one-word fields as coordinate fields of the test curves: Goldilocks
(ff/gl64.py, canonical int64 words) under test_gl64 and test_gl64_g2, and
the 31-bit fields (ff/mont32.py, int32 Montgomery words) under toy_bb31.

The point ops (ec/core.py) and the MSM stages take a coordinate as
`(W, *batch)` words; here W = 1, one int64 or int32 word a lane, and each
op is the one-word field's own, elementwise.  `get_base_ops` picks the
coordinate field of a FieldParams: this one for Goldilocks' canonical
words and the 31-bit primes, else the multi-limb Montgomery field
(ff/bigmont.py).  These fields have no kernel on any device: the JAX
package sends them through no Pallas kernel either
(sppark_tpu/ec/pallas_ops.py: use_fused_madd takes BigMont fields only).
"""

from __future__ import annotations

import functools
from typing import Iterable, List

import numpy as np
import torch

from ..params import FieldParams, get_field
from . import gl64, inversion
from .bigmont import get_field_ops
from .kernels import KERNELS, FieldKernels
from .mont32 import get_mont32_ops


def is_lane_field(params: FieldParams) -> bool:
    """Goldilocks on its canonical words, or a prime below 2^31."""
    return (params.modulus == gl64.P and not params.montgomery_wire) or \
        params.bits <= 31


class _Gl64:
    """ff/gl64.py's functions with the one-word field face LaneField
    reads."""

    dtype = torch.int64
    words = 2

    def __init__(self, params: FieldParams):
        self.params = params
        self.p = gl64.P

    add, sub, neg, mul, sqr = (staticmethod(f) for f in (
        gl64.add, gl64.sub, gl64.neg, gl64.mul, gl64.sqr))

    @staticmethod
    def inv(x):
        return gl64.inv(x)

    @staticmethod
    def const(value: int, shape=(), device=None):
        return gl64.const(value, shape, device)

    @staticmethod
    def from_ints(values, device=None):
        return gl64.from_ints(values, device)

    @staticmethod
    def to_ints(t) -> List[int]:
        return gl64.to_ints(t.contiguous())

    @staticmethod
    def from_wire(arr, device=None):
        return gl64.from_wire(arr, device)

    @staticmethod
    def to_wire(t):
        return gl64.to_wire(t.contiguous())


class _Mont32:
    """A 31-bit field (ff/mont32.py) with the face LaneField reads."""

    dtype = torch.int32
    words = 1

    def __init__(self, params: FieldParams):
        self.f = get_mont32_ops(params)
        self.params = params
        self.p = params.modulus
        for name in ("add", "sub", "neg", "mul", "sqr", "inv"):
            setattr(self, name, getattr(self.f, name))

    def const(self, value: int, shape=(), device=None):
        return self.f.const(value, shape, device)

    def from_ints(self, values, device=None):
        return self.f.from_int_list(values, device=device)

    def to_ints(self, t) -> List[int]:
        return self.f.to_int_list(t)

    def from_wire(self, arr, device=None):
        return self.f.from_wire_np(arr, device)

    def to_wire(self, t):
        return self.f.to_wire_np(t.contiguous())


class LaneField:
    """A one-word field's ops over (1, *batch) words, the face of
    BigMontField that the point ops use."""

    #: tensor rows per element
    rows = 1

    def __init__(self, params: FieldParams):
        self.params = params
        self.f = _Gl64(params) if params.modulus == gl64.P else \
            _Mont32(params)
        self.p = params.modulus
        #: 32-bit words per element
        self.words = self.f.words
        self.dtype = self.f.dtype

    # -- ring ops ----------------------------------------------------------------
    def add(self, x, y):
        return self.f.add(x, y)

    def sub(self, x, y):
        return self.f.sub(x, y)

    def neg(self, x):
        return self.f.neg(x)

    def mul(self, x, y):
        return self.f.mul(x, y)

    def sqr(self, x):
        return self.f.sqr(x)

    def select(self, cond, x, y):
        return torch.where(cond, x, y)

    def is_zero(self, x):
        return (x == 0).all(dim=0)

    def eq(self, x, y):
        return (x == y).all(dim=0)

    # -- constants ---------------------------------------------------------------
    def zeros(self, batch_shape, device=None):
        return torch.zeros((1,) + tuple(batch_shape), dtype=self.dtype,
                           device=device)

    def const(self, value: int, batch_shape=(), device=None):
        return self.f.const(value, (1,) + tuple(batch_shape), device)

    def ones(self, batch_shape=(), device=None):
        return self.const(1, batch_shape, device)

    # -- inversion -----------------------------------------------------------------
    def inv(self, x):
        """Fermat inversion; 0 -> 0."""
        return self.f.inv(x)

    def batch_inv(self, x):
        """Prefix/suffix inversion along the last axis, zero lanes giving
        zero (ff/inversion.py)."""
        return inversion.batch_inv(self.mul, self.inv, x, x == 0,
                                   self.ones(x.shape[1:], x.device))

    def batch_inv_tree(self, x):
        """Product-tree inversion along a power-of-two last axis of
        non-zero lanes (ff/inversion.py)."""
        return inversion.batch_inv_tree(self.mul, self.inv, x)

    # -- host conversion -----------------------------------------------------------
    def one_wire_int(self) -> int:
        """The wire int of 1: the Montgomery one where the wire words are
        Montgomery words, else 1."""
        return self.params.one_mont if self.params.montgomery_wire else 1

    def rand_ints(self, rng, n: int) -> List[int]:
        """n uniform canonical ints, one draw of `rng` (a random.Random)
        each."""
        return [rng.randrange(self.p) for _ in range(n)]

    def from_int_list(self, values: Iterable[int], batch_shape=None,
                      device=None) -> torch.Tensor:
        """Canonical ints -> (1, n) words, or (1, *batch_shape)."""
        t = self.f.from_ints([v % self.p for v in values], device)
        shape = tuple(batch_shape) if batch_shape is not None else (-1,)
        return t.reshape((1,) + shape)

    def to_int_list(self, t: torch.Tensor) -> List[int]:
        """Words -> canonical ints, lanes in flattened order."""
        return self.f.to_ints(t.detach().cpu().reshape(-1))

    def from_wire_np(self, arr: np.ndarray, device=None) -> torch.Tensor:
        """Wire (*shape) words (u64 for Goldilocks, u32 for the 31-bit
        fields) -> (1, *shape)."""
        return self.f.from_wire(arr, device)[None]

    def to_wire_np(self, t: torch.Tensor) -> np.ndarray:
        """(1, *shape) words -> (*shape) wire words."""
        return self.f.to_wire(t[0].detach().cpu())


@functools.lru_cache(maxsize=None)
def get_lane_field(params: FieldParams) -> LaneField:
    return LaneField(params)


def get_base_ops(name_or_params, kern: FieldKernels = KERNELS):
    """The coordinate field of a curve's base field: LaneField for the
    one-word fields (no kernels), else the BigMontField with `kern`."""
    params = (name_or_params if isinstance(name_or_params, FieldParams)
              else get_field(name_or_params))
    if is_lane_field(params):
        return get_lane_field(params)
    return get_field_ops(params, kern)
