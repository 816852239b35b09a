"""Single-word 31-bit fields: BabyBear (both generators) in Montgomery form
and Mersenne-31 with direct reduction, the port of
sppark_tpu/ff/mont32.py (mont32_t, ff/mont32_t.cuh).

An element is ONE 32-bit word held in a torch.int32 tensor, `(*batch,)`
with the domain on the last axis.  Every prime here is below 2^31, so a
canonical word is never negative and the int32 value is the u32 word: the
wire format and the JAX package's uint32 arrays carry over bit for bit.
BabyBear words are Montgomery with R = 2^32; Mersenne-31 words are
canonical.  Inputs are canonical (< p) and so is every output, so the
words equal the JAX package's whatever order the reduction takes.

CPU torch has no unsigned 32-bit arithmetic, so:
  * add and sub stay in int32: a - (p - b) and a - b lie in (-p, p), and
    one select folds them into [0, p);
  * products widen to int64: a * b < 2^62 fits, but T + m p can reach
    2^62 + 2^63, so the reduction is (T >> 32) + ((m p) >> 32) + (T's low
    word != 0), which is (T + m p) >> 32 since the low words cancel
    (sppark_tpu/ff/mont32.py:73-78); m = (lo M0) mod 2^32 is masked after
    the int64 product, whose wrap leaves the low 32 bits intact.

These are the plain versions of the arithmetic that csrc/ntt_mont32.cu
does in `uint32_t`.
"""

from __future__ import annotations

import functools
import math
from typing import Iterable, List

import numpy as np
import torch

from ..params import FieldParams, get_field
from . import inversion

_M32 = 0xFFFFFFFF
_M31 = 0x7FFFFFFF


class Mont32Field:
    """Field ops over int32 words of a prime below 2^31, Montgomery form
    with R = 2^32."""

    def __init__(self, params: FieldParams):
        if params.bits > 31:
            raise ValueError(f"{params.name}: {params.bits}-bit prime; the "
                             f"int32 words hold primes below 2^31")
        self.params = params
        self.p = params.modulus
        #: -p^-1 mod 2^32
        self.m0 = params.m0(32)

    # -- ring ops ----------------------------------------------------------------
    def add(self, x, y):
        s = x - (self.p - y)
        return torch.where(s < 0, s + self.p, s)

    def sub(self, x, y):
        d = x - y
        return torch.where(d < 0, d + self.p, d)

    def neg(self, x):
        return torch.where(x == 0, x, self.p - x)

    def _reduce(self, t):
        """A product t < p^2 (int64) -> canonical int32 word."""
        lo = t & _M32
        m = (lo * self.m0) & _M32
        r = (t >> 32) + ((m * self.p) >> 32) + (lo != 0).to(torch.int64)
        return torch.where(r >= self.p, r - self.p, r).to(torch.int32)

    def mul(self, x, y):
        """Montgomery product x * y * 2^-32 (mont32_t operator*)."""
        return self._reduce(x.to(torch.int64) * y.to(torch.int64))

    def sqr(self, x):
        return self.mul(x, x)

    def select(self, cond, x, y):
        return torch.where(cond, x, y)

    def is_zero(self, x):
        return x == 0

    def eq(self, x, y):
        return x == y

    # -- constants ---------------------------------------------------------------
    def _word(self, v: int) -> int:
        """Canonical int -> its word (Montgomery here)."""
        return self.params.to_mont(v % self.p)

    def _int(self, w: int) -> int:
        return self.params.from_mont(w)

    def zeros(self, batch_shape, device=None):
        return torch.zeros(tuple(batch_shape), dtype=torch.int32,
                           device=device)

    def const(self, value: int, batch_shape=(), device=None):
        """A canonical int broadcast as a word."""
        return torch.full(tuple(batch_shape), self._word(value),
                          dtype=torch.int32, device=device)

    def ones(self, batch_shape=(), device=None):
        return self.const(1, batch_shape, device)

    # -- Montgomery domain ---------------------------------------------------------
    def to_mont(self, x):
        return self.mul(x, torch.full_like(x, self.params.RR))

    def from_mont(self, x):
        return self._reduce(x.to(torch.int64))

    # -- exponentiation, inversion and roots ---------------------------------------
    def pow_const(self, x, e: int):
        """x^e for a fixed exponent, MSB first (pow_byref, ff/pow.hpp)."""
        if e == 0:
            return self.ones(x.shape, x.device)
        acc = x
        for bit in bin(e)[3:]:
            acc = self.sqr(acc)
            if bit == "1":
                acc = self.mul(acc, x)
        return acc

    def inv(self, x):
        """Fermat inversion x^(p-2); 0 -> 0."""
        return self.pow_const(x, self.p - 2)

    def nth_root(self, x, k: int):
        """x^(1/k) = x^(k^-1 mod p-1) for gcd(k, p-1) == 1 (the Poseidon
        S-box roots, ff/baby_bear.hpp:52-67, ff/mersenne31.hpp:425)."""
        return nth_root(self.pow_const, self.p, x, k)

    def heptaroot(self, x):
        return self.nth_root(x, 7)

    def pentaroot(self, x):
        return self.nth_root(x, 5)

    def sqrt(self, x):
        """A square root x^((p+1)/4) for p = 3 (mod 4) (ff/mersenne31.hpp:
        407); garbage for a non-residue, as in the reference."""
        return sqrt(self.pow_const, self.p, x)

    def batch_inv(self, x):
        """Montgomery-trick inversion along the last axis: prefix and suffix
        products and ONE Fermat inversion; zero lanes give zero
        (ff/inversion.py)."""
        return inversion.batch_inv(self.mul, self.inv, x, self.is_zero(x),
                                   self.ones(x.shape, x.device))

    def batch_inv_tree(self, x):
        """Inversion along the last axis by a product tree (the port of
        sppark_tpu/ff/base.py:batch_inv_tree, ff/inversion.py): a
        power-of-two axis and non-zero inputs."""
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
        """Canonical ints -> words (n,), or (*batch_shape)."""
        arr = np.asarray([self._word(v) for v in values], dtype=np.int32)
        if batch_shape is not None:
            arr = arr.reshape(tuple(batch_shape))
        return torch.from_numpy(arr).to(device)

    def to_int_list(self, t: torch.Tensor) -> List[int]:
        """Words -> canonical ints, lanes in flattened order."""
        return [self._int(int(w)) for w in
                t.detach().cpu().reshape(-1).tolist()]

    @staticmethod
    def from_wire_np(arr: np.ndarray, device=None) -> torch.Tensor:
        """Wire (*shape) u32 words -> (*shape) int32 words.  The JAX
        package's uint32 arrays are the same words."""
        a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
        return torch.from_numpy(a.view(np.int32).copy()).to(device)

    @staticmethod
    def to_wire_np(t: torch.Tensor) -> np.ndarray:
        """(*shape) int32 words -> (*shape) u32 wire words."""
        return t.detach().cpu().numpy().view(np.uint32)

    from_jax = from_wire_np
    to_jax = to_wire_np


class Mersenne31Field(Mont32Field):
    """Mersenne-31, p = 2^31 - 1, with direct reduction: 2^31 = 1, so a
    product folds twice by its bits above 31.  Words are canonical, the
    reference's mersenne31 mem_t (ff/mersenne31.hpp:14-39)."""

    def _reduce(self, t):
        s = (t & _M31) + (t >> 31)          # < 2^31 + 2^31
        s = (s & _M31) + (s >> 31)          # <= 2^31
        return torch.where(s >= self.p, s - self.p, s).to(torch.int32)

    def _word(self, v: int) -> int:
        return v % self.p

    def _int(self, w: int) -> int:
        return w

    def to_mont(self, x):
        return x.clone()

    def from_mont(self, x):
        return x.clone()


def nth_root(pow_const, p: int, x, k: int):
    """x^(1/k) through `pow_const` over the prime p; ValueError when gcd(k,
    p-1) != 1 (sppark_tpu/ff/base.py:nth_root)."""
    if math.gcd(k, p - 1) != 1:
        raise ValueError(f"k={k} shares a factor with p-1")
    return pow_const(x, pow(k, -1, p - 1))


def sqrt(pow_const, p: int, x):
    """x^((p+1)/4) through `pow_const`; NotImplementedError unless p = 3
    (mod 4) (sppark_tpu/ff/base.py:sqrt)."""
    if p % 4 != 3:
        raise NotImplementedError("sqrt needs p = 3 (mod 4)")
    return pow_const(x, (p + 1) // 4)


@functools.lru_cache(maxsize=None)
def get_mont32_ops(name_or_params) -> Mont32Field:
    """The cached field ops of a 31-bit field: Mersenne31Field for
    Mersenne-31, Mont32Field for the others."""
    params = (name_or_params if isinstance(name_or_params, FieldParams)
              else get_field(name_or_params))
    if params.modulus == (1 << 31) - 1:
        return Mersenne31Field(params)
    return Mont32Field(params)


__all__ = ["Mont32Field", "Mersenne31Field", "get_mont32_ops", "nth_root",
           "sqrt"]
