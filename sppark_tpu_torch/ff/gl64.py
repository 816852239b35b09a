"""Goldilocks field p = 2^64 - 2^32 + 1 on int64 tensors (gl64_t).

An element is ONE u64 word held in a torch.int64 tensor as its bit
pattern, with the domain on the last axis: the wire format and the
reference's gl64_t.  No Montgomery form.  These are the plain versions of
the arithmetic that csrc/ntt_gl64.cu does in `uint64_t`; the kernels' plain
counterparts and the table builders use them.

CPU torch has no unsigned 64-bit add, shift or compare, so:
  * int64 add/sub/mul wrap mod 2^64, which is the u64 bit pattern;
  * `>>` is arithmetic, so every shift is masked after;
  * an unsigned compare flips the sign bit of both sides first (_ltu);
  * the 64x64 product is built from four 32x32 products, each exact as a
    u64 bit pattern, then reduced with 2^64 = 2^32 - 1 and 2^96 = -1
    (mod p), as gl64_t.cuh does.

Lazy ops (`add_lazy`, `sub_lazy`, `mul_lazy`) keep any representative in
[0, 2^64), the reference's GL64_PARTIALLY_REDUCED mode; `canon` restores
[0, p).  The full ops are `canon` of the lazy ones.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from . import inversion, mont32

P = (1 << 64) - (1 << 32) + 1
EPS = (1 << 32) - 1                 # 2^64 mod p
_M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)
_P_I64 = P - (1 << 64)              # p as an int64 bit pattern


def to_i64(v: int) -> int:
    """Python int in [0, 2^64) -> the int64 with the same bit pattern."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def _ltu(a, b):
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _fold(cond) -> torch.Tensor:
    """cond ? 2^32 - 1 : 0, as int64."""
    return cond.to(torch.int64) * EPS


# -- lazy ops ------------------------------------------------------------------

def add_lazy(a, b):
    s = a + b
    m = _fold(_ltu(s, a))           # carry out of 2^64 == + eps
    s = s + m
    return s + _fold(_ltu(s, m))    # a second carry leaves s < 2^33


def sub_lazy(a, b):
    d = a - b
    m = _fold(_ltu(a, b))           # borrow == - eps
    d2 = d - m
    return d2 - _fold(_ltu(d, m))


def mul_lazy(a, b):
    a0, a1 = a & _M32, (a >> 32) & _M32
    b0, b1 = b & _M32, (b >> 32) & _M32
    ll, lh, hl, hh = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    # 128-bit product as 32-bit words w0..w3
    t = ((ll >> 32) & _M32) + (lh & _M32) + (hl & _M32)
    t2 = (t >> 32) + ((lh >> 32) & _M32) + ((hl >> 32) & _M32) + (hh & _M32)
    w2 = t2 & _M32
    w3 = ((hh >> 32) & _M32) + (t2 >> 32)
    lo = (ll & _M32) | ((t & _M32) << 32)
    # lo - w3 (2^96 = -1); a borrow is -2^64 = -eps
    r = lo - w3
    r = r - _fold(_ltu(lo, w3))
    # + w2 * 2^64 = w2 * eps = (w2 << 32) - w2
    u = (w2 << 32) - w2
    s = r + u
    return s + _fold(_ltu(s, u))


def canon(x):
    """[0, 2^64) representative -> canonical [0, p)."""
    return torch.where(_ltu(x, _P_I64), x, x - _P_I64)


# -- canonical ops -------------------------------------------------------------

def add(a, b):
    return canon(add_lazy(a, b))


def sub(a, b):
    return canon(sub_lazy(a, b))


def mul(a, b):
    return canon(mul_lazy(a, b))


def sqr(a):
    return mul(a, a)


def neg(a):
    a = canon(a)
    return torch.where(a == 0, a, _P_I64 - a)


def select(cond, a, b):
    return torch.where(cond, a, b)


def const(value: int, shape: Sequence[int] = (), device=None):
    return torch.full(tuple(shape), to_i64(value % P), dtype=torch.int64,
                      device=device)


def ones(shape: Sequence[int], device=None):
    return const(1, shape, device)


def zeros(shape: Sequence[int], device=None):
    return torch.zeros(tuple(shape), dtype=torch.int64, device=device)


def is_zero(x):
    return canon(x) == 0


def eq(x, y):
    return canon(x) == canon(y)


def pow_const(x, e: int):
    """x^e for a static exponent, MSB-first square and multiply."""
    if e == 0:
        return ones(x.shape, x.device)
    acc = x
    for bit in bin(e)[3:]:
        acc = sqr(acc)
        if bit == "1":
            acc = mul(acc, x)
    return acc


def inv(x):
    """Fermat inversion x^(p-2); 0 maps to 0."""
    return pow_const(x, P - 2)


def nth_root(x, k: int):
    """x^(1/k) for gcd(k, p-1) == 1 (heptaroot, ff/gl64_t.cuh:549-565)."""
    return mont32.nth_root(pow_const, P, x, k)


def heptaroot(x):
    return nth_root(x, 7)


def pentaroot(x):
    return nth_root(x, 5)


def sqrt(x):
    """Raises NotImplementedError: p = 1 (mod 4) (sppark_tpu/ff/base.py:
    sqrt takes p = 3 (mod 4) only)."""
    return mont32.sqrt(pow_const, P, x)


def batch_inv(x):
    """Montgomery-trick inversion along the last axis with one Fermat
    inversion; zeros map to zeros (ff/inversion.py)."""
    return inversion.batch_inv(mul, inv, x, canon(x) == 0,
                               torch.ones_like(x))


def batch_inv_tree(x):
    """Product-tree inversion along a power-of-two last axis of non-zero
    lanes (ff/inversion.py)."""
    return inversion.batch_inv_tree(mul, inv, x)


# -- conversions ---------------------------------------------------------------

def from_wire(arr: np.ndarray, device=None) -> torch.Tensor:
    """Wire format (little-endian u64, or (..., 2) u32 word pairs) ->
    int64 tensor."""
    a = np.asarray(arr)
    if a.dtype != np.uint64:
        a = np.ascontiguousarray(a, dtype=np.uint32).view(np.uint64)
        a = a.reshape(a.shape[:-1])
    a = np.ascontiguousarray(a).view(np.int64)
    return torch.from_numpy(a.copy()).to(device)


def to_wire(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.uint64)


def from_jax_planes(planes: np.ndarray, device=None) -> torch.Tensor:
    """The JAX package's (2, ...) uint32 (lo, hi) planes -> int64 tensor."""
    a = np.asarray(planes, dtype=np.uint32)
    w = a[0].astype(np.uint64) | (a[1].astype(np.uint64) << np.uint64(32))
    return torch.from_numpy(np.ascontiguousarray(w).view(np.int64)).to(device)


def to_jax_planes(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> the JAX package's (2, ...) uint32 (lo, hi) planes."""
    w = to_wire(t)
    return np.stack([(w & np.uint64(_M32)).astype(np.uint32),
                     (w >> np.uint64(32)).astype(np.uint32)])


def from_ints(values: Iterable[int], device=None) -> torch.Tensor:
    return torch.tensor([to_i64(v % P) for v in values], dtype=torch.int64,
                        device=device)


def to_ints(t: torch.Tensor) -> List[int]:
    return [int(v) for v in to_wire(t).reshape(-1)]


def one_wire_int() -> int:
    """The wire int of 1: Goldilocks words are canonical."""
    return 1


def rand_ints(rng, n: int) -> List[int]:
    """n uniform canonical ints, one draw of `rng` (a random.Random) each."""
    return [rng.randrange(P) for _ in range(n)]


__all__ = [
    "P", "EPS", "to_i64", "add_lazy", "sub_lazy", "mul_lazy", "canon", "add",
    "sub", "mul", "sqr", "neg", "select", "const", "ones", "zeros", "is_zero",
    "eq", "pow_const", "inv", "nth_root", "heptaroot", "pentaroot", "sqrt",
    "batch_inv", "batch_inv_tree", "from_wire",
    "to_wire", "from_jax_planes", "to_jax_planes", "from_ints", "to_ints",
    "one_wire_int", "rand_ints",
]
