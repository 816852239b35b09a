"""Multi-limb Montgomery fields (BN254, BLS12-381, Pasta, test_bm64): the
port of sppark_tpu/ff/bigmont.py:BigMontField and ff/base.py's defaults.

An element is n32 = mont_bits / 32 little-endian 32-bit words, limb-major
`(n32, *batch)`, held as the u32 bit pattern in an int32 tensor: adjacent
lanes sit at adjacent addresses, so a kernel with one thread per lane reads
coalesced.  R = 2^(32 n32) = 2^(16 L), so the Montgomery words are the JAX
package's `(L, *batch)` 16-bit-limb planes packed in pairs
(`from_jax_planes` / `to_jax_planes`, which also carry an fp2 element:
the JAX package's (c0 planes, c1 planes) pair <-> the port's (2 n32, ...)
words, c0's then c1's, as ff/ext.py:Fp2Field holds them).

`mul`, `sqr`, `pow_const` (so every inversion) and, on the card, the
batch inversions go through the field kernels a field is made with
(ff/kernels.py: the bigmont_ew, bigmont_pow and bigmont_inv_up/_down
kernels on CUDA tensors by default, or the plain versions); `add`, `sub`,
`neg`, `select` and the rest are plain PyTorch, as the JAX package left
them to XLA.  Inputs are canonical (< p) and so is every output.
"""

from __future__ import annotations

import functools
from typing import Iterable, List

import numpy as np
import torch

from ..params import FieldParams, get_field
from . import inversion, mont32
from .kernels import (KERNELS, FieldKernels, int_words, mod_add, mod_sub,
                      sub_words, words32, words64)


def from_jax_planes(planes, device=None) -> torch.Tensor:
    """The JAX package's (L, ...) uint32 planes of 16-bit limbs -> the
    port's (L/2, ...) int32 words; a (c0, c1) pair of them (an fp2
    element) -> (L, ...) words, c0's then c1's."""
    if isinstance(planes, (tuple, list)):
        return torch.cat([from_jax_planes(c, device) for c in planes])
    a = np.asarray(planes, dtype=np.uint32)
    w = a[0::2] | (a[1::2] << np.uint32(16))
    return torch.from_numpy(np.ascontiguousarray(w).view(np.int32)).to(device)


def to_jax_planes(t: torch.Tensor, degree: int = 1):
    """The port's (n32, ...) int32 words -> the JAX package's (2 n32, ...)
    uint32 planes of 16-bit limbs; with degree 2, (2 n32, ...) fp2 words
    -> the (c0 planes, c1 planes) pair."""
    if degree == 2:
        return tuple(to_jax_planes(c) for c in t.chunk(2))
    w = t.detach().cpu().numpy().view(np.uint32)
    planes = np.stack([w & np.uint32(0xFFFF), w >> np.uint32(16)], axis=1)
    return planes.reshape((2 * w.shape[0],) + w.shape[1:])


def wire_to_words(arr: np.ndarray, words: int, device=None) -> torch.Tensor:
    """Wire (*shape, words) little-endian u32 words (the reference's FFI
    layout) -> (words, *shape) int32 words; a flat array is (n, words)."""
    a = np.asarray(arr, dtype=np.uint32)
    if a.ndim < 2 or a.shape[-1] != words:
        a = a.reshape(-1, words)
    w = np.ascontiguousarray(np.moveaxis(a, -1, 0))
    return torch.from_numpy(w.view(np.int32)).to(device)


def words_to_wire(t: torch.Tensor) -> np.ndarray:
    """(words, *shape) int32 words -> (*shape, words) u32 wire words."""
    w = t.detach().cpu().numpy().view(np.uint32)
    return np.ascontiguousarray(np.moveaxis(w, 0, -1))


class BigMontField:
    """Field ops over (n32, *batch) int32 words, Montgomery form."""

    dtype = torch.int32

    def __init__(self, params: FieldParams, kern: FieldKernels = KERNELS):
        self.params = params
        self.p = params.modulus
        self.n32 = params.n_ref_limbs
        #: int32 words per element, and its tensor rows
        self.words = self.rows = self.n32
        self.kern = kern
        self._p_words = int_words(self.p, self.n32)

    # -- ring ops ----------------------------------------------------------------
    def add(self, x, y):
        return mod_add(x, y, self.params)

    def sub(self, x, y):
        return mod_sub(x, y, self.params)

    def neg(self, x):
        d, _ = sub_words([torch.full_like(w, p) for w, p in
                          zip(words64(x), self._p_words)], list(words64(x)))
        return self.select(self.is_zero(x), torch.zeros_like(x),
                           words32(torch.stack(d)))

    def mul(self, x, y):
        """Montgomery product x * y * R^-1 (mont_t operator*)."""
        return self.kern.mul(x, y, self.params)

    def sqr(self, x):
        return self.kern.sqr(x, self.params)

    def select(self, cond, x, y):
        """Lane-wise select; `cond` is a bool tensor over the batch shape."""
        return torch.where(cond, x, y)

    def is_zero(self, x):
        return (x == 0).all(dim=0)

    def eq(self, x, y):
        return (x == y).all(dim=0)

    # -- constants ---------------------------------------------------------------
    def zeros(self, batch_shape, device=None):
        return torch.zeros((self.n32,) + tuple(batch_shape),
                           dtype=torch.int32, device=device)

    def _word_const(self, v: int, batch_shape, device):
        col = words32(torch.tensor(int_words(v, self.n32), dtype=torch.int64,
                                   device=device))
        batch_shape = tuple(batch_shape)
        return col.reshape((self.n32,) + (1,) * len(batch_shape)).expand(
            (self.n32,) + batch_shape)

    def const(self, value: int, batch_shape=(), device=None):
        """A canonical int broadcast in Montgomery form (an expanded
        view)."""
        return self._word_const(self.params.to_mont(value % self.p),
                                batch_shape, device)

    def ones(self, batch_shape=(), device=None):
        return self._word_const(self.params.one_mont, batch_shape, device)

    # -- exponentiation and inversion ----------------------------------------------
    def pow_const(self, x, e: int):
        """x^e for a fixed exponent: the field kernels' pow, one launch of
        the whole chain on the card (ff/kernels.py:mont_pow); e = 0 gives
        ones."""
        return self.kern.pow(x, e, self.params)

    def inv(self, x):
        """Fermat inversion x^(p-2); 0 -> 0."""
        return self.pow_const(x, self.p - 2)

    def nth_root(self, x, k: int):
        """x^(1/k) = x^(k^-1 mod p-1) for gcd(k, p-1) == 1."""
        return mont32.nth_root(self.pow_const, self.p, x, k)

    def heptaroot(self, x):
        return self.nth_root(x, 7)

    def pentaroot(self, x):
        return self.nth_root(x, 5)

    def sqrt(self, x):
        """A square root x^((p+1)/4) for p = 3 (mod 4); garbage for a
        non-residue, as in the reference."""
        return mont32.sqrt(self.pow_const, self.p, x)

    def batch_inv(self, x):
        """Montgomery-trick inversion of every lane, zero lanes giving
        zero.  On the card the field kernels' batch_inv over the whole
        batch (ff/kernels.py:mont_batch_inv: three launches); on the CPU
        prefix and suffix products along the last axis and ONE Fermat
        inversion (ff/inversion.py)."""
        if x.device.type != "cpu":
            return self.kern.batch_inv(x, self.params)
        return inversion.batch_inv(self.mul, self.inv, x, self.is_zero(x),
                                   self.ones(x.shape[1:], x.device))

    def batch_inv_tree(self, x):
        """Inversion along the last axis with the contract of
        sppark_tpu/ff/base.py:batch_inv_tree (a power-of-two axis, non-zero
        inputs): on the card batch_inv's kernels, on the CPU a product tree
        (ff/inversion.py)."""
        if x.device.type != "cpu":
            inversion.check_pow2(x.shape[-1])
            return self.kern.batch_inv(x, self.params)
        return inversion.batch_inv_tree(self.mul, self.inv, x)

    # -- Montgomery domain ---------------------------------------------------------
    def to_mont(self, x):
        return self.mul(x, self._word_const(self.params.RR, x.shape[1:],
                                            x.device))

    def from_mont(self, x):
        return self.mul(x, self._word_const(1, x.shape[1:], x.device))

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
        """Canonical ints -> Montgomery words (n32, n), or (n32,
        *batch_shape)."""
        wire = [self.params.to_mont(v % self.p) for v in values]
        arr = np.zeros((self.n32, len(wire)), dtype=np.uint32)
        for c, v in enumerate(wire):
            arr[:, c] = int_words(v, self.n32)
        if batch_shape is not None:
            arr = arr.reshape((self.n32,) + tuple(batch_shape))
        return torch.from_numpy(arr.view(np.int32)).to(device)

    def to_int_list(self, t: torch.Tensor) -> List[int]:
        """Montgomery words -> canonical ints, lanes in flattened order."""
        flat = t.detach().cpu().numpy().view(np.uint32).reshape(self.n32, -1)
        out = []
        for c in range(flat.shape[1]):
            v = sum(int(flat[i, c]) << (32 * i) for i in range(self.n32))
            out.append(self.params.from_mont(v))
        return out

    def from_wire_np(self, arr: np.ndarray, device=None) -> torch.Tensor:
        """Wire (*shape, n32) little-endian u32 words (the reference's FFI
        layout) -> (n32, *shape) words; a flat wire array is (n, n32)."""
        return wire_to_words(arr, self.n32, device)

    def to_wire_np(self, t: torch.Tensor) -> np.ndarray:
        """(n32, *shape) words -> (*shape, n32) wire words."""
        return words_to_wire(t)


@functools.lru_cache(maxsize=None)
def get_field_ops(name_or_params, kern: FieldKernels = KERNELS
                  ) -> BigMontField:
    """The cached BigMontField of a field, with the given field kernels."""
    params = (name_or_params if isinstance(name_or_params, FieldParams)
              else get_field(name_or_params))
    return BigMontField(params, kern)
