"""Plain prime-field arithmetic on torch tensors of 16-bit limbs.

An element vector is a (L, n) integer tensor, limb i holding bits
[16 i, 16 i + 16) of the canonical value, L = ceil(bits(p) / 16).  Every
product of two limbs is below 2^32 and every column sum of a product below
2^40, so int64 holds each intermediate exactly on any device: no
wrap-around, no unsigned type.  Products are Montgomery products with
R = 2^(16 L) against a multiplier given in Montgomery form (c R mod p), so
`mul(a, const(c))` is a c mod p with a in plain form: data stays plain and
only multipliers carry R.

This module is independent of the program it checks: it knows a field by
its modulus alone.
"""

from __future__ import annotations

from typing import Iterable, List

import torch

LIMB = 16
MASK = (1 << LIMB) - 1


class PlainField:
    """Arithmetic mod p on (L, n) limb tensors."""

    def __init__(self, modulus: int):
        self.p = modulus
        self.L = (modulus.bit_length() + LIMB - 1) // LIMB
        self.R = 1 << (LIMB * self.L)
        self.pinv = (-pow(modulus, -1, 1 << LIMB)) % (1 << LIMB)

    # -- conversions ---------------------------------------------------------------
    def limbs_of(self, v: int) -> List[int]:
        return [(v >> (LIMB * i)) & MASK for i in range(self.L)]

    def tensor(self, values: Iterable[int], device=None) -> torch.Tensor:
        """(L, n) int64 limbs of Python ints (reduced mod p)."""
        cols = [self.limbs_of(v % self.p) for v in values]
        return torch.tensor(cols, dtype=torch.int64,
                            device=device).reshape(-1, self.L).T.contiguous()

    def to_ints(self, x: torch.Tensor) -> List[int]:
        rows = x.to(torch.int64).cpu().tolist()
        return [sum(int(rows[i][j]) << (LIMB * i) for i in range(len(rows)))
                for j in range(x.shape[1])]

    def mont(self, c: int) -> int:
        return c * self.R % self.p

    def const(self, c: int, device=None) -> torch.Tensor:
        """(L, 1) Montgomery-form multiplier for the constant c."""
        return torch.tensor(self.limbs_of(self.mont(c)), dtype=torch.int64,
                            device=device)[:, None]

    # -- arithmetic ----------------------------------------------------------------
    def _p(self, device):
        return torch.tensor(self.limbs_of(self.p), dtype=torch.int64,
                            device=device)[:, None]

    def _normalize(self, t: torch.Tensor) -> torch.Tensor:
        """Carry every limb into 16 bits (t is modified and returned); the
        top limb keeps what overflows."""
        for i in range(t.shape[0] - 1):
            t[i + 1] += t[i] >> LIMB
            t[i] &= MASK
        return t

    def _reduce_once(self, t: torch.Tensor) -> torch.Tensor:
        """t in [0, 2p) as L + 1 normalized limbs -> t mod p, L limbs."""
        p = self.limbs_of(self.p) + [0]
        d = torch.empty_like(t)
        borrow = torch.zeros_like(t[0])
        for i in range(t.shape[0]):
            v = t[i] - p[i] - borrow
            borrow = (v < 0).to(torch.int64)
            d[i] = v & MASK
        keep = borrow.bool()                # t < p: keep t
        return torch.where(keep, t, d)[:self.L]

    def mul(self, a: torch.Tensor, b_mont: torch.Tensor,
            lazy: bool = False) -> torch.Tensor:
        """a * b mod p, b given as Montgomery-form limbs ((L, n) or (L, 1)):
        CIOS Montgomery multiplication over 16-bit limbs.  With `lazy` the
        final reduction is left out and the result kept mod R, so it may
        lie in [p, R) or have lost its top carry (the control's arithmetic,
        never the reference's)."""
        L = self.L
        a = a.to(torch.int64)
        b = b_mont.to(torch.int64)
        n = max(a.shape[1], b.shape[1])
        t = torch.zeros((2 * L + 1, n), dtype=torch.int64, device=a.device)
        P = self._p(a.device)
        for i in range(L):
            t[i:i + L] += a[i] * b
            m = ((t[i] & MASK) * self.pinv) & MASK
            t[i:i + L] += m * P
            t[i + 1] += t[i] >> LIMB
        r = self._normalize(t[L:].clone())           # L + 1 limbs, < 2p
        return r[:L] if lazy else self._reduce_once(r)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        t = torch.cat([a.to(torch.int64) + b.to(torch.int64),
                       torch.zeros_like(a[:1], dtype=torch.int64)])
        return self._reduce_once(self._normalize(t))

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a - b mod p: a + (p - b)."""
        nb = self._p(a.device) - b.to(torch.int64)
        borrow = torch.zeros_like(nb[0])
        for i in range(self.L):             # p - b as normalized limbs
            v = nb[i] - borrow
            borrow = (v < 0).to(torch.int64)
            nb[i] = v & MASK
        return self.add(a, nb)

    def powers(self, base: int, n: int, device=None) -> torch.Tensor:
        """(L, n) Montgomery-form [base^0 .. base^(n-1)], by doubling."""
        out = torch.empty((self.L, n), dtype=torch.int64, device=device)
        out[:, :1] = self.const(1, device)
        m = 1
        while m < n:
            k = min(m, n - m)
            out[:, m:m + k] = self.mul(out[:, :k],
                                       self.const(pow(base, m, self.p),
                                                  device))
            m += k
        # mul(., const(c)) multiplies by c, so each entry keeps its R
        return out


def limbs_from_u64_words(w: torch.Tensor) -> torch.Tensor:
    """(n,) int64 tensor holding u64 bit patterns -> (4, n) int32 16-bit
    limbs (each shift is masked, so the sign bit does no harm)."""
    return torch.stack([((w >> (LIMB * i)) & MASK).to(torch.int32)
                        for i in range(4)])


def limbs_from_u32_words(w: torch.Tensor) -> torch.Tensor:
    """(k, n) int32 tensor of u32 words, least significant first -> (2 k,
    n) int32 16-bit limbs."""
    return torch.stack([w & MASK, (w >> LIMB) & MASK], dim=1).reshape(
        2 * w.shape[0], w.shape[1])
