"""Plain radix-2 NTT and coset LDE over `field.PlainField` limb tensors.

The transforms follow sppark's definitions (ntt/ntt.cuh): the forward NTT
of x along n = 2^lg is X[k] = sum_i x[i] w^(i k), w = g^((p - 1) / n) for
the field's generator g; the inverse uses w^-1 and scales by 1/n; both take
and give natural order.  The LDE of 2^lg evaluations over the subgroup is
the forward NTT of length 2^(lg + blowup) of the inverse's coefficients,
zero-extended and multiplied by g^i: evaluations over the coset g H'.

Each stage is an iterative Cooley-Tukey pass over the bit-reversed input,
run in chunks of butterflies so that the temporaries stay within a few
GiB at 2^26 elements of 16 limbs.  `lazy` passes the field's lazy product
(no final subtraction) through: the control's arithmetic.
"""

from __future__ import annotations

import torch

from .field import PlainField

#: butterflies a chunk, times the limb count: bounds the temporaries
CHUNK_LIMBS = 1 << 25


def root_of_unity(F: PlainField, generator: int, lg: int) -> int:
    return pow(generator, (F.p - 1) >> lg, F.p)


def bitrev_indices(lg: int, device) -> torch.Tensor:
    i = torch.arange(1 << lg, dtype=torch.int64, device=device)
    r = torch.zeros_like(i)
    for b in range(lg):
        r |= ((i >> b) & 1) << (lg - 1 - b)
    return r


def _stage(F: PlainField, x: torch.Tensor, h: int, tw: torch.Tensor,
           lazy: bool) -> None:
    """One radix-2 stage in place: x (L, n) viewed as (L, B, 2, h), the
    pair (u, v) -> (u + t, u - t) with t = v tw[j], j < h."""
    L, n = x.shape
    B = n // (2 * h)
    X = x.view(L, B, 2, h)
    chunk = max(1, CHUNK_LIMBS // L)
    if h >= chunk:
        for b in range(B):
            for s in range(0, h, chunk):
                e = min(h, s + chunk)
                u, v = X[:, b, 0, s:e], X[:, b, 1, s:e]
                t = F.mul(v, tw[:, s:e], lazy)
                hi = F.sub(u, t)
                X[:, b, 0, s:e] = F.add(u, t).to(x.dtype)
                X[:, b, 1, s:e] = hi.to(x.dtype)
        return
    bc = max(1, chunk // h)
    for b0 in range(0, B, bc):
        b1 = min(B, b0 + bc)
        u = X[:, b0:b1, 0, :].reshape(L, -1)
        v = X[:, b0:b1, 1, :].reshape(L, -1)
        w = tw[:, None, :].expand(L, b1 - b0, h).reshape(L, -1)
        t = F.mul(v, w, lazy)
        hi = F.sub(u, t)
        X[:, b0:b1, 0, :] = F.add(u, t).to(x.dtype).view(L, b1 - b0, h)
        X[:, b0:b1, 1, :] = hi.to(x.dtype).view(L, b1 - b0, h)


def ntt(F: PlainField, generator: int, x: torch.Tensor, lg: int,
        inverse: bool = False, lazy: bool = False) -> torch.Tensor:
    """The NTT of x ((L, 2^lg) limbs, natural order) as a new int32 limb
    tensor in natural order."""
    n = 1 << lg
    assert x.shape[1] == n
    dev = x.device
    y = x.to(torch.int32)[:, bitrev_indices(lg, dev)]
    if lg == 0:
        return y
    w = root_of_unity(F, generator, lg)
    if inverse:
        w = pow(w, -1, F.p)
    table = F.powers(w, n // 2, dev).to(torch.int32)   # w^j R, j < n/2
    h = 1
    while h < n:
        tw = table[:, ::n // (2 * h)][:, :h].contiguous()
        _stage(F, y, h, tw, lazy)
        h *= 2
    del table
    if inverse:
        scale = F.const(pow(n, -1, F.p), dev)
        chunk = max(1, CHUNK_LIMBS // F.L)
        for s in range(0, n, chunk):
            y[:, s:s + chunk] = F.mul(y[:, s:s + chunk], scale,
                                      lazy).to(torch.int32)
    return y


def lde(F: PlainField, generator: int, x: torch.Tensor, lg: int,
        lg_blowup: int, lazy: bool = False) -> torch.Tensor:
    """Coset LDE of 2^lg evaluations to 2^(lg + lg_blowup) evaluations over
    g H' (natural order in and out), as a new int32 limb tensor."""
    coeffs = ntt(F, generator, x, lg, inverse=True, lazy=lazy)
    n, lg_ext = 1 << lg, lg + lg_blowup
    ext = torch.zeros((F.L, 1 << lg_ext), dtype=torch.int32, device=x.device)
    shift = F.powers(generator, n, x.device)
    chunk = max(1, CHUNK_LIMBS // F.L)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        ext[:, s:e] = F.mul(coeffs[:, s:e], shift[:, s:e],
                            lazy).to(torch.int32)
    del coeffs, shift
    return ntt(F, generator, ext, lg_ext, lazy=lazy)
