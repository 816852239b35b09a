"""The yardstick's arithmetic: peaks, operation and byte counts, bounds.

Frozen copies of chip_smoke.py's roofline arithmetic at the commit that
added this benchmark (`bound` :312, `prod_ops` and `sqr_ops` :711-731,
`transform_ops` :1132, the Goldilocks constants :254-260), so that a later
change to the program cannot move the bounds.  One departure: chip_smoke
reads the INT32 rate from `nvidia-smi clocks.max.sm` on every run; here it
is the constant that reading gave on an H100 SXM (132 SMs x 64 INT32 lanes
x 1.98 GHz), and a run reports the card's power limit beside it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

#: H100 SXM device memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer operations per second: 132 SMs x 64 lanes x 1.98 GHz
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bound_ms(nbytes: float, ops: float) -> Tuple[float, str]:
    """(the least time in ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def prod_ops(n32: int) -> int:
    """32-bit integer operations of one Montgomery product: 2 n32^2
    32x32->64 products, each counted as 2 IMADs."""
    return 4 * n32 * n32


def sqr_ops(n32: int) -> int:
    """32-bit integer operations of one Montgomery squaring: the
    n32 (n32 - 1) / 2 off-diagonal products once, the n32 diagonal ones,
    then the n32^2 of the reduction, 2 IMADs each."""
    return 3 * n32 * n32 + n32


def madd_ops(n32: int) -> int:
    """One xyzz mixed addition: 8 products and 2 squarings."""
    return 8 * prod_ops(n32) + 2 * sqr_ops(n32)


def transform_ops(lg: int, count: int, prod: int, add_sub: int) -> int:
    """Integer operations of `count` radix-2 transforms of length
    n = 2^lg: `add_sub` (an add and a sub) for each of the (n/2) lg
    butterflies and `prod` (a product) for each whose twiddle is not
    w^0 = 1, which is all but n - 1 of them."""
    n = 1 << lg
    return count * ((n // 2) * lg * add_sub
                    + ((n // 2) * lg - (n - 1)) * prod)


def transform_work(field: dict, lg: int, lg_blowup: int) -> Tuple[int, int]:
    """(operations, bytes) one call needs: an NTT of 2^lg (lg_blowup 0), or
    an LDE, its inverse 2^lg and forward 2^(lg + lg_blowup); the bytes are
    the input read once and the output written once."""
    prod, add_sub = field["ops_per_mul"], field["ops_add_sub"]
    ops = transform_ops(lg, 1, prod, add_sub)
    if lg_blowup:
        ops += transform_ops(lg + lg_blowup, 1, prod, add_sub)
    n = 1 << lg
    return ops, field["word_bytes"] * (n + (n << lg_blowup))


def msm_madds(words: torch.Tensor, order: int, wbits: int,
              skip: Sequence[int] = (), period: int = 0) -> int:
    """The madds an MSM of these scalars needs with signed wbits-bit
    windows (sppark msm/pippenger.cuh:72-121): one for each window digit
    that is not 0, of each point not at infinity: point i is at infinity
    where i mod `period` (n where 0) is in `skip`.  `words`: (n_words, n)
    int32 canonical scalar words, on any device."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    n_words, n = w.shape
    nwins = (order.bit_length() + wbits - 1) // wbits
    value = torch.zeros_like(w[0])
    half = order // 2
    # the fold s > r/2 -> r - s, on 32-bit words with a borrow
    gt = torch.zeros(n, dtype=torch.bool, device=w.device)
    eq = torch.ones(n, dtype=torch.bool, device=w.device)
    for i in reversed(range(n_words)):
        h = (half >> (32 * i)) & 0xFFFFFFFF
        gt |= eq & (w[i] > h)
        eq &= w[i] == h
    folded, borrow = [], torch.zeros_like(value)
    for i in range(n_words):
        d = ((order >> (32 * i)) & 0xFFFFFFFF) - w[i] - borrow
        borrow = (d < 0).to(torch.int64)
        folded.append(d & 0xFFFFFFFF)
    s = [torch.where(gt, f, x) for f, x in zip(folded, w)]
    keep = torch.ones(period or n, dtype=torch.bool, device=w.device)
    keep[list(skip)] = False
    keep = keep.repeat(n // keep.numel())
    count, carry = 0, torch.zeros_like(value)
    full, halfw = 1 << wbits, 1 << (wbits - 1)
    for win in range(nwins):
        off = win * wbits
        wi, sh = off >> 5, off & 31
        raw = s[wi] >> sh
        if sh + wbits > 32 and wi + 1 < n_words:
            raw = raw | (s[wi + 1] << (32 - sh))
        t = (raw & (full - 1)) + carry
        neg = t >= halfw if win < nwins - 1 else torch.zeros_like(keep)
        digit = torch.where(neg, full - t, t)
        carry = neg.to(torch.int64)
        count += int(((digit != 0) & keep).sum())
    return count
