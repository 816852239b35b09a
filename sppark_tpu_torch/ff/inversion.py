"""Batch inversion along the last axis, one text for every field of the
port (gl64, mont32, bigmont): Montgomery's trick in its prefix/suffix form
and in its product-tree form (ff/batch_inversion.hpp:18-52; the port of
sppark_tpu/ff/base.py:batch_inv and batch_inv_tree), each with ONE Fermat
inversion.  `mul` and `inv` are the field's product and inversion over its
words; any leading word axes stay in front, the batch runs along the last
axis."""

from __future__ import annotations

import torch


def scan(mul, x, reverse: bool = False):
    """Inclusive prefix (suffix, if reverse) products along the last axis,
    in lg(n) Hillis-Steele steps."""
    n = x.shape[-1]
    d = 1
    while d < n:
        lo, hi = x[..., :n - d], x[..., d:]
        if reverse:
            x = torch.cat([mul(lo, hi), x[..., n - d:]], dim=-1)
        else:
            x = torch.cat([x[..., :d], mul(hi, lo)], dim=-1)
        d *= 2
    return x


def batch_inv(mul, inv, x, zero, ones):
    """Prefix and suffix products and one inversion of their total; `zero`
    marks the zero lanes (over the batch shape), which give zero, and
    `ones` is the field's one in x's shape (an expanded view will do)."""
    safe = torch.where(zero, ones, x)
    pre, suf = scan(mul, safe), scan(mul, safe, reverse=True)
    total_inv = inv(pre[..., -1:].contiguous())
    one = ones[..., :1]
    out = mul(mul(torch.cat([one, pre[..., :-1]], dim=-1),
                  torch.cat([suf[..., 1:], one], dim=-1)), total_inv)
    return torch.where(zero, torch.zeros_like(x), out)


def check_pow2(n: int) -> None:
    if n & (n - 1):
        raise ValueError(f"batch_inv_tree needs a power-of-two axis, "
                         f"not {n}")


def batch_inv_tree(mul, inv, x):
    """Pair products up to the root, ONE inversion, then each node's
    inverse times its sibling down to the leaves (~3 products per
    element).  Needs a power-of-two axis and non-zero inputs."""
    check_pow2(x.shape[-1])
    levels = [x]
    while levels[-1].shape[-1] > 1:
        cur = levels[-1]
        levels.append(mul(cur[..., 0::2], cur[..., 1::2]))
    root_inv = inv(levels[-1])
    for lvl in reversed(levels[:-1]):
        # the left child's inverse is inv * right, the right's inv * left:
        # one product against the pairs swapped
        pairs = lvl.reshape(lvl.shape[:-1] + (-1, 2))
        root_inv = mul(root_inv.repeat_interleave(2, dim=-1),
                       pairs.flip(-1).reshape(lvl.shape))
    return root_inv
