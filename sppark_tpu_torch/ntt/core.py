"""Radix-2 NTT dataflow on int64 tensors: the bit-reversal permutation and
the plain Cooley-Tukey stages that the kernels' plain versions run.

`ct_stages` expects bit-reversed input along the last axis and returns
natural order.  Arithmetic inside is lazy, with one `canon` at the end, as
in the kernels, so the output words are canonical.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ff import gl64


@functools.lru_cache(maxsize=None)
def bitrev_indices(lg_n: int) -> np.ndarray:
    n = 1 << lg_n
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(lg_n):
        rev |= ((idx >> b) & 1) << (lg_n - 1 - b)
    return rev


def bit_reverse(x: torch.Tensor, lg_n: int) -> torch.Tensor:
    """Bit-reverse permutation along the last axis."""
    idx = torch.from_numpy(bitrev_indices(lg_n)).to(x.device)
    return x.index_select(-1, idx)


def ct_stages(x: torch.Tensor, lg_n: int, tw: torch.Tensor) -> torch.Tensor:
    """All lg_n CT stages along the last axis.  `tw` is the power table
    [w^0 .. w^(n/2 - 1)]; stage s takes its 2^(s-1) twiddles as the
    stride-2^(lg-s) slice."""
    n = 1 << lg_n
    lead = x.shape[:-1]
    for s in range(1, lg_n + 1):
        half = 1 << (s - 1)
        v = x.reshape(lead + (n >> s, 2, half))
        lo, hi = v[..., 0, :], v[..., 1, :]
        t = gl64.mul_lazy(hi, tw[:: 1 << (lg_n - s)])
        x = torch.stack([gl64.add_lazy(lo, t), gl64.sub_lazy(lo, t)],
                        dim=-2).reshape(lead + (n,))
    return gl64.canon(x)
