"""The sharded Pippenger MSM: the port of sppark_tpu/parallel/msm.py onto
torch.distributed.

The points and scalars are block-sharded over the mesh: rank r takes terms
[r n/D, (r + 1) n/D) and runs the mode-"xyzz" rounds (msm/pippenger.py:
MSMRoundStages, the JAX package's default stage bodies) on them, with the
window policy of n/D points.  Its per-window sums, a few KB, are
all-gathered; every rank folds the D of them with D - 1 xyzz adds
(window-sum linearity: sum over the shards of W_shard is the whole W),
converts once to affine and merges the windows on the host.  The
communication is O(nwins D) words, independent of n.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ec import get_curve_ops
from ..ec.kernels import KERNELS
from ..msm import slab
from ..msm.pippenger import (MSMRoundStages, _is_oracle_list,
                             _scalar_words_from_ints, collect)
from ..oracle.ec import AffinePoint
from ..oracle.msm import window_bits
from ..params import get_curve
from .mesh import Mesh


def _shard_points(ops, points, lo: int, hi: int, device):
    if _is_oracle_list(points):
        return ops.affine_from_ints(points[lo:hi], device)
    return tuple(torch.as_tensor(np.asarray(a) if isinstance(a, np.ndarray)
                                 else a)[:, lo:hi].to(device)
                 for a in points)


def _shard_scalars(scalars, order: int, n_words: int, lo: int, hi: int,
                   device) -> torch.Tensor:
    if isinstance(scalars, (np.ndarray, torch.Tensor)) and scalars.ndim == 2:
        w = scalars[:, lo:hi]
        if isinstance(w, np.ndarray):
            w = torch.from_numpy(np.ascontiguousarray(w, dtype=np.uint32)
                                 .view(np.int32))
        return w.to(device)
    return torch.from_numpy(_scalar_words_from_ints(
        scalars[lo:hi], order, n_words).view(np.int32)).to(device)


def msm_sharded(curve, points, scalars, mesh: Mesh,
                wbits: int = 0) -> AffinePoint:
    """sum_i scalars[i] points[i] over the mesh, as an oracle AffinePoint
    on every rank.  Every rank passes the whole input: `points` oracle
    AffinePoints or (x, y) words (n on the last axis), `scalars` ints or
    (n_words, n) u32 words; each rank keeps its block.  n must be a
    multiple of the mesh size."""
    cp = get_curve(curve) if isinstance(curve, str) else curve
    ops = get_curve_ops(cp.name)
    n = len(points) if _is_oracle_list(points) else int(points[0].shape[-1])
    D = mesh.size
    if n % D:
        raise ValueError(f"npoints {n} not divisible by mesh size {D}")
    m = n // D
    lo, hi = mesh.rank * m, (mesh.rank + 1) * m
    sf = cp.scalar
    wbits = wbits or window_bits(m, sf.bits)
    nwins = (sf.bits + wbits - 1) // wbits
    n_words = (sf.bits + 31) // 32
    st = MSMRoundStages(cp.name, wbits, nwins, n_words, KERNELS, mode="xyzz")
    words = _shard_scalars(scalars, sf.modulus, n_words, lo, hi,
                           mesh.device)
    rows = slab.point_rows(ops.F, *_shard_points(ops, points, lo, hi,
                                                 mesh.device))
    win = torch.stack(st.window_sums(words, rows))      # (4, W, nwins)
    del rows, words
    parts = [torch.empty_like(win) for _ in range(D)]
    dist.all_gather(parts, win, group=mesh.group)
    total = tuple(parts[0])
    for q in parts[1:]:
        total = KERNELS.add(cp.name, total, tuple(q))
    return collect(cp, wbits, nwins, *st.to_affine(total))
