"""Flat batched point addition (msm/batch_addition.cuh): the port of
sppark_tpu/msm/batch_addition.py.

The sum of the points whose bitmap bit is set, each negated where its
refmap bit is set, as one affine point.  The points go into the MSM's
gather table (slab.point_rows: point i, -point i at row n + i, the zero
row 2n), so a bit and a ref bit are only a row of the index.  K lanes
each add a chunk of C = ceil(n / K) points, one madd launch a chunk
position for every lane at once (the point c K + k on lane k, the zero
row past n or where the bit is clear), then lg K launches of the xyzz add
fold the lanes pairwise, and one batch normalisation makes the sum
affine.  The default K makes C = lg n, so a batch of n points costs
O(lg n) launches, where the JAX package's scan runs n / 128 sequential
madds; the affine sum is unique, so any K gives the same point.  On the
card the point kernels run (ec/kernels.py), on CPU tensors their plain
versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ec import get_curve_ops
from ..ec import kernels as EK
from ..oracle.ec import AffinePoint, get_oracle
from ..params import get_curve
from ..runtime.devices import resolve
from . import slab


def _bits(bits, n: int, default: int, dev) -> torch.Tensor:
    if bits is None:
        return torch.full((n,), default, dtype=torch.int64, device=dev)
    return torch.as_tensor(np.asarray(bits, dtype=np.int64),
                           device=dev) != 0


def batch_addition(curve, points, bitmap=None, refmap=None, lanes: int = 0,
                   device=None) -> AffinePoint:
    """Sum the points where `bitmap` is set, negated where `refmap` is set
    (batch_addition.cuh's semantics; no bitmap selects every point).
    `points`: oracle AffinePoints, or (x, y) coordinate words (on their own
    device); the bitmaps: sequences or arrays of 0 / 1.  `lanes`: K, the
    lanes that add in parallel (0: n / lg n).  An empty selection gives
    the oracle's infinity."""
    cp = get_curve(curve) if isinstance(curve, str) else curve
    ops = get_curve_ops(cp.name)
    if isinstance(points, (list, tuple)) and points and \
            hasattr(points[0], "x"):
        dev = resolve(device)
        pts = ops.affine_from_ints(points, dev)
    else:
        pts = tuple(points)
        dev = pts[0].device
    n = pts[0].shape[-1]
    bits = _bits(bitmap, n, 1, dev).to(torch.int64)
    refs = _bits(refmap, n, 0, dev).to(torch.int64)
    K = lanes or max(1, -(-n // max(1, n.bit_length() - 1)))
    C = -(-n // K)
    rows = slab.point_rows(ops.F, *pts)
    w = rows.shape[1] // 2
    table = (rows[:, :w].T, rows[:, w:].T)
    # the table's row for chunk position c of lane k: point c K + k
    i = torch.arange(C * K, dtype=torch.int64, device=dev)
    live = i < n
    i = torch.where(live, i, 0)
    idx = torch.where(live & (bits[i] != 0), i + n * refs[i], 2 * n)
    idx = idx.reshape(C, K).to(torch.int32)
    acc = ops.xyzz_infinity((K,), dev)
    for c in range(C):
        acc = EK.xyzz_madd(cp.name, acc, table, idx[c])
    # fold the lanes pairwise, padded with infinity to a power of two
    k2 = 1 << max(0, K - 1).bit_length()
    acc = tuple(torch.cat([a, torch.zeros((a.shape[0], k2 - K),
                                          dtype=a.dtype, device=dev)], 1)
                for a in acc)
    while acc[0].shape[1] > 1:
        h = acc[0].shape[1] // 2
        acc = EK.xyzz_add(cp.name, tuple(a[:, :h] for a in acc),
                          tuple(a[:, h:] for a in acc))
    x, y = ops.affine_to_ints(ops.xyzz_to_affine(acc))[0]
    o = get_oracle(cp)
    if x == o.zero and y == o.zero:
        return o.infinity_affine()
    return AffinePoint(x, y, False)
