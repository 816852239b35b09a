"""Slab (occupancy-capped, fixed-shape) MSM bucket accumulation: the port of
sppark_tpu/msm/slab.py.

  * The schedule gives every bucket one or more rows of a (cap, S) slot
    matrix, the slab: a bucket with occ <= cap owns one row, a bucket with
    occ > cap spills into ceil(occ / cap) consecutive replica rows drawn
    from a fixed budget, so the work stays linear in n for any scalars.
  * Slot r of row s names a row of the point-major gather table: the table
    holds every point, then every point negated, then the zero row, so the
    index also applies each digit's sign and blanks the empty slots.  The
    slot index, (cap, wg * S) int32, is built once per window group; no
    slab of points is materialized (the JAX package gathers one, with
    XLA): the madd reads each lane's point from the table through the
    index, a slab round needs no other work than its madd.
  * Round r adds the table's rows index[r] into per-row xyzz accumulators
    with one madd kernel launch over all rows of the group.
  * Replica rows fold back into their bucket by a pairwise tree of adds
    (lg(max rows per bucket) launches); bucket b's sum is at its rank-0 row.

The point ops are the stage's `kern` (ec/kernels.py): the kernels by
default, or their plain versions.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..ec.kernels import KERNELS, Kernels
from ..ff.bigmont import BigMontField
from ..ff.ext import Fp2Field

IDX_MASK = 0x7FFFFFFF


def plan_slab(n: int, nbuckets: int) -> tuple:
    """Static (cap, n_rows): cap ~= mean occupancy / 8 rounded to a power
    of two, clamped to [16, 512]; n_rows = nbuckets + ceil(n / cap)."""
    mean = max(1, n // nbuckets)
    cap = 1 << max(0, (mean // 8) - 1).bit_length() if mean >= 8 else 1
    cap = max(16, min(cap, 512))
    return cap, nbuckets + (n + cap - 1) // cap


def spread(vals, at, length: int):
    """Per-slot copy of per-bucket `vals` (W, B) whose bucket starts at slot
    `at[w, b]` (strictly ascending; the slab's rows, the tree's padded
    runs): a scatter of the differences between
    neighbours, then a cumulative sum.  The differences may be negative;
    the sum restores the values (the JAX package's u32 form relies on
    wrap-around instead)."""
    d = vals - torch.roll(vals, 1, dims=-1)
    d[:, 0] = vals[:, 0]
    out = torch.zeros((vals.shape[0], length), dtype=torch.int64,
                      device=vals.device)
    return torch.cumsum(out.scatter_add_(1, at, d), dim=1)


def make_slab_schedule(breakdown, nbuckets: int, cap: int, n_rows: int):
    """Schedule: breakdown, per-window stable bucket sort, capped row
    assignment.  Returns schedule(words) -> per-window int64 tensors

      sorted_val (nwins, n)       sign << 31 | index, in bucket order
      row_src    (nwins, n_rows)  start offset of each row's run
      row_len    (nwins, n_rows)  live points in the row (0..cap)
      row_bucket (nwins, n_rows)  owning bucket id
      row_rank   (nwins, n_rows)  replica rank within the bucket
      first_row  (nwins, B)       bucket -> its rank-0 row
      stats      (2,)             [max row_len, max rows per bucket]
    """

    def schedule(words):
        ids, signs = breakdown(words)
        W, n = ids.shape
        dev = ids.device
        payload = (torch.arange(n, dtype=torch.int64, device=dev)[None]
                   | (signs.to(torch.int64) << 31))
        sorted_ids, perm = torch.sort(ids, dim=-1, stable=True)
        sorted_val = torch.gather(payload, 1, perm)
        off = torch.arange(W, dtype=torch.int64, device=dev)[:, None]
        counts = torch.bincount(
            (sorted_ids + off * (nbuckets + 1)).reshape(-1),
            minlength=W * (nbuckets + 1)).reshape(W, nbuckets + 1)
        starts = torch.cumsum(counts, dim=1) - counts
        occ, base = counts[:, 1:], starts[:, 1:]
        rows_b = torch.clamp((occ + cap - 1) // cap, min=1)
        first = torch.cumsum(rows_b, dim=1) - rows_b
        bid = spread(torch.arange(nbuckets, dtype=torch.int64,
                                  device=dev).expand(W, -1), first, n_rows)
        rank = (torch.arange(n_rows, dtype=torch.int64, device=dev)[None]
                - spread(first, first, n_rows))
        src = spread(base, first, n_rows) + rank * cap
        length = torch.clamp(spread(occ, first, n_rows) - rank * cap,
                             0, cap)
        stats = torch.stack([length.max(), rows_b.max()])
        return sorted_val, src, length, bid, rank, first, stats

    return schedule


def point_rows(F: BigMontField | Fp2Field, px, py):
    """The slab's gather table (2n + 1, 2 W) int32, W the coordinate's words
    (n32, or 2 n32 for G2): row i is point i (x || y words, for G2 x0 || x1
    || y0 || y1 as the JAX package's leaves), row n + i is -point i, row 2n
    is the zero point (infinity)."""
    rows = torch.cat([torch.cat([px, py]).T, torch.cat([px, F.neg(py)]).T,
                      torch.zeros((1, 2 * px.shape[0]), dtype=px.dtype,
                                  device=px.device)])
    return rows.contiguous()


def slot_index(sorted_val, row_src, row_len, cap: int):
    """The slot index of one window group: (cap, wg * S) int32, slot r of
    row s the gather table's row of the r-th point of the row's run, signed
    (n + i for -point i), or 2n, the zero row, past the run's end."""
    wg, S = row_src.shape
    n = sorted_val.shape[-1]
    r = torch.arange(cap, dtype=torch.int64, device=row_src.device)
    src = torch.clamp(row_src[:, None, :] + r[None, :, None], max=n - 1)
    payload = torch.gather(sorted_val, 1, src.reshape(wg, cap * S))
    payload = payload.reshape(wg, cap, S).transpose(0, 1)
    valid = r[:, None, None] < row_len[None]
    gidx = torch.where(valid, (payload & IDX_MASK) + n * (payload >> 31),
                       2 * n)
    return gidx.reshape(cap, wg * S).to(torch.int32)


def madd_rounds(curve: str, rows, idx, rounds: int,
                kern: Kernels = KERNELS):
    """Rounds 0..rounds-1: each row's accumulator += the table's row
    idx[r] (rows: the gather table, idx: the slot index).  Returns the
    accumulators, four (W, wg * S) coordinates of W words each."""
    w = rows.shape[1] // 2
    table = (rows[:, :w].T, rows[:, w:].T)
    acc = (torch.zeros((w, idx.shape[1]), dtype=rows.dtype,
                       device=rows.device),) * 4
    for r in range(rounds):
        acc = kern.madd(curve, acc, table, idx[r])
    return acc


def fold_replicas(curve: str, acc, row_bucket, row_rank, max_rows: int,
                  kern: Kernels = KERNELS):
    """Pairwise tree over replica rows: at level l, a rank divisible by
    2^(l+1) adds the row 2^l to its right when that row is of the same
    bucket.  acc: four (W, wg * S) coordinates; returns (W, wg, S)."""
    wg, S = row_bucket.shape
    acc = tuple(c.reshape(c.shape[0], wg, S) for c in acc)
    sh = 1
    while sh < max_rows:
        partner = tuple(torch.roll(c, -sh, dims=-1) for c in acc)
        mask = ((torch.roll(row_bucket, -sh, dims=-1) == row_bucket)
                & (row_rank % (2 * sh) == 0))
        summed = kern.add(curve, acc, partner)
        acc = tuple(torch.where(mask, s, a) for s, a in zip(summed, acc))
        sh *= 2
    return acc


def extract(acc, first_row):
    """Bucket b's sum from its rank-0 row: four (W, wg, B)."""
    return tuple(torch.gather(c, 2, first_row[None].expand(
        c.shape[0], -1, -1)) for c in acc)


def accumulate(curve: str, cap: int, sorted_val, row_src, row_len,
               row_bucket, row_rank, first_row, stats, rows,
               kern: Kernels = KERNELS):
    """Bucket sums of one window group: the slot index, madd rounds,
    replica fold, extraction.  `stats` is the schedule's [max row_len, max
    rows per bucket] as ints."""
    with record_function("msm.gather"):
        idx = slot_index(sorted_val, row_src, row_len, cap)
    with record_function("msm.madd_rounds"):
        acc = madd_rounds(curve, rows, idx, stats[0], kern)
    del idx
    with record_function("msm.fold"):
        acc = fold_replicas(curve, acc, row_bucket, row_rank, stats[1], kern)
        return extract(acc, first_row)
