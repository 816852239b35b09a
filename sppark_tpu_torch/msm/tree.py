"""Segmented-tree batch-affine MSM accumulation: the port of
sppark_tpu/msm/tree.py (mode="tree").

  * The schedule sorts each window's points into bucket order once and
    pads every bucket's run to c_b = max(2, pow2ceil(occ_b)) slots, the
    padding holding the affine identity (0, 0).  Runs are laid out in
    descending size order, so each run starts at a multiple of its own size
    and the pairs (2i, 2i + 1) of every level stay inside one run.
  * Level 0 is an index, not a copy of the points: slot q names a row of
    the gather table (slab.point_rows: point i, -point i at n + i, the
    zero row 2n past a run's end), so the index applies each digit's sign
    and blanks the padding.  It is int32, split into the even and the odd
    slots (level0_index); the JAX package gathers the points themselves.
  * Each of lmax levels adds the even slots to the odd ones by the
    batch-affine pair add: the prep kernel, one batch inversion across
    every lane of the level (on the card the three launches of
    ff/kernels.py:mont_batch_inv), the finish kernel.  Level 1's prep and
    finish read l and r from the table through the two halves of the
    index; each later level's operands are views of the level below,
    read in place.
  * A run of c slots finishes at level lg(c); its bucket's sum is taken
    from that level as it is made (the JAX package concatenates every
    level and gathers once at the end: the same words).

Its cost is linear in n for any scalars: all-equal scalars cost one more
level per doubling of the largest bucket.  The point and field kernels are
the stage's `kern` (ec/kernels.py): the kernels by default, or their plain
versions.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..ec import get_curve_ops
from ..ec.kernels import KERNELS, Kernels
from .slab import IDX_MASK, spread


def batch_inv_flat(F, den):
    """1 / den over (W, *batch) words, all lanes in one inversion.  On the
    card the field's any-length batch inversion; on the CPU a product tree
    over the lanes flattened and padded with ones to a power of two
    (neutral in the tree).  Every lane must be non-zero."""
    if den.device.type != "cpu":
        return F.batch_inv(den)
    n = den[0].numel()
    flat = den.reshape(den.shape[0], n)
    p2 = 1 << max(0, n - 1).bit_length()
    if p2 != n:
        flat = torch.cat([flat, F.ones((p2 - n,), den.device)], dim=1)
    return F.batch_inv_tree(flat)[:, :n].reshape(den.shape)


def affine_pair_add(curve: str, l, r, kern: Kernels = KERNELS, idx=None):
    """l + r over affine (x, y) batches, lane by lane: either operand at
    infinity, doubling, cancellation (the port of tree.py:affine_pair_add
    and of pallas_ops.py:fused_affine_pair): prep -> batch inversion ->
    finish.  With idx = (idx_l, idx_r), l and r are tables read through
    them (ec/kernels.py)."""
    F = get_curve_ops(curve, kern.field).F
    den, flags = kern.pair_prep(curve, l, r, idx)
    return kern.pair_finish(curve, l, r, batch_inv_flat(F, den), flags, idx)


def make_tree_schedule(breakdown, nbuckets: int):
    """Schedule: breakdown, per-window stable bucket sort, padded layout.
    Returns schedule(words) -> per-window int64 tensors

      sorted_val (nwins, n)  sign << 31 | index, in bucket order
      base, occ  (nwins, B)  each bucket's run start and occupancy
      sb         (nwins, B)  the buckets in descending padded size
      pb2        (nwins, B)  padded run starts, in sb's order
      rb2o, lev  (nwins, B)  each bucket's padded start and finishing level
      stats      (2,)        [max over windows of sum_b c_b, max c_b]
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
        v = torch.clamp(occ, min=1) - 1             # pow2ceil, as u32 bits
        for s in (1, 2, 4, 8, 16):
            v = v | (v >> s)
        c = torch.clamp(v + 1, min=2)
        # descending size, stable: ascending bucket id on ties
        neg_c, sb = torch.sort(-c, dim=-1, stable=True)
        csum = torch.cumsum(-neg_c, dim=-1)
        pb2 = csum + neg_c                          # exclusive prefix
        rb2o = torch.zeros_like(c).scatter_(1, sb, pb2)
        lev = torch.frexp(c.to(torch.float64))[1].to(torch.int64) - 1
        stats = torch.stack([csum[:, -1].max(), c.max()])
        return sorted_val, base, occ, sb, pb2, rb2o, lev, stats

    return schedule


def plan_layout(stats) -> tuple:
    """(m0, lmax) from the schedule's stats as ints: the worst window's
    padded slot total rounded up to a multiple of 2^lmax, lmax = lg of the
    largest run."""
    total, maxc = stats
    lmax = max(1, maxc.bit_length() - 1)
    gran = 1 << lmax
    return -(-total // gran) * gran, lmax


def level0_index(sorted_val, base, occ, sb, pb2, m0: int):
    """Level 0 of a window group as an index into the gather table:
    (2, wg * m0 / 2) int32, row 0 the even slots and row 1 the odd ones.
    Slot q of window w (flat w * m0 + q) holds the table's row of the
    rank-th point of the run that covers q, signed (n + i for -point i),
    or 2n, the zero row, past the run's end."""
    wg, n = sorted_val.shape
    rb2 = spread(pb2, pb2, m0)
    rank = torch.arange(m0, dtype=torch.int64, device=rb2.device)[None] - rb2
    del rb2
    src = spread(torch.gather(base, 1, sb), pb2, m0).add_(rank)
    payload = torch.gather(sorted_val, 1, src.clamp_(max=n - 1))
    del src
    valid = rank < spread(torch.gather(occ, 1, sb), pb2, m0)
    del rank
    gidx = torch.where(valid, (payload & IDX_MASK) + n * (payload >> 31),
                       2 * n).to(torch.int32)
    return gidx.reshape(-1, 2).T.contiguous()


def accumulate(curve: str, m0: int, lmax: int, sorted_val, base, occ, sb,
               pb2, rb2o, lev, rows, kern: Kernels = KERNELS):
    """Affine bucket sums (x, y), each (W, wg, B), of one window group:
    level 0's index, level 1's pair adds read from the table `rows`
    through it, lmax - 1 more levels of pair adds on the level below,
    each bucket's sum taken at the level where its run finished (slot
    rb2o >> lev of its window)."""
    wg, B = lev.shape
    w = rows.shape[1] // 2
    with record_function("msm.gather"):
        idx = level0_index(sorted_val, base, occ, sb, pb2, m0)
    table = (rows[:, :w].T, rows[:, w:].T)      # (W, 2n + 1) views
    win = torch.arange(wg, dtype=torch.int64, device=lev.device)[:, None]
    bx = by = torch.zeros((w, wg * B), dtype=torch.int32, device=lev.device)
    for level in range(1, lmax + 1):
        with record_function("msm.tree_levels"):
            if level == 1:
                x, y = affine_pair_add(curve, table, table, kern,
                                       (idx[0], idx[1]))
                del idx
            else:
                x, y = affine_pair_add(curve, (x[:, 0::2], y[:, 0::2]),
                                       (x[:, 1::2], y[:, 1::2]), kern)
        with record_function("msm.extract"):
            done = (lev == level).reshape(-1)
            at = (win * (m0 >> level) + (rb2o >> level)).reshape(-1)
            bx = torch.where(done, x.index_select(1, at), bx)
            by = torch.where(done, y.index_select(1, at), by)
    return bx.reshape(w, wg, B), by.reshape(w, wg, B)
