"""Pippenger multi-scalar multiplication on G1 and G2: the port of
sppark_tpu/msm/pippenger.py's slab and tree pipelines (msm/pippenger.cuh
analogue).  A G2 curve runs the same stages on (2 n32, ...) fp2
coordinates (ff/ext.py), its point ops on the fp2 kernels.

  * breakdown: signed-digit encoding over (n_words, n) scalar words
    (pippenger.cuh:72-121), with the scalar fold (s > r/2 -> r - s, signs
    flipped) as a word-wise compare and borrow chain;
  * schedule and accumulate: the slab (msm/slab.py, mode "auto" or
    "slab"), the segmented tree (msm/tree.py, mode "tree"), or the
    histogram rounds of modes "xyzz" and "affine" (MSMRoundStages: in
    round r every bucket takes its r-th point, by one xyzz madd, or by
    one batch-affine pair add with the buckets kept affine); the round
    modes spread the top window's digits over replica buckets;
  * integrate: per-window sum_b b * bucket[b] as grouped strip reductions
    plus lg(C) doublings (pippenger.cuh:225-296, 627-665), shared by all,
    after the round modes' replica fold;
  * to_affine: one batch inversion over the (nwins,) window sums;
  * collect: the doubling merge of the window sums on the host over exact
    ints (pippenger.cuh:667-727).

The point and field kernels are the stages' `kern` (ec/kernels.py).  The
entry points (`MSMContext`, `mult_pippenger`) always use the kernels and
run on the CUDA card unless given device="cpu"; `MSMSlabStages(...,
kern=ec.kernels.PLAIN)` (or MSMTreeStages) runs the same pipeline on the
plain versions.

Each phase runs in a `torch.profiler.record_function` range: msm.schedule,
msm.gather, then msm.madd_rounds and msm.fold (slab), msm.tree_levels
and msm.extract (tree), msm.madd_rounds (xyzz) or msm.affine_rounds
(affine), msm.integrate, msm.to_affine; so a profile of a real invoke
splits its time by phase.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ..ec import get_curve_ops
from ..ec.kernels import KERNELS, Kernels
from ..ff.bigmont import BigMontField, get_field_ops
from ..ff.kernels import M32, words64
from ..oracle.ec import AffinePoint, get_oracle
from ..oracle.msm import window_bits
from ..params import get_curve
from ..runtime.dev_ptr import DevPtr
from ..runtime.devices import resolve
from . import slab, tree
from .slab import IDX_MASK


# -- scalar ingestion ----------------------------------------------------------------

def _scalar_words_from_ints(scalars: Sequence[int], order: int,
                            n_words: int) -> np.ndarray:
    """(n_words, n) u32 words of canonical scalars."""
    out = np.empty((n_words, len(scalars)), dtype=np.uint32)
    for c, s in enumerate(scalars):
        s %= order
        for i in range(n_words):
            out[i, c] = (s >> (32 * i)) & M32
    return out


def demont_scalar_words(F: BigMontField, words: torch.Tensor) -> torch.Tensor:
    """Montgomery-form scalar words (n_words, n) -> canonical words, on the
    words' device (the breakdown's optional from() conversion,
    pippenger.cuh:97).  The words are the scalar field's element layout,
    so this is one Montgomery product by 1."""
    return F.from_mont(words)


# -- breakdown ---------------------------------------------------------------------

def spread_policy(order: int, wbits: int, nwins: int, nbuckets: int):
    """(top_span, k): the top window's digits are at most top_max =
    (order / 2 >> (nwins - 1) wbits) + 1, top_span the power of two that
    covers them, and the round modes spread them over k = nbuckets /
    top_span replica slots (sppark_tpu/msm/pippenger.py:_spread_policy)."""
    top_max = (order // 2 >> ((nwins - 1) * wbits)) + 1
    top_span = 1 << (top_max - 1).bit_length() if top_max > 1 else 1
    k_spread = nbuckets // top_span if top_span < nbuckets else 1
    return top_span, k_spread


@functools.lru_cache(maxsize=None)
def make_breakdown(curve_name: str, wbits: int, nwins: int, n_words: int,
                   spread: bool = False):
    """Signed-digit breakdown: (n_words, n) canonical int32 words ->
    (ids (nwins, n) int64, signs (nwins, n) bool) (pippenger.cuh:72-121).
    With `spread` (the round modes; the slab and the tree take none) the
    top window's digit d of scalar i becomes d + (i mod k) top_span, its
    replica slot (spread_policy); digit 0 stays 0, no bucket.  The round
    modes' cost is linear in the largest bucket, and the top window's few
    digits concentrate its points."""
    order = get_curve(curve_name).scalar.modulus
    top_span, k_spread = spread_policy(order, wbits, nwins, 1 << (wbits - 1))
    if not spread:
        k_spread = 1
    half, full = 1 << (wbits - 1), 1 << wbits
    half_order_words = [(order // 2 >> (32 * i)) & M32
                        for i in range(n_words)]
    order_words = [(order >> (32 * i)) & M32 for i in range(n_words)]

    def breakdown(words):
        w = words64(words)
        n = w.shape[1]
        # scalar fold: s > order/2 -> order - s, every sign flipped
        gt = torch.zeros(n, dtype=torch.bool, device=w.device)
        eq = torch.ones(n, dtype=torch.bool, device=w.device)
        for i in reversed(range(n_words)):
            gt = gt | (eq & (w[i] > half_order_words[i]))
            eq = eq & (w[i] == half_order_words[i])
        neg = gt
        folded, borrow = [], torch.zeros(n, dtype=torch.int64,
                                          device=w.device)
        for i in range(n_words):
            d = order_words[i] - w[i] - borrow
            borrow = (d < 0).to(torch.int64)
            folded.append(d & M32)
        w_sel = [torch.where(neg, f, x) for f, x in zip(folded, w)]
        ids, signs = [], []
        carry = torch.zeros(n, dtype=torch.int64, device=w.device)
        for win in range(nwins):
            off = win * wbits
            wi, sh = off >> 5, off & 31
            raw = w_sel[wi] >> sh
            if sh and wi + 1 < n_words:
                raw = raw | (w_sel[wi + 1] << (32 - sh))
            t = (raw & (full - 1)) + carry
            # digits >= 2^(wbits-1) borrow from the next window, except in
            # the top window
            d_neg = t >= half if win < nwins - 1 else torch.zeros_like(neg)
            ids.append(torch.where(d_neg, full - t, t))
            carry = d_neg.to(torch.int64)
            signs.append(d_neg ^ neg)
        if k_spread > 1:
            rep = torch.arange(n, dtype=torch.int64,
                               device=w.device) % k_spread * top_span
            ids[-1] = torch.where(ids[-1] == 0, ids[-1], ids[-1] + rep)
        return torch.stack(ids), torch.stack(signs)

    return breakdown


# -- stages --------------------------------------------------------------------------

class _Stages:
    """What the accumulators share: the breakdown, the window grouping's
    budget, the integrate and to_affine.  A subclass gives schedule(words)
    and accumulate(sched, rows), which returns the bucket sums as xyzz
    points, four (W, nwins, nbuckets) coordinates."""

    #: live slot bytes per accumulate call (bounds the window grouping)
    BUDGET = 3 << 30
    #: whether the breakdown spreads the top window over replica buckets
    SPREAD = False

    def __init__(self, curve_name: str, wbits: int, nwins: int,
                 n_words: int, kern: Kernels = KERNELS):
        self.curve_name = curve_name
        self.wbits = wbits
        self.nwins = nwins
        self.nbuckets = 1 << (wbits - 1)
        self.kern = kern
        self.ops = get_curve_ops(curve_name, kern.field)
        self.top_span, self.k_spread = spread_policy(
            get_curve(curve_name).scalar.modulus, wbits, nwins,
            self.nbuckets) if self.SPREAD else (0, 1)
        self.breakdown = make_breakdown(curve_name, wbits, nwins, n_words,
                                        self.SPREAD)

    def _slot_bytes(self) -> int:
        """One point-major slot: two coordinates of W 32-bit words (W =
        n32, or 2 n32 for G2).  The slab now holds a 4-byte index a slot
        (slab.slot_index), but the budget still counts the point, so the
        window grouping and the launch shapes stay as they were."""
        return 2 * self.ops.F.words * 4

    def integrate(self, bucket):
        with record_function("msm.integrate"):
            return self._integrate(bucket)

    def fold_top(self, bucket):
        """The top window's replica buckets folded into its first
        top_span: slot (r, m) holds digit m + 1's r-th replica, and lg k
        pairwise adds sum the replicas; the other slots become infinity."""
        curve, k, span = self.curve_name, self.k_spread, self.top_span
        tops = tuple(c[:, -1].reshape(c.shape[0], k, span) for c in bucket)
        while tops[0].shape[1] > 1:
            tops = self.kern.add(curve, tuple(c[:, 0::2] for c in tops),
                                 tuple(c[:, 1::2] for c in tops))
        return tuple(torch.cat([b[:, :-1], torch.cat(
            [t[:, 0], torch.zeros_like(b[:, -1, span:])], dim=-1)[:, None]],
            dim=1) for b, t in zip(bucket, tops))

    def _integrate(self, bucket):
        """W_w = sum_b b * bucket[w, b] for every window: (W, nwins) x 4,
        after the top window's replica fold (fold_top) where the breakdown
        spread it.  Buckets split into G groups of C; strip sums T[g] =
        sum_c bucket[g, c] and R[g] = sum_c (c+1) bucket[g, c] run C
        serial adds over (nwins, G) lanes; then W = sum_g R[g] + C
        sum_{k>=1} SufT[k] with SufT the suffix sums of T, and C * (.) by
        lg(C) doublings."""
        curve, kern = self.curve_name, self.kern
        if self.k_spread > 1:
            bucket = self.fold_top(bucket)
        nwins, G = self.nwins, min(64, self.nbuckets)
        C = self.nbuckets // G
        words = bucket[0].shape[0]
        # (W, nwins, G * C) -> (C, W, nwins, G), c descending
        xs = [b.reshape(words, nwins, G, C).movedim(-1, 0).flip(0)
              for b in bucket]
        dev = bucket[0].device
        acc = res = self.ops.xyzz_infinity((nwins, G), dev)
        for c in range(C):
            acc = kern.add(curve, acc, tuple(x[c] for x in xs))
            res = kern.add(curve, res, acc)
        # (W, nwins, G) -> (G, W, nwins), g descending
        Ts = [t.movedim(-1, 0).flip(0) for t in acc]
        Rs = [r.movedim(-1, 0).flip(0) for r in res]
        accT = sum_suf = sum_res = self.ops.xyzz_infinity((nwins,), dev)
        for k in range(G):
            accT = kern.add(curve, accT, tuple(t[k] for t in Ts))
            if k < G - 1:               # group g = G-1-k >= 1
                sum_suf = kern.add(curve, sum_suf, accT)
            sum_res = kern.add(curve, sum_res, tuple(r[k] for r in Rs))
        for _ in range(int(math.log2(C))):
            sum_suf = kern.dbl(curve, sum_suf)
        return kern.add(curve, sum_res, sum_suf)

    def to_affine(self, win):
        with record_function("msm.to_affine"):
            return self.ops.xyzz_to_affine(win)

    def window_sums(self, words, rows):
        return self.integrate(self.accumulate(self.schedule(words), rows))

    def __call__(self, words, rows):
        return self.to_affine(self.window_sums(words, rows))


class MSMSlabStages(_Stages):
    """The slab pipeline's phases for one (curve, wbits): schedule,
    accumulate, integrate, to_affine, each on `kern`'s point and field
    functions."""

    def plan(self, n: int):
        """(cap, n_rows, wg): the slab's cap and rows per window, and the
        windows per accumulate call (equal groups)."""
        cap, n_rows = slab.plan_slab(n, self.nbuckets)
        per_win = cap * n_rows * self._slot_bytes()
        wg = max(1, min(self.nwins, self.BUDGET // per_win))
        while self.nwins % wg:          # equal groups
            wg -= 1
        return cap, n_rows, wg

    def schedule(self, words):
        cap, n_rows, _ = self.plan(words.shape[1])
        with record_function("msm.schedule"):
            return slab.make_slab_schedule(self.breakdown, self.nbuckets,
                                           cap, n_rows)(words)

    def accumulate(self, sched, rows):
        """Bucket sums (W, nwins, nbuckets) x 4 from the schedule and the
        gather table (slab.point_rows), one window group at a time."""
        sv, row_src, row_len, row_bucket, row_rank, first_row, stats = sched
        cap, _, wg = self.plan(sv.shape[1])
        stats = [int(v) for v in stats.tolist()]
        outs = []
        for lo in range(0, self.nwins, wg):
            g = slice(lo, lo + wg)
            outs.append(slab.accumulate(
                self.curve_name, cap, sv[g], row_src[g], row_len[g],
                row_bucket[g], row_rank[g], first_row[g], stats, rows,
                self.kern))
        return tuple(torch.cat(cs, dim=1) for cs in zip(*outs))


class MSMTreeStages(_Stages):
    """The segmented-tree pipeline's phases (msm/tree.py; the port of the
    JAX package's MSMTreeStages): its slot count m0 and depth lmax come
    from the schedule's bucket histogram, read on the host."""

    def plan(self, stats):
        """(m0, lmax, wg) from the schedule's stats: the windows per
        accumulate call keep ~3 m0 point slots under BUDGET, the count of
        a level 0 of gathered points, level 1 and the inversion's tree.
        Level 0 is now a 4-byte index a slot (tree.level0_index), but the
        budget still counts its points, so the window grouping and the
        launch shapes stay as they were."""
        m0, lmax = tree.plan_layout([int(v) for v in stats.tolist()])
        per_win = 3 * m0 * self._slot_bytes()
        return m0, lmax, max(1, min(self.nwins, self.BUDGET // per_win))

    def schedule(self, words):
        with record_function("msm.schedule"):
            return tree.make_tree_schedule(self.breakdown,
                                           self.nbuckets)(words)

    def accumulate(self, sched, rows):
        """Bucket sums (W, nwins, nbuckets) x 4 (xyzz) from the schedule
        and the gather table, one window group at a time."""
        m0, lmax, wg = self.plan(sched[-1])
        outs = []
        for lo in range(0, self.nwins, wg):
            g = slice(lo, lo + wg)
            outs.append(tree.accumulate(self.curve_name, m0, lmax,
                                        *(a[g] for a in sched[:-1]), rows,
                                        self.kern))
        aff = tuple(torch.cat(cs, dim=1) for cs in zip(*outs))
        return self.ops.affine_to_xyzz(aff)


class MSMRoundStages(_Stages):
    """The histogram rounds of the JAX package's modes "xyzz" and
    "affine" (sppark_tpu/msm/pippenger.py:_stage_bodies): a sort of each
    window's (sign, index) by bucket id gives bucket b its run [base[b],
    base[b] + occ[b]); in round r every bucket takes its run's r-th point,
    so rounds = the largest occupancy, read once on the host.  The top
    window is spread over replica buckets (make_breakdown), folded before
    the strip sums.  Mode "xyzz" adds a round's points to xyzz buckets by
    one madd launch that reads each point from the gather table
    (slab.point_rows) through the round's int32 index; mode "affine" keeps
    the buckets affine and adds a round's points by one batch-affine pair
    add (tree.affine_pair_add: prep, the batch inversion, finish), the
    finish and prep reading the point through the same index."""

    SPREAD = True

    def __init__(self, curve_name: str, wbits: int, nwins: int,
                 n_words: int, kern: Kernels = KERNELS,
                 mode: str = "xyzz"):
        super().__init__(curve_name, wbits, nwins, n_words, kern)
        self.mode = mode

    def schedule(self, words):
        """(sorted_val (nwins, n) int64: sign << 31 | index in bucket
        order; base, occ (nwins, nbuckets); rounds, an int)."""
        with record_function("msm.schedule"):
            ids, signs = self.breakdown(words)
            W, n = ids.shape
            dev = ids.device
            payload = (torch.arange(n, dtype=torch.int64, device=dev)[None]
                       | (signs.to(torch.int64) << 31))
            sorted_ids, perm = torch.sort(ids, dim=-1, stable=True)
            sorted_val = torch.gather(payload, 1, perm)
            del payload, perm
            nb = self.nbuckets
            off = torch.arange(W, dtype=torch.int64, device=dev)[:, None]
            counts = torch.bincount(
                (sorted_ids + off * (nb + 1)).reshape(-1),
                minlength=W * (nb + 1)).reshape(W, nb + 1)
            starts = torch.cumsum(counts, dim=1) - counts
            occ, base = counts[:, 1:], starts[:, 1:]
            return sorted_val, base, occ, int(occ.max())

    def round_index(self, sorted_val, base, occ, r0: int, r1: int):
        """Rounds r0..r1-1's gather-table rows, (r1 - r0, nwins *
        nbuckets) int32: bucket b's r-th point i, n + i where its digit
        is negative, 2n (the zero row) past its run's end."""
        W, n = sorted_val.shape
        r = torch.arange(r0, r1, dtype=torch.int64,
                         device=base.device)[None, :, None]
        pos = torch.clamp(base[:, None] + r, max=n - 1)
        val = torch.gather(sorted_val, 1, pos.reshape(W, -1)).reshape(
            pos.shape)
        gidx = torch.where(r < occ[:, None], (val & IDX_MASK)
                           + n * (val >> 31), 2 * n)
        return gidx.transpose(0, 1).reshape(r1 - r0, -1).to(torch.int32)

    def accumulate(self, sched, rows):
        """Bucket sums (W, nwins, nbuckets) x 4 (xyzz) from the schedule
        and the gather table: the rounds' index built a block of rounds at
        a time within BUDGET, then one madd (xyzz) or one pair add
        (affine) a round."""
        sorted_val, base, occ, rounds = sched
        curve, kern = self.curve_name, self.kern
        w = rows.shape[1] // 2
        table = (rows[:, :w].T, rows[:, w:].T)      # (W, 2n + 1) views
        lanes = self.nwins * self.nbuckets
        block = max(1, self.BUDGET // (32 * lanes))
        affine = self.mode == "affine"
        acc = tuple(torch.zeros((w, lanes), dtype=rows.dtype,
                                device=rows.device)
                    for _ in range(2 if affine else 4))
        for r0 in range(0, rounds, block):
            r1 = min(rounds, r0 + block)
            with record_function("msm.gather"):
                idx = self.round_index(sorted_val, base, occ, r0, r1)
            with record_function("msm.affine_rounds" if affine
                                 else "msm.madd_rounds"):
                for k in range(r1 - r0):
                    acc = (tree.affine_pair_add(curve, acc, table, kern,
                                                (None, idx[k])) if affine
                           else kern.madd(curve, acc, table, idx[k]))
            del idx
        if affine:
            acc = self.ops.affine_to_xyzz(acc)
        return tuple(c.reshape(w, self.nwins, self.nbuckets) for c in acc)


_STAGES = {"auto": MSMSlabStages, "slab": MSMSlabStages,
           "tree": MSMTreeStages,
           **{m: functools.partial(MSMRoundStages, mode=m)
              for m in ("xyzz", "affine")}}


def collect(curve, wbits: int, nwins: int, wx, wy) -> AffinePoint:
    """Host window merge: MSB-first doubling merge of the per-window affine
    sums (collect(), pippenger.cuh:667-727) over exact ints.  An empty
    window is the affine (0, 0) of its degree: both coordinates zero in
    every coefficient."""
    o = get_oracle(curve)
    pts = get_curve_ops(curve.name).affine_to_ints((wx, wy))
    total = o.infinity_jacobian()
    for w in reversed(range(nwins)):
        for _ in range(wbits):
            total = o.jacobian_dbl(total)
        x, y = pts[w]
        if (x, y) != (o.zero, o.zero):
            total = o.jacobian_add(total, o.to_jacobian(AffinePoint(x, y)))
    return o.jacobian_to_affine(total)


# -- entry points ----------------------------------------------------------------------

def _resolve_points(points):
    """A DevPtr, an integer DevPtr handle, or the points themselves."""
    if isinstance(points, DevPtr):
        return points.value
    if isinstance(points, int):
        return DevPtr.from_handle(points).value
    return points


def _is_oracle_list(points) -> bool:
    return isinstance(points, (list, tuple)) and bool(points) and \
        hasattr(points[0], "x")


class MSMContext:
    """Per-(curve, npoints) MSM engine (msm_t, pippenger.cuh:325): the
    window policy and the stages, and optionally a device-resident point
    set reused across invocations (pippenger.cuh:377-383, 582-601).

    `mode` picks the accumulator: "auto" or "slab" (msm/slab.py), "tree"
    (msm/tree.py), or the rounds of "xyzz" and "affine"
    (MSMRoundStages); all give the same point.
    `chunk` sizes the window policy and the stages to a chunk of points;
    longer inputs run chunk by chunk, and the chunks' window sums combine
    with one xyzz add each (pippenger.cuh:454-459, 496-556).  Points given
    as numpy arrays stay on the host and upload chunk by chunk."""

    def __init__(self, curve, npoints: int, wbits: int = 0,
                 mode: str = "auto", chunk: int = 0, device=None):
        if mode not in _STAGES:
            raise NotImplementedError(
                f"MSM mode {mode!r} is unknown: the modes are "
                f"{sorted(_STAGES)}")
        self.curve = get_curve(curve) if isinstance(curve, str) else curve
        self.device = resolve(device)
        self.ops = get_curve_ops(self.curve.name)
        self.npoints = npoints
        sf = self.curve.scalar
        self.chunk = min(chunk, npoints) if chunk else npoints
        self.wbits = wbits or window_bits(self.chunk, sf.bits)
        self.nwins = (sf.bits + self.wbits - 1) // self.wbits
        self.nbuckets = 1 << (self.wbits - 1)
        self.n_words = (sf.bits + 31) // 32
        self.stages = _STAGES[mode](self.curve.name, self.wbits,
                                    self.nwins, self.n_words)
        #: the resident points, kept only where no gather table is built
        #: (chunked or host-streamed points)
        self._points = None
        #: the resident points' gather table (slab.point_rows), built by
        #: set_points when the points sit on the device in one chunk; it
        #: holds every point, so the points themselves are not kept
        self.rows = None
        self._n_set = 0

    # -- points ------------------------------------------------------------------
    def _device_points(self, points):
        """Oracle points or (x, y) words -> (x, y) int32 words on the
        device; numpy (x, y) arrays stay on the host."""
        if _is_oracle_list(points):
            return self.ops.affine_from_ints(points, self.device)
        if all(isinstance(a, np.ndarray) for a in points):
            return tuple(np.ascontiguousarray(a).view(np.int32)
                         for a in points)
        return tuple(a.to(self.device) for a in points)

    def set_points(self, points) -> DevPtr:
        """Keep a point batch for reuse; device-resident points also get
        their gather table built once.  Returns a DevPtr over the batch
        (the gpu_ptr_t contract: clone/drop, an integer handle that
        `invoke` and `set_points` accept back)."""
        pts = self._device_points(_resolve_points(points))
        self._n_set = pts[0].shape[-1]
        self._points = self.rows = None
        if isinstance(pts[0], torch.Tensor) and self._n_set <= self.chunk:
            self.rows = slab.point_rows(self.ops.F, *pts)
        else:
            self._points = pts
        return DevPtr(pts)

    def _scalar_words(self, scalars, mont: bool) -> torch.Tensor:
        if isinstance(scalars, (np.ndarray, torch.Tensor)) and \
                scalars.ndim == 2:
            words = scalars
            if isinstance(words, np.ndarray):
                words = torch.from_numpy(np.ascontiguousarray(
                    words, dtype=np.uint32).view(np.int32))
            words = words.to(self.device)
            if mont:
                words = demont_scalar_words(
                    get_field_ops(self.curve.scalar), words)
            return words
        return torch.from_numpy(_scalar_words_from_ints(
            scalars, self.curve.scalar.modulus, self.n_words).view(
                np.int32)).to(self.device)

    # -- invocation ----------------------------------------------------------------
    def invoke(self, scalars, points=None, mont: bool = False) -> AffinePoint:
        """sum_i scalars[i] * points[i] as an oracle AffinePoint (exact
        ints).  `scalars`: ints, or (n_words, n) u32 words (numpy, or a
        tensor, on the device or not), Montgomery form if `mont`."""
        if points is None:
            if not self._n_set:
                raise ValueError("no points: pass them or call set_points")
            pts, rows, npts = self._points, self.rows, self._n_set
        else:
            pts, rows = self._device_points(_resolve_points(points)), None
            npts = pts[0].shape[-1]
        words = self._scalar_words(scalars, mont)
        n = words.shape[1]
        if npts != n:
            raise ValueError(f"{n} scalars for {npts} points")
        st = self.stages
        if n <= self.chunk:
            if rows is None:
                pts = tuple(torch.as_tensor(a).to(self.device) for a in pts)
                rows = slab.point_rows(self.ops.F, *pts)
            return self._collect(*st(words, rows))
        # chunked: window sums are linear in the points, so chunks combine
        # with one (nwins,)-lane add each; a short tail chunk pads its
        # points with the last one and its scalars with zeros
        starts = list(range(0, n, self.chunk))

        def chunk_rows(lo):
            hi = min(lo + self.chunk, n)
            cut = [torch.as_tensor(a[:, lo:hi]) for a in pts]
            if hi - lo < self.chunk:
                cut = [torch.cat([c, c[:, -1:].expand(-1, self.chunk
                                                       - (hi - lo))], 1)
                       for c in cut]
            cut = [c.to(self.device, non_blocking=True) for c in cut]
            return slab.point_rows(self.ops.F, *cut)

        total = None
        nxt = chunk_rows(starts[0])
        for i, lo in enumerate(starts):
            w = words[:, lo:lo + self.chunk]
            if w.shape[1] < self.chunk:
                w = torch.nn.functional.pad(w, (0, self.chunk - w.shape[1]))
            rows = nxt
            if i + 1 < len(starts):
                nxt = chunk_rows(starts[i + 1])   # stage the next chunk
            win = st.window_sums(w, rows)
            total = win if total is None else \
                st.kern.add(self.curve.name, total, win)
        return self._collect(*st.to_affine(total))

    def _collect(self, wx, wy) -> AffinePoint:
        return collect(self.curve, self.wbits, self.nwins, wx, wy)


def mult_pippenger(curve, points, scalars, mont: bool = False,
                   wbits: int = 0, device=None) -> AffinePoint:
    """One-shot MSM (msm/pippenger.cuh:731-748): points are oracle
    AffinePoints or (x, y) words; scalars ints or (n_words, n) words."""
    if _is_oracle_list(points):
        n = len(points)
    else:
        n = int(_resolve_points(points)[0].shape[-1])
    ctx = MSMContext(curve, n, wbits=wbits, device=device)
    return ctx.invoke(scalars, points=points, mont=mont)
