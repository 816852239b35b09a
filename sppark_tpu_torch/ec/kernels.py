"""The point kernels' wrappers, each beside its plain PyTorch version.

`xyzz_madd`, `xyzz_add` and `xyzz_dbl` run, for G1 curves, csrc/
ec_xyzz.cu's ec_xyzz_madd / ec_xyzz_add / ec_xyzz_dbl and, for G2 curves,
ec_fp2_xyzz_madd / ec_fp2_xyzz_add / ec_fp2_xyzz_dbl (csrc/ec_fp2_madd.cu,
ec_fp2_add.cu, ec_fp2_dbl.cu): the ports of sppark_tpu/ec/pallas_ops.py:
_madd_call, _add_call and _dbl_call in degree 1 and 2.  `affine_pair_prep`
and `affine_pair_finish`, the two halves of the segmented-tree MSM's
batch-affine pair add, run ec_pair_prep / ec_pair_finish (csrc/
ec_pair.cu) and ec_fp2_pair_prep / ec_fp2_pair_finish (csrc/
ec_fp2_pair.cu): the ports of _pair_prep_call and _pair_finish_call.  On
a CUDA tensor a wrapper launches its curve's kernel on the current stream
or raises; on a CPU tensor it computes the same function with the plain
version, over plain field arithmetic.  Each launch adds one to
`launches[name]` (G1) or `fp2_launches[name]` (G2).

Every coordinate is `(W, *batch)` int32 words, W = n32 for G1 and 2 n32
for G2 (c0's words, then c1's); batch shapes broadcast.  An input
coordinate reaches the kernel as a view (a pointer and its word and lane
strides) when its batch dimensions merge into one, so the even and odd
slots of a tree level and broadcast constants are read in place; the
output is one new block: (4, W, *batch) for the xyzz ops, returned as four
coordinates; den and a flag word per lane for the pair prep; (x, y) for
the pair finish.  A point operand may instead be a table, two (W, rows)
coordinates, read through an int32 index of one row per lane: the madd's
affine point (the slab MSM's point table and slot index, msm/slab.py)
and the pair kernels' l and r on a tree's first level (the same table,
through the even and odd halves of the tree's level-0 index,
msm/tree.py), read by the kernels in place of a gathered copy; the
pair kernels' r alone may be a table, l then per-lane (the affine MSM
mode's rounds: the buckets, and each bucket's next point through the
table).  The test curves over the one-word fields (ff/lane.py) have no
kernel: their wrappers run the plain versions on every device, as the JAX
package runs those curves through no Pallas kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import _build
from ..ff import kernels as FK
from ..ff.lane import is_lane_field
from ..params import get_curve
from ..util.errors import SpparkError
from .core import get_curve_ops

launches = {"ec_xyzz_madd": 0, "ec_xyzz_add": 0, "ec_xyzz_dbl": 0,
            "ec_pair_prep": 0, "ec_pair_finish": 0}
fp2_launches = {"ec_fp2_xyzz_madd": 0, "ec_fp2_xyzz_add": 0,
                "ec_fp2_xyzz_dbl": 0, "ec_fp2_pair_prep": 0,
                "ec_fp2_pair_finish": 0}
#: the kernels of each accumulator: the slab's and the tree's
SLAB_OPS = ("xyzz_madd", "xyzz_add", "xyzz_dbl")
TREE_OPS = ("pair_prep", "pair_finish", "xyzz_add", "xyzz_dbl")


def reset_launches() -> None:
    for counts in (launches, fp2_launches):
        for k in counts:
            counts[k] = 0


#: each kernel's source, csrc/<source>.cu: the G1 xyzz kernels share one,
#: each fp2 xyzz kernel has its own, so nvcc builds them at once; the pair
#: kernels have one per degree
SOURCES = {"ec_xyzz_madd": "ec_xyzz", "ec_xyzz_add": "ec_xyzz",
           "ec_xyzz_dbl": "ec_xyzz", "ec_fp2_xyzz_madd": "ec_fp2_madd",
           "ec_fp2_xyzz_add": "ec_fp2_add", "ec_fp2_xyzz_dbl": "ec_fp2_dbl",
           "ec_pair_prep": "ec_pair", "ec_pair_finish": "ec_pair",
           "ec_fp2_pair_prep": "ec_fp2_pair",
           "ec_fp2_pair_finish": "ec_fp2_pair"}
_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib(name: str) -> ctypes.CDLL:
    source = SOURCES[name]
    return _build.load(source, {k: [_I, _VP, _VP, _LL, _VP, _VP]
                                for k, s in SOURCES.items() if s == source})


@functools.lru_cache(maxsize=None)
def _consts(curve: str) -> np.ndarray:
    cp = get_curve(curve)
    return FK.field_consts(cp.field, cp.a4,
                           cp.fp2.nr_small if cp.fp2 else 0)


def kernel_name(op: str, curve: str) -> str:
    """The kernel of op ("xyzz_madd", ..., "pair_finish") for `curve`'s
    degree."""
    return ("ec_" if get_curve(curve).degree == 1 else "ec_fp2_") + op


def _launch(op: str, curve: str, coords, flags=None, idx=None):
    """Run op on the card over `coords` (and, for the pair finish, the
    flag word per lane).  `idx`, where given, has one entry a coordinate:
    None for a per-lane coordinate, or an int32 index for a coordinate
    that is a (W, rows) table, of which lane i reads row idx[i].  Returns
    the output block (rows, *batch): 4 W rows for the xyzz ops, W + 1 for
    the pair prep, 2 W for the finish."""
    cp = get_curve(curve)
    degree = cp.degree
    name = kernel_name(op, curve)
    FK.check_words(name, cp.field, *coords, degree=degree)
    idx = tuple(idx) if idx is not None else (None,) * len(coords)
    lane = [c for c, i in zip(coords, idx) if i is None]
    if lane:
        lane = list(torch.broadcast_tensors(*lane))
        batch = tuple(lane[0].shape[1:])
    else:
        batch = tuple(next(i for i in idx if i is not None).shape)
    n32, words = cp.field.n_ref_limbs, coords[0].shape[0]
    if flags is not None:
        if flags.dtype != torch.int32 or tuple(flags.shape) != batch or \
                flags.device != coords[0].device:
            raise ValueError(f"{name}: flags must be int32 of shape {batch} "
                             f"on {coords[0].device}")
    rows = {"pair_prep": words + 1, "pair_finish": 2 * words}.get(
        op, 4 * words)
    n = math.prod(batch)
    out = torch.empty((rows,) + batch, dtype=torch.int32,
                      device=coords[0].device)
    if n == 0:
        return out
    lane = iter(lane)
    kept = [c if i is not None else next(lane).reshape(c.shape[0], n)
            for c, i in zip(coords, idx)]      # a copy only if needed
    idx = [i if i is None else i.contiguous() for i in idx]
    if flags is not None:
        kept.append(flags[None])
        idx.append(None)
    views = np.zeros(5 * len(kept), dtype=np.int64)
    for k, (v, i) in enumerate(zip(kept, idx)):
        views[5 * k:5 * k + 3] = (v.data_ptr(), v.stride(0), v.stride(1))
        if i is not None:
            views[5 * k + 3:5 * k + 5] = (i.data_ptr(), v.shape[1])
    with torch.cuda.device(out.device):
        rc = getattr(_lib(name), name)(
            n32, views.ctypes.data, out.data_ptr(), n,
            _consts(curve).ctypes.data,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SpparkError(rc, f"{name}: CUDA error {rc}")
    (launches if degree == 1 else fp2_launches)[name] += 1
    return out


def _xyzz(out):
    return tuple(out.reshape((4, -1) + tuple(out.shape[1:])))


def _on_cpu(coords) -> bool:
    return all(c.device.type == "cpu" for c in coords)


@functools.lru_cache(maxsize=None)
def has_kernels(curve: str) -> bool:
    """Whether `curve`'s point ops have kernels: a multi-limb Montgomery
    base field.  A test curve over a one-word field has none."""
    return not is_lane_field(get_curve(curve).field)


def _plain(curve: str, coords) -> bool:
    """Whether a wrapper runs its plain version: on CPU tensors, or for
    a curve with no kernels on any device."""
    return _on_cpu(coords) or not has_kernels(curve)


def _check_idx(name: str, table, idx, lanes) -> None:
    """Refuse a table index a kernel cannot take: other than a 1-D int32
    tensor of the lane count on the table's device, or a table other than
    two (W, rows) coordinates of fewer than 2^31 rows.  `lanes`: the
    per-lane operands (the madd's bucket, the finish's inv), each
    (W, n) with n the index's length, not broadcast.  An index value
    outside [0, rows) makes the plain version raise and the kernel trap,
    as PyTorch's own index kernels do."""
    if not isinstance(idx, torch.Tensor) or idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be an int32 tensor")
    if len(table) != 2 or any(c.ndim != 2 or c.shape[1] != table[0].shape[1]
                              for c in table) or \
            table[0].shape[1] >= 1 << 31:
        raise ValueError(f"{name}: the table must be two (W, rows) "
                         f"coordinates of fewer than 2^31 rows")
    dev = table[0].device
    if idx.device != dev or idx.ndim != 1 or any(
            tuple(c.shape[1:]) != tuple(idx.shape) for c in lanes):
        raise ValueError(f"{name}: idx must be a 1-D tensor of the "
                         f"operands' lanes on {dev}")


def _check_pair_idx(name: str, l, r, idx, lanes=()) -> None:
    """Refuse what the indexed pair kernels cannot take: idx other than a
    pair (idx_l, idx_r) of equal length, each an index _check_idx takes
    into its table (l, r); or idx_l None, l then per-lane coordinates of
    idx_r's length, not broadcast."""
    if not isinstance(idx, (tuple, list)) or len(idx) != 2:
        raise TypeError(f"{name}: idx must be a pair (idx_l, idx_r)")
    if idx[0] is None:
        _check_idx(name, r, idx[1], tuple(l) + tuple(lanes))
        return
    for t, i in ((l, idx[0]), (r, idx[1])):
        _check_idx(name, t, i, lanes)
    if idx[0].shape != idx[1].shape:
        raise ValueError(f"{name}: idx_l and idx_r must be of one length")


def _gather_pair(l, r, idx):
    """l and r with their tables' rows gathered: l per-lane where idx_l
    is None."""
    return (l if idx[0] is None else _gather(l, idx[0])), _gather(r, idx[1])


# -- plain versions ------------------------------------------------------------------

def _gather(table, idx):
    """The table's rows idx: (W, len(idx)) coordinates."""
    return tuple(c.index_select(1, idx) for c in table)


def xyzz_madd_plain(curve: str, p, a, idx=None, sign=None):
    """Plain version of ec_xyzz_madd and ec_fp2_xyzz_madd; with `idx`, the
    table a's rows idx gathered first; with `sign` (bool lanes), the
    point subtracted where it is set."""
    if idx is not None:
        _check_idx(kernel_name("xyzz_madd", curve), a, idx, p)
        a = _gather(a, idx)
    return get_curve_ops(curve, FK.PLAIN).xyzz_madd(p, a, sign)


def xyzz_add_plain(curve: str, p, q):
    """Plain version of ec_xyzz_add and ec_fp2_xyzz_add."""
    return get_curve_ops(curve, FK.PLAIN).xyzz_add(p, q)


def xyzz_dbl_plain(curve: str, p):
    """Plain version of ec_xyzz_dbl and ec_fp2_xyzz_dbl."""
    return get_curve_ops(curve, FK.PLAIN).xyzz_dbl(p)


#: the pair prep's flag word (pallas_ops.py:_pair_prep_call; csrc/pair.cuh)
ACTIVE, DBL, USE_R, USE_L = 1, 2, 4, 8


def affine_pair_prep_plain(curve: str, l, r, idx=None):
    """Plain version of ec_pair_prep and ec_fp2_pair_prep: for affine l =
    (x1, y1) and r = (x2, y2), (den, flags); with idx = (idx_l, idx_r), l
    and r are tables, gathered first.  den is the chord's x2 - x1,
    the tangent's 2 y1, or 1 where there is nothing to invert; flags (int32
    per lane) is the TPU kernel's word bit for bit: ACTIVE (a chord or
    tangent), DBL (active and l == r), USE_R (l infinite, r not), USE_L (r
    infinite, l not).  l == -r and a y1 == 0 doubling are neither active
    nor a copy: their sum is infinity."""
    if idx is not None:
        _check_pair_idx(kernel_name("pair_prep", curve), l, r, idx)
        l, r = _gather_pair(l, r, idx)
    F = get_curve_ops(curve, FK.PLAIN).F
    (x1, y1), (x2, y2) = l, r
    x1, y1, x2, y2 = torch.broadcast_tensors(x1, y1, x2, y2)
    inf_l = F.is_zero(x1) & F.is_zero(y1)
    inf_r = F.is_zero(x2) & F.is_zero(y2)
    dx, dy = F.sub(x2, x1), F.sub(y2, y1)
    same_x = F.is_zero(dx) & ~inf_l & ~inf_r
    dbl = same_x & F.is_zero(dy)
    toinf = (same_x & ~F.is_zero(dy)) | (dbl & F.is_zero(y1))
    active = ~inf_l & ~inf_r & ~toinf
    den = F.select(active, F.select(dbl, F.add(y1, y1), dx),
                   F.ones(x1.shape[1:], x1.device))
    flags = (active.to(torch.int32) * ACTIVE
             | (dbl & active).to(torch.int32) * DBL
             | (inf_l & ~inf_r).to(torch.int32) * USE_R
             | (inf_r & ~inf_l).to(torch.int32) * USE_L)
    return den, flags


def affine_pair_finish_plain(curve: str, l, r, inv, flags, idx=None):
    """Plain version of ec_pair_finish and ec_fp2_pair_finish: l + r from
    inv = 1 / den and prep's flags (with idx, l and r tables gathered
    first, as in affine_pair_prep_plain).  lambda = (y2 - y1) inv, or (3 x1^2 +
    a4) inv where DBL; x3 = lambda^2 - x1 - x2, y3 = lambda (x1 - x3) - y1;
    then the selects in the TPU kernel's order: active -> USE_R -> USE_L."""
    if idx is not None:
        _check_pair_idx(kernel_name("pair_finish", curve), l, r, idx, (inv,))
        l, r = _gather_pair(l, r, idx)
    cp = get_curve(curve)
    F = get_curve_ops(curve, FK.PLAIN).F
    (x1, y1), (x2, y2) = l, r
    x1, y1, x2, y2, inv = torch.broadcast_tensors(x1, y1, x2, y2, inv)
    bit = lambda b: (flags & b) != 0                     # noqa: E731
    x1sq = F.sqr(x1)
    tangent = F.add(F.add(x1sq, x1sq), x1sq)
    if cp.a4:
        tangent = F.add(tangent, F.const(cp.a4, x1.shape[1:], x1.device))
    lam = F.mul(F.select(bit(DBL), tangent, F.sub(y2, y1)), inv)
    x3 = F.sub(F.sub(F.sqr(lam), x1), x2)
    y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
    zero = torch.zeros_like(x1)
    ox, oy = F.select(bit(ACTIVE), x3, zero), F.select(bit(ACTIVE), y3, zero)
    ox, oy = F.select(bit(USE_R), x2, ox), F.select(bit(USE_R), y2, oy)
    return F.select(bit(USE_L), x1, ox), F.select(bit(USE_L), y1, oy)


# -- kernels -------------------------------------------------------------------------

def _signed_table(curve: str, p, a, idx, sign):
    """(p, table, index) that subtract where `sign` is set through the
    kernel's table index, as the MSM's negated rows do (slab.point_rows):
    the table a (per-lane points a: a table of one row a lane, p's batch
    flattened) beside its negation, rows r.., and the index idx + r sign."""
    F = get_curve_ops(curve).F
    if idx is None:
        batch = p[0].shape[1:]
        p = tuple(c.reshape(c.shape[0], -1) for c in p)
        a = tuple(c.expand((c.shape[0],) + batch).reshape(c.shape[0], -1)
                  for c in a)
        idx = torch.arange(p[0].shape[1], dtype=torch.int32,
                           device=p[0].device)
    rows = a[0].shape[1]
    if 2 * rows >= 1 << 31:
        raise ValueError("xyzz_madd: a signed table of 2^31 rows or more")
    table = (torch.cat([a[0], a[0]], 1), torch.cat([a[1], F.neg(a[1])], 1))
    sign = torch.broadcast_to(sign, idx.shape).to(idx.device)
    return p, table, idx + rows * sign.to(torch.int32)


def xyzz_madd(curve: str, p, a, idx=None, sign=None):
    """Bucket p (x, y, zz, zzz) += affine a (x, y), lane by lane; with
    `idx` (int32, one per lane), lane i adds row idx[i] of the point table
    a, two (W, rows) coordinates.  `sign` (bool lanes) subtracts the point
    instead: on the card through the table index, a's rows beside their
    negation (no kernel argument of its own)."""
    coords = tuple(p) + tuple(a)
    if _plain(curve, coords):
        return xyzz_madd_plain(curve, p, a, idx, sign)
    if sign is not None:
        if idx is not None:
            _check_idx(kernel_name("xyzz_madd", curve), a, idx, p)
        batch = p[0].shape[1:]
        q, table, sidx = _signed_table(curve, p, a, idx, sign)
        out = xyzz_madd(curve, q, table, sidx)
        return tuple(c.reshape((c.shape[0],) + tuple(batch)) for c in out)
    if idx is None:
        return _xyzz(_launch("xyzz_madd", curve, coords))
    _check_idx(kernel_name("xyzz_madd", curve), a, idx, p)
    return _xyzz(_launch("xyzz_madd", curve, coords,
                         idx=(None,) * 4 + (idx,) * 2))


def xyzz_add(curve: str, p, q):
    """p + q over xyzz points, lane by lane."""
    coords = tuple(p) + tuple(q)
    if _plain(curve, coords):
        return xyzz_add_plain(curve, p, q)
    return _xyzz(_launch("xyzz_add", curve, coords))


def xyzz_dbl(curve: str, p):
    """2 p over xyzz points, lane by lane."""
    if _plain(curve, p):
        return xyzz_dbl_plain(curve, p)
    return _xyzz(_launch("xyzz_dbl", curve, tuple(p)))


def affine_pair_prep(curve: str, l, r, idx=None):
    """(den, flags) of the batch-affine pair add l + r, lane by lane; with
    idx = (idx_l, idx_r) (int32, one per lane), lane i's l and r are row
    idx_l[i] of the table l and row idx_r[i] of the table r, each two
    (W, rows) coordinates; with idx_l None, l is per-lane."""
    coords = tuple(l) + tuple(r)
    if _plain(curve, coords):
        return affine_pair_prep_plain(curve, l, r, idx)
    out = _launch("pair_prep", curve, coords,
                  idx=_pair_views(curve, "pair_prep", l, r, idx))
    return out[:-1], out[-1]


def affine_pair_finish(curve: str, l, r, inv, flags, idx=None):
    """l + r from inv = 1 / den and the flags of affine_pair_prep; idx as
    there."""
    coords = tuple(l) + tuple(r) + (inv,)
    if _plain(curve, coords + (flags,)):
        return affine_pair_finish_plain(curve, l, r, inv, flags, idx)
    views = _pair_views(curve, "pair_finish", l, r, idx, (inv,))
    return tuple(_launch("pair_finish", curve, coords, flags,
                         None if views is None else views + (None,)).chunk(2))


def _pair_views(curve, op, l, r, idx, lanes=()):
    """The per-coordinate indices of an indexed pair kernel: idx_l for
    l's x and y (None: per-lane), idx_r for r's; None without idx."""
    if idx is None:
        return None
    _check_pair_idx(kernel_name(op, curve), l, r, idx, lanes)
    return (idx[0],) * 2 + (idx[1],) * 2


class Kernels(NamedTuple):
    """The functions the MSM stages call: the point ops and the field
    kernels under the batch inversions and the scalar conversion."""

    madd: Callable
    add: Callable
    dbl: Callable
    pair_prep: Callable
    pair_finish: Callable
    field: FK.FieldKernels


#: what the entry points use: the kernels on CUDA tensors
KERNELS = Kernels(xyzz_madd, xyzz_add, xyzz_dbl, affine_pair_prep,
                  affine_pair_finish, FK.KERNELS)
#: the plain versions on any device, to hold the kernels against
PLAIN = Kernels(xyzz_madd_plain, xyzz_add_plain, xyzz_dbl_plain,
                affine_pair_prep_plain, affine_pair_finish_plain, FK.PLAIN)
