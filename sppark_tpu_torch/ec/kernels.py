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
the pair finish.  The madd's affine point may instead be a table, two
(W, rows) coordinates, and an int32 index of one row per lane: the slab
MSM's point table and slot index (msm/slab.py), read by the kernel in
place of a gathered slab.
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
    flag word per lane; for the madd with `idx`, the last two coordinates
    are a table whose row idx[i] lane i reads).  Returns the output block
    (rows, *batch): 4 W rows for the xyzz ops, W + 1 for the pair prep,
    2 W for the finish."""
    cp = get_curve(curve)
    degree = cp.degree
    name = kernel_name(op, curve)
    FK.check_words(name, cp.field, *coords, degree=degree)
    table = () if idx is None else tuple(coords[-2:])
    coords = list(torch.broadcast_tensors(*coords[:len(coords)
                                                  - len(table)]))
    n32, words = cp.field.n_ref_limbs, coords[0].shape[0]
    batch = tuple(coords[0].shape[1:])
    if flags is not None:
        if flags.dtype != torch.int32 or tuple(flags.shape) != batch or \
                flags.device != coords[0].device:
            raise ValueError(f"{name}: flags must be int32 of shape {batch} "
                             f"on {coords[0].device}")
        coords.append(flags[None])
    rows = {"pair_prep": words + 1, "pair_finish": 2 * words}.get(
        op, 4 * words)
    n = math.prod(batch)
    out = torch.empty((rows,) + batch, dtype=torch.int32,
                      device=coords[0].device)
    if n == 0:
        return out
    kept = [c.reshape(c.shape[0], n) for c in coords]  # a copy only if needed
    kept += table
    views = np.zeros(5 * len(kept), dtype=np.int64)
    for k, v in enumerate(kept):
        views[5 * k:5 * k + 3] = (v.data_ptr(), v.stride(0), v.stride(1))
    if idx is not None:
        idx = idx.contiguous()
        views[5 * len(coords) + 3::5] = idx.data_ptr()
        views[5 * len(coords) + 4::5] = table[0].shape[1]
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


def _check_idx(curve: str, p, a, idx) -> None:
    """Refuse a table index the madd cannot take: other than a 1-D int32
    tensor of p's lanes (every coordinate of p (W, n), not broadcast) on
    p's device, or a table other than two (W, rows)
    coordinates of fewer than 2^31 rows.  An index value outside [0,
    rows) makes the plain version raise and the kernel trap, as PyTorch's
    own index kernels do."""
    name = kernel_name("xyzz_madd", curve)
    if not isinstance(idx, torch.Tensor) or idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be an int32 tensor")
    lanes = tuple(p[0].shape[1:])
    if idx.device != p[0].device or idx.ndim != 1 or any(
            tuple(c.shape[1:]) != tuple(idx.shape) for c in p):
        raise ValueError(f"{name}: idx must be a 1-D tensor of p's "
                         f"{lanes} lanes on {p[0].device}")
    if len(a) != 2 or any(c.ndim != 2 or c.shape[1] != a[0].shape[1]
                          for c in a) or a[0].shape[1] >= 1 << 31:
        raise ValueError(f"{name}: the table must be two (W, rows) "
                         f"coordinates of fewer than 2^31 rows")


# -- plain versions ------------------------------------------------------------------

def xyzz_madd_plain(curve: str, p, a, idx=None):
    """Plain version of ec_xyzz_madd and ec_fp2_xyzz_madd; with `idx`, the
    table a's rows idx gathered first."""
    if idx is not None:
        _check_idx(curve, p, a, idx)
        a = tuple(c.index_select(1, idx) for c in a)
    return get_curve_ops(curve, FK.PLAIN).xyzz_madd(p, a)


def xyzz_add_plain(curve: str, p, q):
    """Plain version of ec_xyzz_add and ec_fp2_xyzz_add."""
    return get_curve_ops(curve, FK.PLAIN).xyzz_add(p, q)


def xyzz_dbl_plain(curve: str, p):
    """Plain version of ec_xyzz_dbl and ec_fp2_xyzz_dbl."""
    return get_curve_ops(curve, FK.PLAIN).xyzz_dbl(p)


#: the pair prep's flag word (pallas_ops.py:_pair_prep_call; csrc/pair.cuh)
ACTIVE, DBL, USE_R, USE_L = 1, 2, 4, 8


def affine_pair_prep_plain(curve: str, l, r):
    """Plain version of ec_pair_prep and ec_fp2_pair_prep: for affine l =
    (x1, y1) and r = (x2, y2), (den, flags).  den is the chord's x2 - x1,
    the tangent's 2 y1, or 1 where there is nothing to invert; flags (int32
    per lane) is the TPU kernel's word bit for bit: ACTIVE (a chord or
    tangent), DBL (active and l == r), USE_R (l infinite, r not), USE_L (r
    infinite, l not).  l == -r and a y1 == 0 doubling are neither active
    nor a copy: their sum is infinity."""
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


def affine_pair_finish_plain(curve: str, l, r, inv, flags):
    """Plain version of ec_pair_finish and ec_fp2_pair_finish: l + r from
    inv = 1 / den and prep's flags.  lambda = (y2 - y1) inv, or (3 x1^2 +
    a4) inv where DBL; x3 = lambda^2 - x1 - x2, y3 = lambda (x1 - x3) - y1;
    then the selects in the TPU kernel's order: active -> USE_R -> USE_L."""
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

def xyzz_madd(curve: str, p, a, idx=None):
    """Bucket p (x, y, zz, zzz) += affine a (x, y), lane by lane; with
    `idx` (int32, one per lane), lane i adds row idx[i] of the point table
    a, two (W, rows) coordinates."""
    coords = tuple(p) + tuple(a)
    if _on_cpu(coords):
        return xyzz_madd_plain(curve, p, a, idx)
    if idx is not None:
        _check_idx(curve, p, a, idx)
    return _xyzz(_launch("xyzz_madd", curve, coords, idx=idx))


def xyzz_add(curve: str, p, q):
    """p + q over xyzz points, lane by lane."""
    coords = tuple(p) + tuple(q)
    if _on_cpu(coords):
        return xyzz_add_plain(curve, p, q)
    return _xyzz(_launch("xyzz_add", curve, coords))


def xyzz_dbl(curve: str, p):
    """2 p over xyzz points, lane by lane."""
    if _on_cpu(p):
        return xyzz_dbl_plain(curve, p)
    return _xyzz(_launch("xyzz_dbl", curve, tuple(p)))


def affine_pair_prep(curve: str, l, r):
    """(den, flags) of the batch-affine pair add l + r, lane by lane."""
    coords = tuple(l) + tuple(r)
    if _on_cpu(coords):
        return affine_pair_prep_plain(curve, l, r)
    out = _launch("pair_prep", curve, coords)
    return out[:-1], out[-1]


def affine_pair_finish(curve: str, l, r, inv, flags):
    """l + r from inv = 1 / den and the flags of affine_pair_prep."""
    coords = tuple(l) + tuple(r) + (inv,)
    if _on_cpu(coords + (flags,)):
        return affine_pair_finish_plain(curve, l, r, inv, flags)
    return tuple(_launch("pair_finish", curve, coords, flags).chunk(2))


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
