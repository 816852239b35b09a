"""The point kernels' wrappers, each beside its plain PyTorch version.

`xyzz_madd`, `xyzz_add` and `xyzz_dbl` run, for G1 curves, csrc/
ec_xyzz.cu's ec_xyzz_madd / ec_xyzz_add / ec_xyzz_dbl and, for G2 curves,
ec_fp2_xyzz_madd / ec_fp2_xyzz_add / ec_fp2_xyzz_dbl (csrc/ec_fp2_madd.cu,
ec_fp2_add.cu, ec_fp2_dbl.cu): the ports of sppark_tpu/ec/pallas_ops.py:
_madd_call, _add_call and _dbl_call in degree 1 and 2.  On a CUDA tensor a wrapper
launches its curve's kernel on the current stream or raises; on a CPU
tensor it computes the same function with the plain version, ec/core.py's
op over plain field arithmetic.  Each launch adds one to `launches[name]`
(G1) or `fp2_launches[name]` (G2).

Every coordinate is `(W, *batch)` int32 words, W = n32 for G1 and 2 n32
for G2 (c0's words, then c1's); batch shapes broadcast.  An input
coordinate reaches the kernel as a view (a pointer and its word and lane
strides) when its batch dimensions merge into one, so slices of the MSM's
slab and broadcast constants are read in place; the output is one new
(4, W, *batch) block, returned as four coordinates.
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

launches = {"ec_xyzz_madd": 0, "ec_xyzz_add": 0, "ec_xyzz_dbl": 0}
fp2_launches = {"ec_fp2_xyzz_madd": 0, "ec_fp2_xyzz_add": 0,
                "ec_fp2_xyzz_dbl": 0}


def reset_launches() -> None:
    for counts in (launches, fp2_launches):
        for k in counts:
            counts[k] = 0


#: each kernel's source, csrc/<source>.cu: the G1 kernels share one, each
#: fp2 kernel has its own, so nvcc builds them at once
SOURCES = {"ec_xyzz_madd": "ec_xyzz", "ec_xyzz_add": "ec_xyzz",
           "ec_xyzz_dbl": "ec_xyzz", "ec_fp2_xyzz_madd": "ec_fp2_madd",
           "ec_fp2_xyzz_add": "ec_fp2_add", "ec_fp2_xyzz_dbl": "ec_fp2_dbl"}
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


def _launch(op: str, curve: str, coords):
    """Run op ("madd", "add" or "dbl") of `curve`'s degree on the card."""
    cp = get_curve(curve)
    degree = cp.degree
    name = ("ec_xyzz_" if degree == 1 else "ec_fp2_xyzz_") + op
    FK.check_words(name, cp.field, *coords, degree=degree)
    coords = torch.broadcast_tensors(*coords)
    n32, words = cp.field.n_ref_limbs, coords[0].shape[0]
    batch = tuple(coords[0].shape[1:])
    n = math.prod(batch)
    out = torch.empty((4, words) + batch, dtype=torch.int32,
                      device=coords[0].device)
    if n == 0:
        return tuple(out)
    views = np.empty(3 * len(coords), dtype=np.int64)
    kept = [c.reshape(words, n) for c in coords]   # a copy only if needed
    for k, v in enumerate(kept):
        views[3 * k:3 * k + 3] = (v.data_ptr(), v.stride(0), v.stride(1))
    with torch.cuda.device(out.device):
        rc = getattr(_lib(name), name)(
            n32, views.ctypes.data, out.data_ptr(), n,
            _consts(curve).ctypes.data,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SpparkError(rc, f"{name}: CUDA error {rc}")
    (launches if degree == 1 else fp2_launches)[name] += 1
    return tuple(out)


def _on_cpu(coords) -> bool:
    return all(c.device.type == "cpu" for c in coords)


# -- plain versions ------------------------------------------------------------------

def xyzz_madd_plain(curve: str, p, a):
    """Plain version of ec_xyzz_madd and ec_fp2_xyzz_madd."""
    return get_curve_ops(curve, FK.PLAIN).xyzz_madd(p, a)


def xyzz_add_plain(curve: str, p, q):
    """Plain version of ec_xyzz_add and ec_fp2_xyzz_add."""
    return get_curve_ops(curve, FK.PLAIN).xyzz_add(p, q)


def xyzz_dbl_plain(curve: str, p):
    """Plain version of ec_xyzz_dbl and ec_fp2_xyzz_dbl."""
    return get_curve_ops(curve, FK.PLAIN).xyzz_dbl(p)


# -- kernels -------------------------------------------------------------------------

def xyzz_madd(curve: str, p, a):
    """Bucket p (x, y, zz, zzz) += affine a (x, y), lane by lane."""
    coords = tuple(p) + tuple(a)
    if _on_cpu(coords):
        return xyzz_madd_plain(curve, p, a)
    return _launch("madd", curve, coords)


def xyzz_add(curve: str, p, q):
    """p + q over xyzz points, lane by lane."""
    coords = tuple(p) + tuple(q)
    if _on_cpu(coords):
        return xyzz_add_plain(curve, p, q)
    return _launch("add", curve, coords)


def xyzz_dbl(curve: str, p):
    """2 p over xyzz points, lane by lane."""
    if _on_cpu(p):
        return xyzz_dbl_plain(curve, p)
    return _launch("dbl", curve, tuple(p))


class Kernels(NamedTuple):
    """The functions the MSM stages call: the three point ops and the
    field kernels under the batch inversion and the scalar conversion."""

    madd: Callable
    add: Callable
    dbl: Callable
    field: FK.FieldKernels


#: what the entry points use: the kernels on CUDA tensors
KERNELS = Kernels(xyzz_madd, xyzz_add, xyzz_dbl, FK.KERNELS)
#: the plain versions on any device, to hold the kernels against
PLAIN = Kernels(xyzz_madd_plain, xyzz_add_plain, xyzz_dbl_plain, FK.PLAIN)
