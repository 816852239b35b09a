"""The NTT kernels' wrappers, each beside its plain PyTorch version.

Goldilocks: `ntt_rows` runs csrc/ntt_gl64.cu:gl64_ntt_rows (the port of
sppark_tpu/ntt/pallas_kernels.py:_rows_kernel) and `ntt_cols` runs
gl64_ntt_cols (the port of _cols_kernel).  The 31-bit Montgomery fields
(BabyBear): `mont32_rows` and `mont32_cols` run csrc/ntt_mont32.cu's
mont32_ntt_rows and mont32_ntt_cols.  Both pairs are one text,
csrc/ntt_radix.cuh (radix-16 passes in registers), over a field policy:
csrc/gl64.cuh's lazy Goldilocks word (any u64 in, canonical out) and
csrc/mont32.cuh's u32 Montgomery word.  The wide (multi-limb Montgomery)
fields: `wide_rows`, `wide_cols` and `wide_mid` run csrc/ntt_wide.cu's
bigmont_ntt_rows, bigmont_ntt_cols (the two kernels' wide uses) and
bigmont_ntt_mid (the port of _mid_factored_kernel).  On a CUDA tensor a wrapper launches its kernel on
the current stream or raises; on a CPU tensor it computes the same
function with the plain version.  Each launch adds one to its count:
`launches[name]` for the Goldilocks kernels, `narrow_launches[name]` for
the mont32 ones, `wide_launches[name]` for the wide ones.

Shapes (contiguous; int64 Goldilocks words, int32 mont32 words, or
limb-major (n32, ...) int32 Montgomery words with the limb axis in front
of the shapes below):
  rows: x, mul (B, n) or (OB, B, n); out the same, or (OB?, n, B) with
        out_t.  NTTs along the last axis.
  cols: x (n1, M) or (B, n1, M); mul (n1, M), Goldilocks and mont32
        only.  NTTs along axis -2.
  mid:  x (n1, M) or (B, n1, M); a (n1, M / block); b (n1, block):
        x[.., k1, j] * a[k1, j / block] * b[k1, j mod block].
  tw: the power table [w^0 .. w^(n/2 - 1)] of the transform's root.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import torch

from .. import _build
from ..ff import kernels as FK
from ..params import get_field
from ..util.errors import SpparkError
from .core import Mont32Ops, bit_reverse, ct_stages, elem_ops

#: longest transform one Goldilocks or mont32 kernel pass takes
#: (csrc/ntt_radix.cuh:LG_MAX): a 2^13 row of u64 is a Goldilocks block's
#: 64 KiB tile
LG_MAX = 13
#: the same for the wide kernels: 2^11 elements of 8 words are 64 KiB
LG_MAX_WIDE = 11

launches = {"gl64_ntt_rows": 0, "gl64_ntt_cols": 0}
narrow_launches = {"mont32_ntt_rows": 0, "mont32_ntt_cols": 0}
wide_launches = {"bigmont_ntt_rows": 0, "bigmont_ntt_cols": 0,
                 "bigmont_ntt_mid": 0}


def reset_launches() -> None:
    for counts in (launches, narrow_launches, wide_launches):
        for k in counts:
            counts[k] = 0


_VP, _LL, _I, _U = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_uint)
_SIGNATURES = {
    "gl64_ntt_rows": [_VP, _VP, _VP, _VP, _LL, _LL, _I, _I, _I, _I, _VP],
    "gl64_ntt_cols": [_VP, _VP, _VP, _VP, _LL, _I, _LL, _VP],
}
# the same with the field's p and M0 = -p^-1 mod 2^32 before the stream
_MONT32_SIGNATURES = {
    "mont32_ntt_rows": [_VP, _VP, _VP, _VP, _LL, _LL, _I, _I, _I, _I, _U, _U,
                        _VP],
    "mont32_ntt_cols": [_VP, _VP, _VP, _VP, _LL, _I, _LL, _U, _U, _VP],
}
_WIDE_SIGNATURES = {
    "bigmont_ntt_rows": [_I, _VP, _VP, _VP, _VP, _LL, _LL, _I, _I, _I, _I,
                         _VP, _VP],
    "bigmont_ntt_cols": [_I, _VP, _VP, _VP, _LL, _I, _LL, _VP, _VP],
    "bigmont_ntt_mid": [_I, _VP, _VP, _VP, _VP, _LL, _LL, _LL, _LL, _VP,
                        _VP],
}


def _lib() -> ctypes.CDLL:
    return _build.load("ntt_gl64", _SIGNATURES)


def _mont32_lib() -> ctypes.CDLL:
    return _build.load("ntt_mont32", _MONT32_SIGNATURES)


def _wide_lib() -> ctypes.CDLL:
    return _build.load("ntt_wide", _WIDE_SIGNATURES)


def _check_args(name: str, x, tw, lg: int, mul, axis: int,
                lead: int = 0, lg_max: int = LG_MAX,
                dtype=torch.int64) -> None:
    """Shapes, types and devices; `lead` leading word axes in front."""
    if not 1 <= lg <= lg_max:
        raise ValueError(f"{name}: lg {lg} outside [1, {lg_max}]")
    if x.ndim - lead not in (2, 3) or x.shape[axis] != 1 << lg:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not hold length "
                         f"2^{lg} transforms on axis {axis}")
    if tw.shape != x.shape[:lead] + (1 << (lg - 1),):
        raise ValueError(f"{name}: tw {tuple(tw.shape)} is not the 2^{lg} "
                         f"power table")
    tensors = [x, tw] + ([mul] if mul is not None else [])
    if any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{name}: tensors must be {dtype} words")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: tensors lie on different devices")


def _check_cuda(name: str, *tensors) -> None:
    if tensors[0].device.type != "cuda":
        raise SpparkError(5, f"{name}: no kernel for device "
                             f"{tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors if t is not None):
        raise ValueError(f"{name}: tensors must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


_GL64 = elem_ops("goldilocks")


# -- rows ----------------------------------------------------------------------

def rows_plain(E, x, tw, lg: int, mul=None, in_rev: bool = True,
               out_rev: bool = False, out_t: bool = False):
    """The row kernels' function with the element ops E."""
    y = ct_stages(E, bit_reverse(x, lg) if in_rev else x, lg, tw)
    if out_rev:
        y = bit_reverse(y, lg)
    if mul is not None:
        y = E.mul(y, mul)
    return y.transpose(-1, -2).contiguous() if out_t else y


def ntt_rows_plain(x, tw, lg: int, mul=None, in_rev: bool = True,
                   out_rev: bool = False, out_t: bool = False):
    """Plain version of gl64_ntt_rows."""
    return rows_plain(_GL64, x, tw, lg, mul, in_rev, out_rev, out_t)


def _check_rows(name: str, x, tw, lg: int, mul, out_rev: bool, dtype):
    """mul + out_rev is rejected, as the TPU kernel rejects it: the
    multiplier applies after the output bit reversal, so it would have to
    arrive bit-reversed, and no caller needs that."""
    if mul is not None and out_rev:
        raise ValueError(f"{name}: mul applies after out_rev; the "
                         f"combination is unsupported")
    _check_args(name, x, tw, lg, mul, -1, dtype=dtype)
    if mul is not None and mul.shape != x.shape:
        raise ValueError(f"{name}: mul {tuple(mul.shape)} != x "
                         f"{tuple(x.shape)}")


def _launch_rows(name: str, lib, x, tw, lg: int, mul, in_rev: bool,
                 out_rev: bool, out_t: bool, *consts):
    """Launch the narrow row kernel `name` of the library that `lib` loads
    (consts: the field's, before the stream) into a new output; raise on a
    CUDA error.  The device is checked before the library is built."""
    _check_cuda(name, x, tw, mul)
    fn = getattr(lib(), name)
    ob, b = (1, x.shape[0]) if x.ndim == 2 else x.shape[:2]
    n = 1 << lg
    out = torch.empty(x.shape[:-2] + (n, b) if out_t else x.shape,
                      dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(_ptr(x), _ptr(tw), _ptr(mul), _ptr(out), ob, b, lg,
                int(in_rev), int(out_rev), int(out_t), *consts,
                torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SpparkError(rc, f"{name}: CUDA error {rc}")
    return out


def ntt_rows(x, tw, lg: int, mul=None, in_rev: bool = True,
             out_rev: bool = False, out_t: bool = False):
    """Batched NTTs along the last axis (see the module docstring)."""
    _check_rows("ntt_rows", x, tw, lg, mul, out_rev, torch.int64)
    if x.device.type == "cpu":
        return ntt_rows_plain(x, tw, lg, mul, in_rev, out_rev, out_t)
    out = _launch_rows("gl64_ntt_rows", _lib, x, tw, lg, mul, in_rev,
                       out_rev, out_t)
    launches["gl64_ntt_rows"] += 1
    return out


# -- columns -------------------------------------------------------------------

def cols_plain(E, x, tw, lg: int, mul=None):
    """The column kernels' function with the element ops E."""
    y = ct_stages(E, bit_reverse(x.transpose(-1, -2), lg), lg, tw)
    y = y.transpose(-1, -2)
    if mul is not None:
        y = E.mul(y, mul)
    return y.contiguous()


def ntt_cols_plain(x, tw, lg: int, mul=None):
    """Plain version of gl64_ntt_cols."""
    return cols_plain(_GL64, x, tw, lg, mul)


def _check_cols(name: str, x, tw, lg: int, mul, dtype):
    _check_args(name, x, tw, lg, mul, -2, dtype=dtype)
    if mul is not None and mul.shape != x.shape[-2:]:
        raise ValueError(f"{name}: mul {tuple(mul.shape)} != "
                         f"{tuple(x.shape[-2:])}")
    m = x.shape[-1]
    if m & (m - 1):
        raise ValueError(f"{name}: column count {m} is not a power of two")


def _launch_cols(name: str, lib, x, tw, lg: int, mul, *consts):
    """The same for the narrow column kernel `name`."""
    _check_cuda(name, x, tw, mul)
    fn = getattr(lib(), name)
    batch = 1 if x.ndim == 2 else x.shape[0]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = fn(_ptr(x), _ptr(tw), _ptr(mul), _ptr(out), batch, lg,
                x.shape[-1], *consts, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SpparkError(rc, f"{name}: CUDA error {rc}")
    return out


def ntt_cols(x, tw, lg: int, mul=None):
    """Batched NTTs along axis -2, times the middle matrix `mul` (one
    (n1, M) matrix for every batch slice) when it is given."""
    _check_cols("ntt_cols", x, tw, lg, mul, torch.int64)
    if x.device.type == "cpu":
        return ntt_cols_plain(x, tw, lg, mul)
    out = _launch_cols("gl64_ntt_cols", _lib, x, tw, lg, mul)
    launches["gl64_ntt_cols"] += 1
    return out


# -- the 31-bit Montgomery fields ------------------------------------------------

def _mont32_consts(name: str, field: str):
    """(p, M0) of a 31-bit Montgomery field, for the kernel's multiply."""
    params = get_field(field)
    if not (isinstance(elem_ops(field), Mont32Ops)
            and params.montgomery_wire):
        raise ValueError(f"{name}: {field} is not a 31-bit Montgomery field")
    return params.modulus, params.m0(32)


def mont32_rows_plain(field: str, x, tw, lg: int, mul=None,
                      in_rev: bool = True, out_rev: bool = False,
                      out_t: bool = False):
    """Plain version of mont32_ntt_rows."""
    return rows_plain(elem_ops(field), x, tw, lg, mul, in_rev, out_rev,
                      out_t)


def mont32_rows(field: str, x, tw, lg: int, mul=None, in_rev: bool = True,
                out_rev: bool = False, out_t: bool = False):
    """Batched NTTs along the last axis of int32 words of a 31-bit field;
    the options as ntt_rows has them (mul + out_rev rejected likewise)."""
    consts = _mont32_consts("mont32_rows", field)
    _check_rows("mont32_rows", x, tw, lg, mul, out_rev, torch.int32)
    if x.device.type == "cpu":
        return mont32_rows_plain(field, x, tw, lg, mul, in_rev, out_rev,
                                 out_t)
    out = _launch_rows("mont32_ntt_rows", _mont32_lib, x, tw, lg, mul,
                       in_rev, out_rev, out_t, *consts)
    narrow_launches["mont32_ntt_rows"] += 1
    return out


def mont32_cols_plain(field: str, x, tw, lg: int, mul=None):
    """Plain version of mont32_ntt_cols."""
    return cols_plain(elem_ops(field), x, tw, lg, mul)


def mont32_cols(field: str, x, tw, lg: int, mul=None):
    """Batched NTTs along axis -2 of int32 words of a 31-bit field, times
    the middle matrix `mul` when it is given."""
    consts = _mont32_consts("mont32_cols", field)
    _check_cols("mont32_cols", x, tw, lg, mul, torch.int32)
    if x.device.type == "cpu":
        return mont32_cols_plain(field, x, tw, lg, mul)
    out = _launch_cols("mont32_ntt_cols", _mont32_lib, x, tw, lg, mul,
                       *consts)
    narrow_launches["mont32_ntt_cols"] += 1
    return out


# -- the wide fields ---------------------------------------------------------------

def _wide_check(name: str, field: str, x, tw, lg: int, mul, axis: int):
    """The field's parameters, after the checks of _check_args with the
    limb axis in front and the field's word count."""
    params = get_field(field)
    _check_args(name, x, tw, lg, mul, axis, lead=1, lg_max=LG_MAX_WIDE,
                dtype=torch.int32)
    if x.shape[0] != params.n_ref_limbs:
        raise ValueError(f"{name}: {tuple(x.shape)} is not ({params.n_ref_limbs}"
                         f", ...) words of {field}")
    return params


def _batch_axes(m, x):
    """m (n32, *shape) viewed to broadcast against x (n32, *batch, *shape)."""
    return m.reshape(m.shape[:1] + (1,) * (x.ndim - m.ndim) + m.shape[1:])


def wide_rows_plain(field: str, x, tw, lg: int, mul=None,
                    in_rev: bool = True, out_rev: bool = False,
                    out_t: bool = False):
    """Plain version of bigmont_ntt_rows."""
    return rows_plain(elem_ops(field, FK.PLAIN), x, tw, lg, mul, in_rev,
                      out_rev, out_t)


def wide_rows(field: str, x, tw, lg: int, mul=None, in_rev: bool = True,
              out_rev: bool = False, out_t: bool = False):
    """Batched NTTs along the last axis of (n32, [OB,] B, n) words; the
    options as ntt_rows has them (mul + out_rev rejected likewise)."""
    if mul is not None and out_rev:
        raise ValueError("wide_rows: mul applies after out_rev; the "
                         "combination is unsupported")
    params = _wide_check("wide_rows", field, x, tw, lg, mul, -1)
    if mul is not None and mul.shape != x.shape:
        raise ValueError(f"wide_rows: mul {tuple(mul.shape)} != x "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return wide_rows_plain(field, x, tw, lg, mul, in_rev, out_rev, out_t)
    _check_cuda("wide_rows", x, tw, mul)
    ob, b = (1, x.shape[1]) if x.ndim == 3 else x.shape[1:3]
    n = 1 << lg
    out = torch.empty(x.shape[:-2] + (n, b) if out_t else x.shape,
                      dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _wide_lib().bigmont_ntt_rows(
            x.shape[0], _ptr(x), _ptr(tw), _ptr(mul), _ptr(out), ob, b, lg,
            int(in_rev), int(out_rev), int(out_t),
            FK.field_consts(params).ctypes.data,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SpparkError(rc, f"bigmont_ntt_rows: CUDA error {rc}")
    wide_launches["bigmont_ntt_rows"] += 1
    return out


def wide_cols_plain(field: str, x, tw, lg: int):
    """Plain version of bigmont_ntt_cols."""
    return cols_plain(elem_ops(field, FK.PLAIN), x, tw, lg)


def wide_cols(field: str, x, tw, lg: int):
    """Batched NTTs along axis -2 of (n32, [B,] n1, M) words (the wide
    path's middle twiddles are wide_mid's pass, not a multiplier here)."""
    params = _wide_check("wide_cols", field, x, tw, lg, None, -2)
    m = x.shape[-1]
    if m & (m - 1):
        raise ValueError(f"wide_cols: column count {m} is not a power of two")
    if x.device.type == "cpu":
        return wide_cols_plain(field, x, tw, lg)
    _check_cuda("wide_cols", x, tw)
    batch = 1 if x.ndim == 3 else x.shape[1]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _wide_lib().bigmont_ntt_cols(
            x.shape[0], _ptr(x), _ptr(tw), _ptr(out), batch, lg, m,
            FK.field_consts(params).ctypes.data,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SpparkError(rc, f"bigmont_ntt_cols: CUDA error {rc}")
    wide_launches["bigmont_ntt_cols"] += 1
    return out


def wide_mid_plain(field: str, x, a, b):
    """Plain version of bigmont_ntt_mid: A and B spread to (n32, n1, M)."""
    E = elem_ops(field, FK.PLAIN)
    block = b.shape[-1]
    a_full = a.repeat_interleave(block, dim=-1)
    b_full = b.repeat(1, 1, a.shape[-1])
    return E.mul(E.mul(x, _batch_axes(a_full, x)), _batch_axes(b_full, x))


def wide_mid(field: str, x, a, b):
    """The factored middle twiddles over (n32, [B,] n1, M) words:
    x[.., k1, j] * a[k1, j / block] * b[k1, j mod block]; n1, M and block
    are powers of two."""
    params = get_field(field)
    n32 = params.n_ref_limbs
    if x.ndim not in (3, 4) or a.ndim != 3 or b.ndim != 3:
        raise ValueError(f"wide_mid: x {tuple(x.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)} are not (n32, [B,] n1, M), "
                         f"(n32, n1, M / block), (n32, n1, block)")
    n1, m = x.shape[-2:]
    block = b.shape[-1]
    if (any(v & (v - 1) for v in (n1, m, block)) or block > m
            or a.shape != (n32, n1, m // block) or b.shape[:2] != (n32, n1)
            or x.shape[0] != n32):
        raise ValueError(f"wide_mid: x {tuple(x.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)} do not match {field} with "
                         f"powers of two n1, M, block")
    if any(t.dtype != torch.int32 for t in (x, a, b)):
        raise TypeError("wide_mid: tensors must be int32 words")
    if any(t.device != x.device for t in (a, b)):
        raise ValueError("wide_mid: tensors lie on different devices")
    if x.device.type == "cpu":
        return wide_mid_plain(field, x, a, b)
    _check_cuda("wide_mid", x, a, b)
    batch = 1 if x.ndim == 3 else x.shape[1]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _wide_lib().bigmont_ntt_mid(
            n32, _ptr(x), _ptr(a), _ptr(b), _ptr(out), batch, n1, m, block,
            FK.field_consts(params).ctypes.data,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SpparkError(rc, f"bigmont_ntt_mid: CUDA error {rc}")
    wide_launches["bigmont_ntt_mid"] += 1
    return out


class Kernels(NamedTuple):
    """The kernel functions the NTT orchestration calls: the Goldilocks
    pair, the mont32 pair, the wide three, and the field kernels of the
    wide fields' elementwise products (coset shift, 1/N)."""

    rows: Callable
    cols: Callable
    mont32_rows: Callable
    mont32_cols: Callable
    wide_rows: Callable
    wide_cols: Callable
    wide_mid: Callable
    field: FK.FieldKernels


#: what the entry points use: the kernels on CUDA tensors
KERNELS = Kernels(ntt_rows, ntt_cols, mont32_rows, mont32_cols, wide_rows,
                  wide_cols, wide_mid, FK.KERNELS)
#: the plain versions on any device, to hold the kernels against
PLAIN = Kernels(ntt_rows_plain, ntt_cols_plain, mont32_rows_plain,
                mont32_cols_plain, wide_rows_plain, wide_cols_plain,
                wide_mid_plain, FK.PLAIN)
