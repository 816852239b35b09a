"""The NTT kernels' wrappers, each beside its plain PyTorch version.

`ntt_rows` runs csrc/ntt_gl64.cu:gl64_ntt_rows (the port of
sppark_tpu/ntt/pallas_kernels.py:_rows_kernel) and `ntt_cols` runs
gl64_ntt_cols (the port of _cols_kernel).  On a CUDA tensor a wrapper
launches its kernel on the current stream or raises; on a CPU tensor it
computes the same function with the plain version.  Each launch adds one to
`launches[name]`.

Shapes (int64 Goldilocks words, contiguous):
  ntt_rows: x, mul (B, n) or (OB, B, n); out the same, or (OB?, n, B) with
            out_t.  NTTs along the last axis.
  ntt_cols: x (n1, M) or (B, n1, M); mul (n1, M).  NTTs along axis -2.
  tw: the power table [w^0 .. w^(n/2 - 1)] of the transform's root.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import torch

from .. import _build
from ..ff import gl64
from ..util.errors import SpparkError
from .core import bit_reverse, ct_stages

#: longest transform one kernel pass takes: a 2^13 row of u64 is the 64 KiB
#: of shared memory a block holds
LG_MAX = 13

launches = {"gl64_ntt_rows": 0, "gl64_ntt_cols": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "gl64_ntt_rows": [_VP, _VP, _VP, _VP, _LL, _LL, _I, _I, _I, _I, _VP],
    "gl64_ntt_cols": [_VP, _VP, _VP, _VP, _LL, _I, _LL, _VP],
}


def _lib() -> ctypes.CDLL:
    return _build.load("ntt_gl64", _SIGNATURES)


def _check_args(name: str, x, tw, lg: int, mul, axis: int) -> None:
    if not 1 <= lg <= LG_MAX:
        raise ValueError(f"{name}: lg {lg} outside [1, {LG_MAX}]")
    if x.ndim not in (2, 3) or x.shape[axis] != 1 << lg:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not hold length "
                         f"2^{lg} transforms on axis {axis}")
    if tw.shape != (1 << (lg - 1),):
        raise ValueError(f"{name}: tw {tuple(tw.shape)} is not the 2^{lg} "
                         f"power table")
    tensors = [x, tw] + ([mul] if mul is not None else [])
    if any(t.dtype != torch.int64 for t in tensors):
        raise TypeError(f"{name}: tensors must be int64 Goldilocks words")
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


# -- rows ----------------------------------------------------------------------

def ntt_rows_plain(x, tw, lg: int, mul=None, in_rev: bool = True,
                   out_rev: bool = False, out_t: bool = False):
    """Plain version of gl64_ntt_rows."""
    y = ct_stages(bit_reverse(x, lg) if in_rev else x, lg, tw)
    if out_rev:
        y = bit_reverse(y, lg)
    if mul is not None:
        y = gl64.mul(y, mul)
    return y.transpose(-1, -2).contiguous() if out_t else y


def ntt_rows(x, tw, lg: int, mul=None, in_rev: bool = True,
             out_rev: bool = False, out_t: bool = False):
    """Batched NTTs along the last axis (see the module docstring).

    mul + out_rev is rejected, as the TPU kernel rejects it: the multiplier
    applies after the output bit reversal, so it would have to arrive
    bit-reversed, and no caller needs that."""
    if mul is not None and out_rev:
        raise ValueError("ntt_rows: mul applies after out_rev; the "
                         "combination is unsupported")
    _check_args("ntt_rows", x, tw, lg, mul, -1)
    if mul is not None and mul.shape != x.shape:
        raise ValueError(f"ntt_rows: mul {tuple(mul.shape)} != x "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return ntt_rows_plain(x, tw, lg, mul, in_rev, out_rev, out_t)
    _check_cuda("ntt_rows", x, tw, mul)
    ob, b = (1, x.shape[0]) if x.ndim == 2 else x.shape[:2]
    n = 1 << lg
    out = torch.empty(x.shape[:-2] + (n, b) if out_t else x.shape,
                      dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().gl64_ntt_rows(
            _ptr(x), _ptr(tw), _ptr(mul), _ptr(out), ob, b, lg, int(in_rev),
            int(out_rev), int(out_t), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SpparkError(rc, f"gl64_ntt_rows: CUDA error {rc}")
    launches["gl64_ntt_rows"] += 1
    return out


# -- columns -------------------------------------------------------------------

def ntt_cols_plain(x, tw, lg: int, mul=None):
    """Plain version of gl64_ntt_cols."""
    y = ct_stages(bit_reverse(x.transpose(-1, -2), lg), lg, tw)
    y = y.transpose(-1, -2)
    if mul is not None:
        y = gl64.mul(y, mul)
    return y.contiguous()


def ntt_cols(x, tw, lg: int, mul=None):
    """Batched NTTs along axis -2, times the middle matrix `mul` (one
    (n1, M) matrix for every batch slice) when it is given."""
    _check_args("ntt_cols", x, tw, lg, mul, -2)
    if mul is not None and mul.shape != x.shape[-2:]:
        raise ValueError(f"ntt_cols: mul {tuple(mul.shape)} != "
                         f"{tuple(x.shape[-2:])}")
    m = x.shape[-1]
    if m & (m - 1):
        raise ValueError(f"ntt_cols: column count {m} is not a power of two")
    if x.device.type == "cpu":
        return ntt_cols_plain(x, tw, lg, mul)
    _check_cuda("ntt_cols", x, tw, mul)
    batch = 1 if x.ndim == 2 else x.shape[0]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().gl64_ntt_cols(
            _ptr(x), _ptr(tw), _ptr(mul), _ptr(out), batch, lg, m,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SpparkError(rc, f"gl64_ntt_cols: CUDA error {rc}")
    launches["gl64_ntt_cols"] += 1
    return out


class Kernels(NamedTuple):
    """The two kernel functions the NTT orchestration calls."""

    rows: Callable
    cols: Callable


#: what the entry points use: the kernels on CUDA tensors
KERNELS = Kernels(ntt_rows, ntt_cols)
#: the plain versions on any device, to hold the kernels against
PLAIN = Kernels(ntt_rows_plain, ntt_cols_plain)
