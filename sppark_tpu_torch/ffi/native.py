"""ctypes bridge to the native host core: the port of sppark_tpu/ffi/
native.py over the port's own copy of the source,
sppark_tpu_torch/native/msm_cpu.cpp (standard headers only).

Build-on-first-use like the Go bridge (go/sppark.go:195-213): the library
is compiled with the ambient C++ compiler into the git-ignored
sppark_tpu_torch/build/ when it is missing or older than its source, then
loaded.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Sequence

import numpy as np

from ..params import CurveParams, get_curve
from ..util.errors import SpparkError
from .loader import NATIVE, _CError, build, check_error

_SRC = os.path.join(NATIVE, "msm_cpu.cpp")
_SO = os.path.join(os.path.dirname(NATIVE), "build", "libsppark_cpu.so")


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Compile (if stale) and load the native library."""
    lib = ctypes.CDLL(build(_SRC, "-lpthread", out=_SO))
    u64p, size = ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t
    lib.sppark_cpu_msm.restype = _CError
    lib.sppark_cpu_msm.argtypes = [u64p, ctypes.c_uint64, size, u64p, u64p,
                                   size, size, u64p, u64p, size, size,
                                   ctypes.c_int, u64p]
    lib.sppark_cpu_available.restype = ctypes.c_int
    lib.sppark_drop_error_message.argtypes = [ctypes.c_void_p]
    return lib


def cpu_available() -> bool:
    try:
        return bool(load().sppark_cpu_available())
    except Exception:
        return False


def _u64_limbs(v: int, n: int) -> np.ndarray:
    return np.asarray([(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF
                       for i in range(n)], dtype=np.uint64)


def cpu_msm(curve, points, scalars: Sequence[int],
            wbits: int = 0, nthreads: int = 0):
    """Native CPU Pippenger over canonical-int points and scalars; returns
    an oracle AffinePoint (mult_pippenger, msm/pippenger.hpp:220-350).  G1
    curves with a4 == 0 only."""
    from ..oracle.ec import JacobianPoint, get_oracle

    cp: CurveParams = get_curve(curve) if isinstance(curve, str) else curve
    if cp.fp2 is not None:
        raise SpparkError(2, "native CPU MSM supports G1 curves only")
    if cp.a4:
        raise SpparkError(2, "native CPU MSM supports a4 == 0 curves only")
    lib = load()
    fl = (cp.field.bits + 63) // 64
    sl = (cp.scalar.bits + 63) // 64
    n = len(points)
    pbuf = np.zeros((n, 2, fl), dtype=np.uint64)
    for i, p in enumerate(points):
        if getattr(p, "inf", False):
            continue
        pbuf[i, 0] = _u64_limbs(p.x, fl)
        pbuf[i, 1] = _u64_limbs(p.y, fl)
    sbuf = np.zeros((n, sl), dtype=np.uint64)
    for i, s in enumerate(scalars):
        sbuf[i] = _u64_limbs(s % cp.scalar.modulus, sl)

    R = 1 << (64 * fl)
    rr = _u64_limbs(R * R % cp.field.modulus, fl)
    mod = _u64_limbs(cp.field.modulus, fl)
    order = _u64_limbs(cp.scalar.modulus, sl)
    m0 = (-pow(cp.field.modulus, -1, 1 << 64)) % (1 << 64)
    out = np.zeros(3 * fl, dtype=np.uint64)

    c_u64p = ctypes.POINTER(ctypes.c_uint64)

    def ptr(a):
        return a.ctypes.data_as(c_u64p)

    err = lib.sppark_cpu_msm(
        ptr(mod), ctypes.c_uint64(m0), ctypes.c_size_t(fl), ptr(rr),
        ptr(order), ctypes.c_size_t(sl), ctypes.c_size_t(cp.scalar.bits),
        ptr(np.ascontiguousarray(pbuf)), ptr(np.ascontiguousarray(sbuf)),
        ctypes.c_size_t(n), ctypes.c_size_t(wbits),
        ctypes.c_int(nthreads), ptr(out))
    check_error(err, lib, "sppark_cpu_msm")

    def limbs_to_int(a):
        return sum(int(w) << (64 * i) for i, w in enumerate(a))

    X = limbs_to_int(out[:fl])
    Y = limbs_to_int(out[fl:2 * fl])
    Z = limbs_to_int(out[2 * fl:])
    return get_oracle(cp).jacobian_to_affine(JacobianPoint(X, Y, Z))
