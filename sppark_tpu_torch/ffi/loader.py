"""Runtime native-module loader (the Go bridge analogue, go/sppark.go): the
port of sppark_tpu/ffi/loader.py.

``load_source(src)`` compiles a user C/C++ source into a shared object next
to it (rebuild-if-stale by mtime, go/sppark.go:195-213), dlopens it, and
walks the module's ``_sppark`` linker-section symbol table — entries placed
there by ``SPPARK_WRAP`` in sppark_tpu_torch/native/sppark_ffi.h, on every
build's include path (the WRAP/WRAP_ERR macros
of go/cgo_sppark.h:20-28) — resolving each registered function into a
ctypes handle addressable as ``module.<name>``.

Flag conveniences mirror the Go bridge:
  * ``?cpu-FLAG`` conditional prefixes are kept/stripped by toolchain
    (go/sppark.go:364-371's ``?cuda-``/``?rocm-``); only the ``cpu``
    condition exists here.
  * ``exfiltrate(dest)`` copies the built artifact out of a scratch/test
    sandbox for reuse (go/sppark.go:408-463).
  * ``SPPARK_FFI_DEBUG=1`` logs build commands (``__SPPARK_CGO_DEBUG__``,
    go/sppark.go:400-403).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import Dict, List, Optional

from ..util.errors import SpparkError

#: the port's native sources and the header of the `_sppark` symbol table
NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")


class _Entry(ctypes.Structure):
    _fields_ = [("fn", ctypes.c_void_p), ("name", ctypes.c_char_p)]


class _CError(ctypes.Structure):
    # sppark_Error (native/sppark_ffi.h) == RustError (util/rusterror.h:18)
    _fields_ = [("code", ctypes.c_int), ("message", ctypes.c_void_p)]


def check_error(err: "_CError", lib: ctypes.CDLL, what: str = "native call"):
    """Raise SpparkError from a by-value sppark_Error, freeing the message
    through the module's own disposer (the toGoError flow, go/sppark.go:51-59)."""
    if err.code == 0:
        return
    msg = ctypes.cast(err.message, ctypes.c_char_p).value if err.message else None
    if err.message:
        lib.sppark_drop_error_message(ctypes.c_void_p(err.message))
    raise SpparkError(err.code, f"{what}: {(msg or b'unknown').decode()}")


class NativeModule:
    """A loaded module: registered symbols as attributes + raw CDLL access."""

    def __init__(self, path: str, lib: ctypes.CDLL, symbols: Dict[str, int]):
        self.path = path
        self.lib = lib
        self.symbols = dict(symbols)
        for name, addr in symbols.items():
            # untyped handle: caller sets .argtypes/.restype as needed
            setattr(self, name, ctypes.CFUNCTYPE(None)(addr))

    def fn(self, name: str, restype=None, argtypes=()):
        """Typed handle for a registered (or plainly exported) symbol."""
        if name in self.symbols:
            proto = ctypes.CFUNCTYPE(restype, *argtypes)
            return proto(self.symbols[name])
        h = getattr(self.lib, name)
        h.restype = restype
        h.argtypes = list(argtypes)
        return h

    def check(self, err, what: str = "native call"):
        check_error(err, self.lib, what)

    def exfiltrate(self, dest_dir: str) -> str:
        """Copy the built .so out for reuse (Exfiltrate, go/sppark.go:408-463)."""
        os.makedirs(dest_dir, exist_ok=True)
        dest = os.path.join(dest_dir, os.path.basename(self.path))
        shutil.copy2(self.path, dest)
        return dest


def _expand_flags(flags) -> List[str]:
    out = []
    for f in flags:
        if f.startswith("?"):
            cond, _, rest = f[1:].partition("-")
            if cond == "cpu":          # only toolchain condition that exists
                out.append(rest)
        else:
            out.append(f)
    return out


def build(src: str, *flags: str, force: bool = False,
          out: Optional[str] = None) -> str:
    """Compile `src` into `out` (default: a .so next to it) if missing or
    stale; returns the artifact path (the maybe-build half of Load,
    go/sppark.go:195-213).  The compiler writes a file of this process's
    own, moved in place when done, so processes building at once never
    load a half-written library."""
    src = os.path.abspath(src)
    if not os.path.exists(src):
        raise SpparkError(2, f"no such source: {src}")
    so = out or os.path.splitext(src)[0] + ".so"
    if not force and os.path.exists(so) \
            and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    cmd = [cxx, "-O2", "-std=c++17", "-fPIC", "-shared",
           f"-I{NATIVE}", "-o", tmp, src, *_expand_flags(flags)]
    if os.environ.get("SPPARK_FFI_DEBUG"):
        print("sppark-ffi build:", " ".join(cmd))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SpparkError(proc.returncode,
                          f"native build failed:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load_source(src: str, *flags: str, force: bool = False) -> NativeModule:
    """Compile (if stale) + dlopen + resolve the `_sppark` symbol table."""
    so = build(src, *flags, force=force)
    lib = ctypes.CDLL(so)
    symbols: Dict[str, int] = {}
    try:
        enum = lib.sppark_symbols
    except AttributeError:
        enum = None
    if enum is not None:
        enum.restype = ctypes.POINTER(_Entry)
        enum.argtypes = [ctypes.POINTER(ctypes.c_size_t)]
        count = ctypes.c_size_t(0)
        table = enum(ctypes.byref(count))
        for i in range(count.value):
            e = table[i]
            if e.name and e.fn:
                symbols[e.name.decode()] = e.fn
    return NativeModule(so, lib, symbols)
