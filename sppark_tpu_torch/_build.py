"""Builds the CUDA sources under csrc/ at first use and loads them.

Each `csrc/<name>.cu` is compiled by nvcc for Hopper (`sm_90a`) into a
shared library with a plain C interface, under `build/` next to this file
(the directory is git-ignored), and loaded with ctypes.  The library's
file name carries a hash of its source, of every shared header
`csrc/*.cuh` and of the flags, so an edited source or header is rebuilt
and an unchanged one is reused.  All missing libraries are compiled
at once, one nvcc process per source.  A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

from .util.errors import SpparkError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise SpparkError(3, "nvcc not found: the CUDA kernels build only where "
                         "the CUDA toolkit is installed")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = ()) -> Dict[str, dict]:
    """Compile every named source (default: all) whose library is missing,
    all nvcc processes started together.  Returns {name: {"seconds": wall
    time of the build, "log": compiler output}} for what it compiled."""
    names = list(names) or sources()
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed, info = [], {}
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, _target(name))
        info[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise SpparkError(4, "\n".join(failed))
    return info


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built if needed, with
    `argtypes` set from `signatures` and every function returning int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib
