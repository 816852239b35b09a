"""The Goldilocks policy of the Goldilocks NTT kernels
(sppark_tpu_torch/csrc/gl64.cuh, narrow::Gl64) compiled by the host C++
compiler and held to Python's exact integers mod p: the lazy add, sub and
mul, compared after canon, and canon itself, whose output must lie below
p.  The inputs are any 64-bit words: random ones and the edges 0, 1,
p - 1, p, p + 1, 2^32 - 1, 2^32, 2^64 - 2^32 and 2^64 - 1, each against
each other and against random words.  Integer arithmetic: compared
exactly.  The harness is compiled once, with g++, into a temporary
directory; the test skips where g++ is missing.
"""

import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

CSRC = Path(__file__).resolve().parents[1] / "sppark_tpu_torch" / "csrc"

HARNESS = r"""
#include "gl64.cuh"

// a, b, out: n words; op 0 mul, 1 add, 2 sub, 3 canon (of a), each result
// but canon's passed through canon
extern "C" void gl64_op(int op, const unsigned long long* a,
                        const unsigned long long* b, unsigned long long* out,
                        int n) {
    const narrow::Gl64 f{};
    for (int i = 0; i < n; i++)
        out[i] = op == 3 ? f.canon(a[i])
               : f.canon(op == 0 ? f.mul(a[i], b[i])
                         : op == 1 ? f.add(a[i], b[i]) : f.sub(a[i], b[i]));
}
"""

P = (1 << 64) - (1 << 32) + 1
EDGES = [0, 1, P - 1, P, P + 1, (1 << 32) - 1, 1 << 32, (1 << 64) - (1 << 32),
         (1 << 64) - 1]
OPS = ("mul", "add", "sub", "canon")
RANDOM_PAIRS = 20000


@pytest.fixture(scope="module")
def gl64_op(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("gl64")
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libgl64.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib), str(d / "harness.cpp")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).gl64_op
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    fn.restype = None
    return fn


def test_gl64_ops_vs_ints(gl64_op):
    rng = random.Random("gl64")
    rand = [rng.getrandbits(64) for _ in range(RANDOM_PAIRS)]
    pairs = ([(a, b) for a in EDGES for b in EDGES]
             + [(e, v) for e in EDGES for v in rand[:64]]
             + [(v, e) for e in EDGES for v in rand[64:128]]
             + list(zip(rand, reversed(rand))))
    a = np.array([u for u, _ in pairs], dtype=np.uint64)
    b = np.array([v for _, v in pairs], dtype=np.uint64)
    want = {"mul": [u * v % P for u, v in pairs],
            "add": [(u + v) % P for u, v in pairs],
            "sub": [(u - v) % P for u, v in pairs],
            "canon": [u % P for u, _ in pairs]}
    for k, op in enumerate(OPS):
        out = np.empty_like(a)
        gl64_op(k, a.ctypes.data, b.ctypes.data, out.ctypes.data,
                len(pairs))
        got = [int(v) for v in out]
        assert all(v < P for v in got), op
        assert got == want[op], op
