"""The 31-bit Montgomery policy of the mont32 NTT kernels
(sppark_tpu_torch/csrc/mont32.cuh, narrow::Mont32) compiled by the host C++
compiler and held to Python's exact integers: add, sub and the signed
Montgomery product, on both BabyBear fields, over random canonical words
and the edge words 0, 1, p - 1 and p - 2 against each other and against
random words.  Integer arithmetic: compared exactly.  The harness is
compiled once, with g++, into a temporary directory; the test skips where
g++ is missing.
"""

import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from sppark_tpu_torch import params

CSRC = Path(__file__).resolve().parents[1] / "sppark_tpu_torch" / "csrc"

HARNESS = r"""
#include "mont32.cuh"

// a, b, out: n words; op 0 mul, 1 add, 2 sub
extern "C" void m32_op(int op, unsigned p, unsigned pinv, const unsigned* a,
                       const unsigned* b, unsigned* out, int n) {
    const narrow::Mont32 f{p, pinv};
    for (int i = 0; i < n; i++)
        out[i] = op == 0 ? f.mul(a[i], b[i])
               : op == 1 ? f.add(a[i], b[i]) : f.sub(a[i], b[i]);
}
"""

FIELDS = ("baby_bear", "baby_bear_risc0")
OPS = ("mul", "add", "sub")
RANDOM_PAIRS = 4000


@pytest.fixture(scope="module")
def m32_op(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("mont32")
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libmont32.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib), str(d / "harness.cpp")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).m32_op
    fn.argtypes = [ctypes.c_int, ctypes.c_uint, ctypes.c_uint] + [
        ctypes.c_void_p] * 3 + [ctypes.c_int]
    fn.restype = None
    return fn


@pytest.mark.parametrize("field", FIELDS)
def test_mont32_ops_vs_ints(m32_op, field):
    fp = params.get_field(field)
    p = fp.modulus
    # what the kernels' launch gives the policy: pinv = -M0 mod 2^32
    pinv = (-fp.m0(32)) % (1 << 32)
    assert p * pinv % (1 << 32) == 1
    r_inv = pow(1 << 32, -1, p)
    rng = random.Random(field)
    edges = [0, 1, p - 1, p - 2, fp.one_mont]
    rand = [rng.randrange(p) for _ in range(RANDOM_PAIRS)]
    pairs = ([(a, b) for a in edges for b in edges]
             + [(e, v) for e in edges for v in rand[:16]]
             + [(v, e) for e in edges for v in rand[16:32]]
             + list(zip(rand, reversed(rand))))
    a = np.array([u for u, _ in pairs], dtype=np.uint32)
    b = np.array([v for _, v in pairs], dtype=np.uint32)
    want = {"mul": [u * v * r_inv % p for u, v in pairs],
            "add": [(u + v) % p for u, v in pairs],
            "sub": [(u - v) % p for u, v in pairs]}
    for k, op in enumerate(OPS):
        out = np.empty_like(a)
        m32_op(k, p, pinv, a.ctypes.data, b.ctypes.data, out.ctypes.data,
               len(pairs))
        assert out.tolist() == want[op], op
