"""The carry-chain Montgomery element (sppark_tpu_torch/csrc/mont_cc.cuh,
mont::FpCC<N>) compiled by the host C++ compiler, where each carry
primitive runs over an explicit flag, and held to Python's exact integers:
mul, sqr, add and sub at n32 = 2 (the one-chain path), 8 and 12 (the even
and odd chains), on random canonical words and on the edge words 0, 1,
p - 1 and p - 2 against each other and against random words.  Integer
arithmetic: compared exactly.  The harness is compiled once, with g++,
into a temporary directory; the test skips where g++ is missing.
"""

import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from sppark_tpu_torch import params
from sppark_tpu_torch.ff import kernels as FK

CSRC = Path(__file__).resolve().parents[1] / "sppark_tpu_torch" / "csrc"

HARNESS = r"""
#include "mont_cc.cuh"

template <int N>
static void run(int op, const uint32_t* a, const uint32_t* b,
                const uint32_t* h, uint32_t* out, int n) {
    const mont::Consts<N> c = mont::make_consts<N>(h);
    for (int i = 0; i < n; i++) {
        mont::FpCC<N> x, y, r;
        for (int k = 0; k < N; k++) {
            x.w[k] = a[i * N + k];
            y.w[k] = b[i * N + k];
        }
        switch (op) {
            case 0: r = mont::mul(x, y, c); break;
            case 1: r = mont::sqr(x, c); break;
            case 2: r = mont::add(x, y, c); break;
            default: r = mont::sub(x, y, c);
        }
        for (int k = 0; k < N; k++) out[i * N + k] = r.w[k];
    }
}

// a, b, out: n elements of n32 words each, element-major
extern "C" int cc_op(int n32, int op, const uint32_t* a, const uint32_t* b,
                     const uint32_t* consts, uint32_t* out, int n) {
    switch (n32) {
        case 2: run<2>(op, a, b, consts, out, n); return 0;
        case 8: run<8>(op, a, b, consts, out, n); return 0;
        case 12: run<12>(op, a, b, consts, out, n); return 0;
        default: return 1;
    }
}
"""

#: n32 = 2 (test_bm64's base field p = 2^64 - 59, no spare bit, and its
#: scalar field), 8 (BLS12-381 Fr, BN254 Fr) and 12 (BLS12-381 Fp)
FIELDS = {"test_bm64": lambda: params.get_curve("test_bm64").field,
          "test_bm64_fr": lambda: params.get_field("test_bm64_fr"),
          "bls12_381_fr": lambda: params.get_field("bls12_381_fr"),
          "bn254_fr": lambda: params.get_field("bn254_fr"),
          "bls12_381_fp": lambda: params.get_curve("bls12_381").field}
OPS = ("mul", "sqr", "add", "sub")
RANDOM_PAIRS = 1500


@pytest.fixture(scope="module")
def cc_op(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("mont_cc")
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libmont_cc.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib), str(d / "harness.cpp")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).cc_op
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def _words(values, n32):
    return np.array([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(n32)]
                     for v in values], dtype=np.uint32)


def _ints(words):
    return [sum(int(w) << (32 * k) for k, w in enumerate(row))
            for row in words]


@pytest.mark.parametrize("field", list(FIELDS))
def test_carry_chain_ops_vs_ints(cc_op, field):
    fp = FIELDS[field]()
    p, n32 = fp.modulus, fp.n_ref_limbs
    r_inv = pow(1 << (32 * n32), -1, p)
    rng = random.Random(field)
    edges = [0, 1, p - 1, p - 2]
    rand = [rng.randrange(p) for _ in range(RANDOM_PAIRS)]
    pairs = ([(a, b) for a in edges for b in edges]
             + [(e, v) for e in edges for v in rand[:16]]
             + [(v, e) for e in edges for v in rand[16:32]]
             + list(zip(rand, reversed(rand))))
    a = _words([u for u, _ in pairs], n32)
    b = _words([v for _, v in pairs], n32)
    consts = FK.field_consts(fp)
    want = {"mul": [u * v * r_inv % p for u, v in pairs],
            "sqr": [u * u * r_inv % p for u, _ in pairs],
            "add": [(u + v) % p for u, v in pairs],
            "sub": [(u - v) % p for u, v in pairs]}
    for k, op in enumerate(OPS):
        out = np.empty_like(a)
        assert cc_op(n32, k, a.ctypes.data, b.ctypes.data,
                     consts.ctypes.data, out.ctypes.data, len(pairs)) == 0
        assert _ints(out) == want[op], op
