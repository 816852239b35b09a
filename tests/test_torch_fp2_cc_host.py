"""The carry-chain fp2 element of the G2 doubling (sppark_tpu_torch/csrc/
mont_cc.cuh: the dot product FpCC's `dot`, the lane pair Fp2PairCC<N> and
the one-thread Fp2CC<N>), compiled by the host C++ compiler (each carry
primitive over an explicit flag) and held exactly:

  * `dot` (a b + x y with one Montgomery reduction) against Python ints at
    n32 = 2 (test_bm64's p = 2^64 - 59 and the Goldilocks prime, no spare
    bit: the one-chain path), 8 (BN254, Pasta: one spare bit) and 12
    (BLS12-381), operands p - 1 and p - 2 planted;
  * each coefficient of the lane pair's product and square, the host
    functions of (own, partner) that a thread of the pair runs
    (mont.cuh: pair_mul, pair_sqr_prod, pair_sqr), called once per
    parity, against the port's plain Fp2Field for nr = -1 (BN254,
    BLS12-381), -5 (BLS12-377) and 7 (the test tower);
  * the doubling formula (xyzz.cuh) on the new element against
    xyzz_dbl_plain on the four G2 curves, with Y == 0, ZZ == 0 and p - 1 /
    p - 2 coordinates planted: on the host the lane pair is an element
    that holds both coefficients and computes each by the pair's
    functions, as the two threads do, and the one-thread Fp2CC runs as it
    is.

The lane pair's shuffles themselves run only on the card
(tests/test_torch_cuda.py).  The harness is compiled once, with g++, into
a temporary directory; the test skips where g++ is missing.
"""

import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from sppark_tpu_torch.ec import get_curve_ops, kernels as EK
from sppark_tpu_torch.ff import kernels as FK
from sppark_tpu_torch.ff.ext import get_fp2_ops
from sppark_tpu_torch.ff.kernels import int_words
from sppark_tpu_torch.oracle.ec import get_oracle
from sppark_tpu_torch.params import get_curve, get_field

CSRC = Path(__file__).resolve().parents[1] / "sppark_tpu_torch" / "csrc"

HARNESS = r"""
#include "mont_cc.cuh"

namespace mont {

// the lane pair on the host: both coefficients in one element, each
// computed by the functions a thread of the pair runs on (own, partner)
template <int N>
struct HostPair {
    FpCC<N> c0, c1;
};

template <int N>
bool is_zero(const HostPair<N>& a) { return is_zero(a.c0) && is_zero(a.c1); }

template <int N>
HostPair<N> select(bool s, const HostPair<N>& a, const HostPair<N>& b) {
    return HostPair<N>{select(s, a.c0, b.c0), select(s, a.c1, b.c1)};
}

template <int N>
HostPair<N> add(const HostPair<N>& a, const HostPair<N>& b,
                const Consts<N>& c) {
    return HostPair<N>{add(a.c0, b.c0, c), add(a.c1, b.c1, c)};
}

template <int N>
HostPair<N> sub(const HostPair<N>& a, const HostPair<N>& b,
                const Consts<N>& c) {
    return HostPair<N>{sub(a.c0, b.c0, c), sub(a.c1, b.c1, c)};
}

template <int N>
HostPair<N> mul(const HostPair<N>& a, const HostPair<N>& b,
                const Consts<N>& c) {
    return HostPair<N>{pair_mul(false, a.c0, a.c1, b.c0, b.c1, c),
                       pair_mul(true, a.c1, a.c0, b.c1, b.c0, c)};
}

template <int N>
HostPair<N> sqr(const HostPair<N>& a, const Consts<N>& c) {
    FpCC<N> m0 = pair_sqr_prod(false, a.c0, a.c1, c);
    FpCC<N> m1 = pair_sqr_prod(true, a.c1, a.c0, c);
    return HostPair<N>{pair_sqr(false, m0, m1, c), pair_sqr(true, m1, m0, c)};
}

template <int N>
struct Elem<HostPair<N>> {
    static constexpr int BASE = N, THREADS = 2, WORDS = 2 * N;
    static HostPair<N> zero() {
        return HostPair<N>{Elem<FpCC<N>>::zero(), Elem<FpCC<N>>::zero()};
    }
    static HostPair<N> embed(const uint32_t* w) {
        return HostPair<N>{Elem<FpCC<N>>::embed(w), Elem<FpCC<N>>::zero()};
    }
};

}  // namespace mont

#include "xyzz.cuh"

template <int N>
static mont::FpCC<N> get(const uint32_t* a, long n, long i) {
    mont::FpCC<N> r;
    for (int k = 0; k < N; k++) r.w[k] = a[k * n + i];
    return r;
}

template <int N>
static void put(uint32_t* a, long n, long i, const mont::FpCC<N>& r) {
    for (int k = 0; k < N; k++) a[k * n + i] = r.w[k];
}

// an fp2 coordinate: (2 N, n) words, c0's then c1's
template <class E, int N>
static E get2(const uint32_t* a, long n, long i) {
    return E{get<N>(a, n, i), get<N>(a + N * n, n, i)};
}

template <class E, int N>
static void put2(uint32_t* a, long n, long i, const E& r) {
    put<N>(a, n, i, r.c0);
    put<N>(a + N * n, n, i, r.c1);
}

// op 0, dot: in (a, b, x, y) (N, n), out (N, n);
// op 1, the pair's coefficients: in (a, b) (2 N, n), out (mul c0, mul c1,
//   sqr c0, sqr c1) each (N, n), every one from (own, partner);
// op 2 / 3, the doubling on the host lane pair / on Fp2CC: in (X, Y, ZZ,
//   ZZZ) (2 N, n), out (4, 2 N, n)
template <int N>
static void run(int op, const uint32_t* const* in, uint32_t* out,
                const uint32_t* consts, long n) {
    const mont::Consts<N> c = mont::make_consts<N>(consts);
    for (long i = 0; i < n; i++) {
        if (op == 0) {
            put<N>(out, n, i, mont::dot(get<N>(in[0], n, i), get<N>(in[1], n, i),
                                        get<N>(in[2], n, i), get<N>(in[3], n, i),
                                        c));
        } else if (op == 1) {
            auto a0 = get<N>(in[0], n, i), a1 = get<N>(in[0] + N * n, n, i);
            auto b0 = get<N>(in[1], n, i), b1 = get<N>(in[1] + N * n, n, i);
            put<N>(out, n, i, mont::pair_mul(false, a0, a1, b0, b1, c));
            put<N>(out + N * n, n, i, mont::pair_mul(true, a1, a0, b1, b0, c));
            auto m0 = mont::pair_sqr_prod(false, a0, a1, c);
            auto m1 = mont::pair_sqr_prod(true, a1, a0, c);
            put<N>(out + 2 * N * n, n, i, mont::pair_sqr(false, m0, m1, c));
            put<N>(out + 3 * N * n, n, i, mont::pair_sqr(true, m1, m0, c));
        } else {
            auto dbl = [&](auto e) {
                using E = decltype(e);
                xyzz::Point<E> p{get2<E, N>(in[0], n, i), get2<E, N>(in[1], n, i),
                                 get2<E, N>(in[2], n, i), get2<E, N>(in[3], n, i)};
                xyzz::Point<E> r = xyzz::dbl(p, c);
                put2<E, N>(out, n, i, r.x);
                put2<E, N>(out + 2 * N * n, n, i, r.y);
                put2<E, N>(out + 4 * N * n, n, i, r.zz);
                put2<E, N>(out + 6 * N * n, n, i, r.zzz);
            };
            if (op == 2) dbl(mont::HostPair<N>{});
            else dbl(mont::Fp2CC<N>{});
        }
    }
}

extern "C" int fp2_cc(int n32, int op, const uint32_t* const* in,
                      uint32_t* out, const uint32_t* consts, long n) {
    switch (n32) {
        case 2: run<2>(op, in, out, consts, n); return 0;
        case 8: run<8>(op, in, out, consts, n); return 0;
        case 12: run<12>(op, in, out, consts, n); return 0;
        default: return 1;
    }
}
"""

#: the dot's fields: n32 = 2 without a spare bit (two), 8 with one spare
#: bit (Pasta) and two (BN254), 12
DOT_FIELDS = ["test_bm64_fp", "goldilocks_bm", "pallas", "bn254_fp",
              "bls12_381_fp"]
#: the G2 curves: nr -1 (n32 8, 12), -5 (12), 7 (2)
G2_CURVES = ["bn254_g2", "bls12_381_g2", "bls12_377_g2", "test_bm64_g2"]
LANES = 40


@pytest.fixture(scope="module")
def fp2_cc(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("fp2_cc")
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libfp2_cc.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib), str(d / "harness.cpp")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).fp2_cc
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_long]
    fn.restype = ctypes.c_int
    return fn


def _call(fn, n32, op, ins, consts, rows):
    """The harness's op over limb-major int32 (words, n) inputs; returns
    the (rows, n) int32 output."""
    n = ins[0].shape[1]
    arrs = [np.ascontiguousarray(c.numpy()).view(np.uint32) for c in ins]
    ptrs = (ctypes.c_void_p * len(arrs))(*(a.ctypes.data for a in arrs))
    out = np.zeros((rows, n), np.uint32)
    assert fn(n32, op, ptrs, out.ctypes.data, consts.ctypes.data, n) == 0
    return torch.from_numpy(out.view(np.int32))


def _words(values, n32):
    return torch.from_numpy(np.array(
        [int_words(v, n32) for v in values], dtype=np.uint32).T.copy().view(
            np.int32))


def _ints(t, n32):
    w = t.numpy().view(np.uint32)
    return [sum(int(w[k, i]) << (32 * k) for k in range(n32))
            for i in range(w.shape[1])]


@pytest.mark.parametrize("field", DOT_FIELDS)
def test_dot_vs_ints(fp2_cc, field):
    fp = get_field(field)
    p, n32 = fp.modulus, fp.n_ref_limbs
    rng = random.Random(field)
    edge = [p - 1, p - 2, 0, 1]
    ops = [[rng.randrange(p) for _ in range(LANES)] for _ in range(4)]
    for k in range(4):              # every operand p - 1 / p - 2 somewhere
        for lane, v in enumerate(edge * 2):
            ops[k][lane] = edge[(lane + k) % 4] if lane < 4 else v
    ops[0][8:12] = ops[1][8:12] = ops[2][8:12] = ops[3][8:12] = [p - 1] * 4
    ops[0][12:16] = ops[1][12:16] = ops[2][12:16] = ops[3][12:16] = [p - 2] * 4
    got = _call(fp2_cc, n32, 0, [_words(o, n32) for o in ops],
                FK.field_consts(fp), n32)
    rinv = pow(fp.R, -1, p)
    want = [(a * b + x * y) * rinv % p for a, b, x, y in zip(*ops)]
    assert _ints(got, n32) == want


def _fp2_words(F, rng, p, n):
    vals = [(rng.randrange(p), rng.randrange(p)) for _ in range(n)]
    vals[:6] = [(p - 1, p - 1), (p - 2, p - 1), (p - 1, p - 2), (0, p - 1),
                (p - 2, 0), (0, 0)]
    return F.from_int_list(vals)


@pytest.mark.parametrize("curve", G2_CURVES)
def test_lane_pair_coefficients_vs_plain(fp2_cc, curve):
    cp = get_curve(curve)
    F = get_fp2_ops(cp.fp2, FK.PLAIN)
    rng = random.Random(curve)
    p, n32 = cp.field.modulus, cp.field.n_ref_limbs
    a, b = _fp2_words(F, rng, p, LANES), _fp2_words(F, rng, p, LANES)
    got = _call(fp2_cc, n32, 1, [a, b], EK._consts(curve), 4 * n32)
    assert torch.equal(got[:2 * n32], F.mul(a, b))
    assert torch.equal(got[2 * n32:], F.sqr(a))


def _points(curve):
    """xyzz points with ZZ != 1 (2 P by the plain doubling), planted: Y ==
    0, ZZ == 0, and coordinates of p - 1 and p - 2 in every coefficient."""
    cp = get_curve(curve)
    o = get_oracle(cp)
    rng = random.Random(curve + " dbl")
    ops = get_curve_ops(curve, FK.PLAIN)
    pts = ops.xyzz_dbl(ops.affine_to_xyzz(ops.affine_from_ints(
        [o.random_point(rng) for _ in range(16)])))
    pts = tuple(c.clone() for c in pts)
    pts[1][:, 0] = 0
    pts[2][:, 1] = 0
    pts[1][:cp.field.n_ref_limbs, 5] = 0        # c0 of Y alone zero
    p, n32 = cp.field.modulus, cp.field.n_ref_limbs
    m1, m2 = (torch.tensor(int_words(v, n32), dtype=torch.int64).to(
        torch.int32) for v in (p - 1, p - 2))
    for k, c in enumerate(pts):
        c[:, 2] = torch.cat([m1, m1])
        c[:, 3] = torch.cat([m2, m2])
        c[:, 4] = torch.cat([m1, m2] if k % 2 else [m2, m1])
    return pts


@pytest.mark.parametrize("one_thread", [False, True],
                         ids=["lane pair", "one thread"])
@pytest.mark.parametrize("curve", G2_CURVES)
def test_dbl_vs_plain(fp2_cc, curve, one_thread):
    cp = get_curve(curve)
    n32 = cp.field.n_ref_limbs
    p = _points(curve)
    got = _call(fp2_cc, n32, 3 if one_thread else 2, p, EK._consts(curve),
                8 * n32).split(2 * n32)
    want = EK.xyzz_dbl_plain(curve, p)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(bool((c[:, :2] == 0).all()) for c in got[2:])
