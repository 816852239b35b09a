"""The G1 pair prep and finish (sppark_tpu_torch/csrc/pair.cuh) and the
xyzz doubling (csrc/xyzz.cuh) over the carry-chain element mont::FpCC<N>
(csrc/mont_cc.cuh), as the card's ec_pair_finish and ec_xyzz_dbl run
them, compiled by the host C++ compiler (each carry primitive over an
explicit flag) and held word for word against the plain versions
(ec/kernels.py: affine_pair_prep_plain, affine_pair_finish_plain,
xyzz_dbl_plain) at n32 = 2 (test_bm64, the one-chain path), 8 (Pallas)
and 12 (BLS12-381): every flag word (0, 1, 3, 4, 8), tangent lanes,
coordinates and inverses p - 1 and p - 2, and for the doubling Y == 0 and
ZZ == 0.  On test_bm64 a few lanes are also held against the JAX
package's CurveOps.xyzz_dbl and sppark_tpu.msm.tree.affine_pair_add.
Integer arithmetic: compared exactly.  The harness is compiled once, with
g++, into a temporary directory; the test skips where g++ is missing.
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
from sppark_tpu_torch.ff.bigmont import to_jax_planes
from sppark_tpu_torch.ff.kernels import int_words
from sppark_tpu_torch.msm.tree import batch_inv_flat
from sppark_tpu_torch.oracle.ec import get_oracle
from sppark_tpu_torch.params import get_curve

CSRC = Path(__file__).resolve().parents[1] / "sppark_tpu_torch" / "csrc"

HARNESS = r"""
#include "mont_cc.cuh"
#include "pair.cuh"
#include "xyzz.cuh"

template <int N>
using E = mont::FpCC<N>;

// word k of lane i of a limb-major (N, n) array at k n + i
template <int N>
static E<N> get(const uint32_t* a, long n, long i) {
    E<N> r;
    for (int k = 0; k < N; k++) r.w[k] = a[k * n + i];
    return r;
}

template <int N>
static void put(uint32_t* a, long n, long i, const E<N>& r) {
    for (int k = 0; k < N; k++) a[k * n + i] = r.w[k];
}

// op 0, prep: in (x1, y1, x2, y2), out den and `flags`; op 1, finish: in
// (x1, y1, x2, y2, inv) and `flags`, out (x, y); op 2, dbl: in (X, Y, ZZ,
// ZZZ), out (X, Y, ZZ, ZZZ)
template <int N>
static void run(int op, const uint32_t* const* in, uint32_t* flags,
                uint32_t* out, const uint32_t* consts, long n) {
    const mont::Consts<N> c = mont::make_consts<N>(consts);
    for (long i = 0; i < n; i++) {
        if (op == 0) {
            E<N> den;
            flags[i] = pair::prep(get<N>(in[0], n, i), get<N>(in[1], n, i),
                                  get<N>(in[2], n, i), get<N>(in[3], n, i),
                                  den, c);
            put<N>(out, n, i, den);
        } else if (op == 1) {
            E<N> x, y;
            pair::finish(get<N>(in[0], n, i), get<N>(in[1], n, i),
                         get<N>(in[2], n, i), get<N>(in[3], n, i),
                         get<N>(in[4], n, i), flags[i], x, y, c);
            put<N>(out, n, i, x);
            put<N>(out + N * n, n, i, y);
        } else {
            xyzz::Point<E<N>> p{get<N>(in[0], n, i), get<N>(in[1], n, i),
                                get<N>(in[2], n, i), get<N>(in[3], n, i)};
            xyzz::Point<E<N>> r = xyzz::dbl(p, c);
            put<N>(out, n, i, r.x);
            put<N>(out + N * n, n, i, r.y);
            put<N>(out + 2 * N * n, n, i, r.zz);
            put<N>(out + 3 * N * n, n, i, r.zzz);
        }
    }
}

extern "C" int pair_cc(int n32, int op, const uint32_t* const* in,
                       uint32_t* flags, uint32_t* out,
                       const uint32_t* consts, long n) {
    switch (n32) {
        case 2: run<2>(op, in, flags, out, consts, n); return 0;
        case 8: run<8>(op, in, flags, out, consts, n); return 0;
        case 12: run<12>(op, in, flags, out, consts, n); return 0;
        default: return 1;
    }
}
"""

#: n32 = 2 (p = 2^64 - 59, no spare bit: one chain), 8 and 12
CURVES = ["test_bm64", "pallas", "bls12_381"]
GENERIC = 24
#: the planted pair lanes, after the generic ones
DOUBLING, CANCEL, INF_L, INF_R, INF_BOTH, Y0, EDGE = range(GENERIC,
                                                           GENERIC + 7)
LANES = GENERIC + 10         # EDGE .. EDGE + 3: coordinates p - 1, p - 2


@pytest.fixture(scope="module")
def pair_cc(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("pair_cc")
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libpair_cc.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib), str(d / "harness.cpp")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).pair_cc
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_long]
    fn.restype = ctypes.c_int
    return fn


def _call(fn, curve, op, coords, flags, rows):
    """The harness's op over limb-major int32 (n32, n) coordinates; returns
    (out as `rows` int32 coordinates of (n32, n), flags)."""
    n32, n = coords[0].shape
    ins = [np.ascontiguousarray(c.numpy()).view(np.uint32) for c in coords]
    ptrs = (ctypes.c_void_p * len(ins))(*(a.ctypes.data for a in ins))
    f = (np.zeros(n, np.uint32) if flags is None
         else np.ascontiguousarray(flags.numpy()).view(np.uint32))
    out = np.zeros((rows * n32, n), np.uint32)
    assert fn(n32, op, ptrs, f.ctypes.data, out.ctypes.data,
              EK._consts(curve).ctypes.data, n) == 0
    out = torch.from_numpy(out.view(np.int32))
    return tuple(out.split(n32)), torch.from_numpy(f.view(np.int32))


def _col(fp, v):
    return torch.tensor(int_words(v, fp.n_ref_limbs),
                        dtype=torch.int64).to(torch.int32)


def _pairs(curve):
    """Affine l, r: generic chords, then planted lanes: a doubling (the
    tangent), l == -r, l, r or both at infinity, a y == 0 doubling (off the
    curve: the case that goes to infinity) and four lanes of coordinates
    p - 1 and p - 2 (the carry chains' edge words); their inverses, with
    p - 1 and p - 2 planted on the edge lanes, and the prep's flags."""
    cp = get_curve(curve)
    o = get_oracle(cp)
    rng = random.Random(curve)
    pool = [o.random_point(rng) for _ in range(8)]
    L = [pool[rng.randrange(8)] for _ in range(LANES)]
    R = [pool[(pool.index(p) + 1 + rng.randrange(7)) % 8] for p in L]
    R[DOUBLING] = L[DOUBLING]
    R[CANCEL] = o.affine_neg(L[CANCEL])
    L[INF_L] = L[INF_BOTH] = R[INF_R] = R[INF_BOTH] = o.infinity_affine()
    ops = get_curve_ops(curve, FK.PLAIN)
    l, r = ops.affine_from_ints(L), ops.affine_from_ints(R)
    l[1][:, Y0] = r[1][:, Y0] = 0
    r[0][:, Y0] = l[0][:, Y0]
    p = cp.field.modulus
    m1, m2 = _col(cp.field, p - 1), _col(cp.field, p - 2)
    for k, (a, b) in enumerate(((m1, m2), (m2, m1), (m1, m1), (m2, m2))):
        l[0][:, EDGE + k], l[1][:, EDGE + k] = a, b
        r[0][:, EDGE + k], r[1][:, EDGE + k] = b, a
    den, flags = EK.affine_pair_prep_plain(curve, l, r)
    inv = batch_inv_flat(ops.F, den).clone()
    inv[:, EDGE] = m1
    inv[:, EDGE + 1] = m2
    return l, r, inv, flags


def _points(curve):
    """xyzz points with ZZ != 1 (2 P by the plain doubling), planted: Y ==
    0, ZZ == 0, and every coordinate p - 1 or p - 2."""
    cp = get_curve(curve)
    o = get_oracle(cp)
    rng = random.Random(curve + " dbl")
    ops = get_curve_ops(curve, FK.PLAIN)
    pts = ops.xyzz_dbl(ops.affine_to_xyzz(ops.affine_from_ints(
        [o.random_point(rng) for _ in range(16)])))
    pts = tuple(c.clone() for c in pts)
    pts[1][:, 0] = 0
    pts[2][:, 1] = 0
    p = cp.field.modulus
    m1, m2 = _col(cp.field, p - 1), _col(cp.field, p - 2)
    for k, c in enumerate(pts):
        c[:, 2] = m1
        c[:, 3] = m2
        c[:, 4] = m1 if k % 2 else m2
    return pts


@pytest.mark.parametrize("curve", CURVES)
def test_pair_prep_finish_carry_chain_vs_plain(pair_cc, curve):
    l, r, inv, flags = _pairs(curve)
    assert sorted(set(flags.tolist())) == [0, 1, 3, 4, 8]
    assert int(flags[DOUBLING]) == EK.ACTIVE | EK.DBL
    (den,), got_flags = _call(pair_cc, curve, 0, l + r, None, 1)
    want = EK.affine_pair_prep_plain(curve, l, r)
    assert torch.equal(den, want[0]) and torch.equal(got_flags, want[1])
    got, _ = _call(pair_cc, curve, 1, l + r + (inv,), flags, 2)
    want = EK.affine_pair_finish_plain(curve, l, r, inv, flags)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("curve", CURVES)
def test_xyzz_dbl_carry_chain_vs_plain(pair_cc, curve):
    p = _points(curve)
    got, _ = _call(pair_cc, curve, 2, p, None, 4)
    want = EK.xyzz_dbl_plain(curve, p)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(bool((c[:, :2] == 0).all()) for c in got[2:])


def test_carry_chain_pair_add_and_dbl_vs_jax(pair_cc):
    """test_bm64: prep -> the plain batch inversion -> finish through the
    harness against the JAX package's affine_pair_add, and the doubling
    against its CurveOps.xyzz_dbl, on the planted lanes."""
    import jax
    import jax.numpy as jnp
    from sppark_tpu.ec import get_curve_ops as jax_curve_ops
    from sppark_tpu.msm.tree import affine_pair_add as jax_pair_add

    curve = "test_bm64"
    lanes = slice(GENERIC - 4, EDGE)
    l, r, _, _ = _pairs(curve)
    l, r = (tuple(c[:, lanes].contiguous() for c in t) for t in (l, r))
    (den,), flags = _call(pair_cc, curve, 0, l + r, None, 1)
    inv = batch_inv_flat(get_curve_ops(curve, FK.PLAIN).F, den)
    got, _ = _call(pair_cc, curve, 1, l + r + (inv,), flags, 2)
    F = jax_curve_ops(curve).F
    want = jax.jit(lambda a, b: jax_pair_add(F, 0, a, b))(
        *(tuple(jnp.asarray(to_jax_planes(c))[:, None, :] for c in t)
          for t in (l, r)))
    for g, w in zip(got, want):
        assert np.array_equal(to_jax_planes(g),
                              np.asarray(w[:, 0, :], np.uint32))
    p = _points(curve)
    got, _ = _call(pair_cc, curve, 2, p, None, 4)
    want = jax_curve_ops(curve).xyzz_dbl(
        tuple(jnp.asarray(to_jax_planes(c)) for c in p))
    assert all(np.array_equal(to_jax_planes(g), np.asarray(w, np.uint32))
               for g, w in zip(got, want))
