"""The port's remaining modules against the JAX package's and the oracle,
on the CPU:

  * ffi/loader.py (tests/test_loader.py's six cases, on the repo's
    native/poc.cpp as input data) and ffi/native.py:cpu_msm over the
    port's copy of the native source (tests/test_native.py's cases);
  * util/slices.py:as_u32_view;
  * the jacobian ops, xyzz_to_jacobian and scalar_mul of ec/core.py
    against the oracle (tests/test_ec.py:82, 103, 127) and word for word
    against the JAX package's generic CurveOps on test_bm64 and
    test_gl64;
  * the madd's `sign`: the plain version against the JAX package's plain
    madd with sign, and the card's route (the point table beside its
    negation, the sign in the index) on the plain indexed madd.
"""

import ctypes
import os
import shutil

import numpy as np
import pytest
import torch

from sppark_tpu_torch.ec import get_curve_ops
from sppark_tpu_torch.ec import kernels as EK
from sppark_tpu_torch.ff import bigmont, gl64
from sppark_tpu_torch.ffi import cpu_available, cpu_msm
from sppark_tpu_torch.ffi.loader import _CError, build, load_source
from sppark_tpu_torch.oracle.ec import AffinePoint, get_oracle
from sppark_tpu_torch.oracle.msm import msm_naive
from sppark_tpu_torch.params import get_curve
from sppark_tpu_torch.util import SpparkError, as_u32_view

NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")


# -- ffi/loader.py --------------------------------------------------------------------

@pytest.fixture(scope="module")
def poc(tmp_path_factory):
    scratch = tmp_path_factory.mktemp("poc")
    return load_source(shutil.copy(os.path.join(NATIVE, "poc.cpp"), scratch))


def test_wrap_symbols_resolved(poc):
    assert set(poc.symbols) >= {"sppark_poc_add", "sppark_poc_fill",
                                "sppark_poc_fail"}


def test_call_registered(poc):
    add = poc.fn("sppark_poc_add", restype=ctypes.c_int,
                 argtypes=[ctypes.c_int, ctypes.c_int])
    assert add(20, 22) == 42


def test_error_contract(poc):
    fill = poc.fn("sppark_poc_fill", restype=_CError,
                  argtypes=[ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t])
    buf = (ctypes.c_uint64 * 5)()
    poc.check(fill(buf, 5))
    assert list(buf) == [0, 1, 4, 9, 16]
    with pytest.raises(SpparkError) as ei:
        poc.check(fill(None, 1), "fill")
    assert ei.value.code == 22 and "null destination" in str(ei.value)
    fail = poc.fn("sppark_poc_fail", restype=_CError)
    with pytest.raises(SpparkError) as ei:
        poc.check(fail())
    assert ei.value.code == 7


def test_stale_rebuild_and_exfiltrate(poc, tmp_path):
    so_before = os.path.getmtime(poc.path)
    src = poc.path.replace(".so", ".cpp")
    os.utime(src, (so_before + 5, so_before + 5))
    rebuilt = build(src)
    assert os.path.getmtime(rebuilt) > so_before
    dest = poc.exfiltrate(str(tmp_path / "out"))
    assert os.path.exists(dest)


def test_conditional_flags(tmp_path):
    src = shutil.copy(os.path.join(NATIVE, "poc.cpp"), tmp_path)
    mod = load_source(src, "?cpu--DSPPARK_TEST_KEPT", "?cuda--DBOGUS_FLAG",
                      force=True)
    assert "sppark_poc_add" in mod.symbols


def test_build_failure_reports_stderr(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this does not compile")
    with pytest.raises(SpparkError) as ei:
        build(str(bad))
    assert "native build failed" in str(ei.value)


# -- ffi/native.py ---------------------------------------------------------------------

native = pytest.mark.skipif(not cpu_available(),
                            reason="native toolchain unavailable")


@native
@pytest.mark.parametrize("curve", ["pallas", "bls12_381", "bn254",
                                   "bls12_377", "vesta"])
def test_native_msm_matches_oracle(curve, rng):
    cp = get_curve(curve)
    o = get_oracle(cp)
    base = [o.random_point(rng) for _ in range(6)]
    n = 48
    pts = [base[i % 6] for i in range(n)]
    pts[3] = AffinePoint(0, 0, True)
    ks = [rng.randrange(cp.scalar.modulus) for _ in range(n)]
    ks[1], ks[2] = 0, cp.scalar.modulus - 1
    got = cpu_msm(curve, pts, ks)
    want = msm_naive(cp, pts, ks)
    assert (got.x, got.y, got.inf) == (want.x, want.y, want.inf)


@native
def test_native_msm_multithreaded(rng):
    cp = get_curve("pallas")
    o = get_oracle(cp)
    pts = [o.random_point(rng) for _ in range(32)]
    ks = [rng.randrange(cp.scalar.modulus) for _ in range(32)]
    a = cpu_msm("pallas", pts, ks, nthreads=1)
    b = cpu_msm("pallas", pts, ks, nthreads=4)
    assert (a.x, a.y) == (b.x, b.y)


def test_native_msm_rejects_g2():
    with pytest.raises(SpparkError):
        cpu_msm("bls12_381_g2", [], [])


@native
def test_native_msm_empty():
    assert cpu_msm("pallas", [], []).inf


# -- util/slices.py -------------------------------------------------------------------

def test_as_u32_view():
    a = np.arange(6, dtype=np.uint64)
    v = as_u32_view(a, 4)
    assert v.dtype == np.uint32 and v.size == 12
    assert as_u32_view(v) is v or np.shares_memory(as_u32_view(v), v)
    with pytest.raises(ValueError):
        as_u32_view(a, 5)


# -- the jacobian ops and scalar_mul against the oracle ------------------------------

def sample(curve, n, rng):
    o = get_oracle(get_curve(curve))
    return o, [o.random_point(rng) for _ in range(n)]


def ints_of(want, o=None):
    """An oracle point as affine_to_ints gives it: infinity as the zero
    coordinates of its degree."""
    z = o.zero if o is not None else 0
    return (z, z) if want.inf else (want.x, want.y)


@pytest.mark.parametrize("curve", ["pallas", "bn254"])
def test_jacobian_add_dbl(curve, rng):
    o, pts = sample(curve, 4, rng)
    ops = get_curve_ops(curve)
    a = ops.affine_to_jacobian(ops.affine_from_ints(pts))
    b = ops.affine_to_jacobian(ops.affine_from_ints(pts[::-1]))
    got = ops.affine_to_ints(ops.jacobian_to_affine(ops.jacobian_add(a, b)))
    for i, (p, q) in enumerate(zip(pts, pts[::-1])):
        assert got[i] == ints_of(o.jacobian_to_affine(
            o.jacobian_add(o.to_jacobian(p), o.to_jacobian(q)))), i
    got2 = ops.affine_to_ints(ops.jacobian_to_affine(ops.jacobian_add(a, a)))
    got3 = ops.affine_to_ints(ops.jacobian_to_affine(ops.jacobian_dbl(a)))
    for i, p in enumerate(pts):
        want = ints_of(o.jacobian_to_affine(o.jacobian_dbl(o.to_jacobian(p))))
        assert got2[i] == got3[i] == want, i


def test_jacobian_special_lanes(rng):
    """p + (-p), p + infinity, infinity + q, infinity + infinity."""
    curve = "pallas"
    o, (p0, p1) = sample(curve, 2, rng)
    inf = o.infinity_affine()
    ops = get_curve_ops(curve)
    ls, rs = [p0, p0, inf, inf], [o.affine_neg(p0), inf, p1, inf]
    out = ops.jacobian_add(ops.affine_to_jacobian(ops.affine_from_ints(ls)),
                           ops.affine_to_jacobian(ops.affine_from_ints(rs)))
    assert ops.jacobian_is_inf(out).tolist() == [True, False, False, True]
    assert ops.affine_to_ints(ops.jacobian_to_affine(out)) == [
        (0, 0), (p0.x, p0.y), (p1.x, p1.y), (0, 0)]


@pytest.mark.parametrize("curve", ["pallas", "test_bm64_g2"])
def test_xyzz_to_jacobian_roundtrip(curve, rng):
    _, pts = sample(curve, 4, rng)
    ops = get_curve_ops(curve)
    x2 = ops.xyzz_dbl(ops.affine_to_xyzz(ops.affine_from_ints(pts)))
    viaj = ops.jacobian_to_affine(ops.xyzz_to_jacobian(x2))
    assert ops.affine_to_ints(viaj) == ops.affine_to_ints(
        ops.xyzz_to_affine(x2))


@pytest.mark.parametrize("curve", ["test_bm64", "test_bm64_g2"])
def test_scalar_mul_matches_oracle(curve, rng):
    o, pts = sample(curve, 2, rng)
    pts.append(o.infinity_affine())
    ops = get_curve_ops(curve)
    r = get_curve(curve).scalar.modulus
    ks = [rng.randrange(r), 0, 1, r - 1]
    for k in ks:
        got = ops.affine_to_ints(ops.xyzz_to_affine(ops.scalar_mul(
            ops.affine_from_ints(pts), k)))
        for i, p in enumerate(pts):
            assert got[i] == ints_of(o.jacobian_to_affine(
                o.scalar_mul(p, k)), o), (k, i)


# -- word for word against the JAX package's generic CurveOps -------------------------

def to_jax(curve, t):
    """The port's coordinate words -> the JAX package's planes."""
    if get_curve(curve).field.modulus == gl64.P:
        return gl64.to_jax_planes(t[0])
    return bigmont.to_jax_planes(t)


def same(curve, port, jax_out):
    return all(np.array_equal(to_jax(curve, p), np.asarray(j))
               for p, j in zip(port, jax_out))


@pytest.mark.parametrize("curve", ["test_bm64", "test_gl64"])
def test_jacobian_ops_match_jax(curve, rng):
    """affine_to_jacobian, jacobian_add (with a doubling, a cancelling
    and two infinity lanes), jacobian_dbl, xyzz_to_jacobian, the affine
    results and scalar_mul, word for word."""
    from sppark_tpu.ec import get_curve_ops as jax_curve_ops
    o, pts = sample(curve, 4, rng)
    inf = o.infinity_affine()
    ls = pts + [pts[0], pts[1], inf, inf]
    rs = pts[::-1] + [pts[0], o.affine_neg(pts[1]), pts[2], inf]
    ops, jops = get_curve_ops(curve), jax_curve_ops(curve)
    a = ops.affine_to_jacobian(ops.affine_from_ints(ls))
    b = ops.affine_to_jacobian(ops.affine_from_ints(rs))
    ja = jops.affine_to_jacobian(jops.affine_from_ints(ls))
    jb = jops.affine_to_jacobian(jops.affine_from_ints(rs))
    assert same(curve, a, ja) and same(curve, b, jb)
    s, js = ops.jacobian_add(a, b), jops.jacobian_add(ja, jb)
    assert same(curve, s, js)
    assert same(curve, ops.jacobian_dbl(s), jops.jacobian_dbl(js))
    assert same(curve, ops.jacobian_to_affine(s),
                jops.jacobian_to_affine(js))
    x2 = ops.xyzz_dbl(ops.affine_to_xyzz(ops.affine_from_ints(ls)))
    jx2 = jops.xyzz_dbl(jops.affine_to_xyzz(jops.affine_from_ints(ls)))
    assert same(curve, ops.xyzz_to_jacobian(x2), jops.xyzz_to_jacobian(jx2))
    k = rng.randrange(1 << 9, 1 << 10)     # short: JAX runs these eagerly
    assert same(curve, ops.scalar_mul(ops.affine_from_ints(ls), k),
                jops.scalar_mul(jops.affine_from_ints(ls), k))


# -- the madd's sign ----------------------------------------------------------------------

@pytest.mark.parametrize("curve", ["test_bm64", "pallas"])
def test_madd_sign(curve, rng):
    """The plain madd with `sign` against the oracle's (and on test_bm64
    word for word against the JAX package's plain madd with sign), and
    the card's route, the table beside its negation and the sign in the
    index, on the plain indexed madd: the same words, per-lane points and
    a table with an index alike."""
    import jax.numpy as jnp
    o, pts = sample(curve, 4, rng)
    inf = o.infinity_affine()
    acc_pts = pts + [pts[0], pts[1], inf, pts[2]]
    add_pts = pts[::-1] + [pts[0], pts[1], pts[3], inf]
    sign_l = [True, False, True, False, True, False, True, True]
    ops = get_curve_ops(curve)
    acc = ops.affine_to_xyzz(ops.affine_from_ints(acc_pts))
    add = ops.affine_from_ints(add_pts)
    sign = torch.tensor(sign_l)
    got = EK.xyzz_madd_plain(curve, acc, add, sign=sign)
    assert ops.affine_to_ints(ops.xyzz_to_affine(got)) == [
        ints_of(o.jacobian_to_affine(o.jacobian_add(
            o.to_jacobian(p), o.to_jacobian(o.affine_neg(q) if s else q))))
        for p, q, s in zip(acc_pts, add_pts, sign_l)]
    if curve == "test_bm64":
        from sppark_tpu.ec import get_curve_ops as jax_curve_ops
        jops = jax_curve_ops(curve)
        jgot = jops.xyzz_madd(
            jops.affine_to_xyzz(jops.affine_from_ints(acc_pts)),
            jops.affine_from_ints(add_pts), sign=jnp.asarray(sign_l))
        assert same(curve, got, jgot)
    p2, table, idx = EK._signed_table(curve, acc, add, None, sign)
    assert idx.tolist() == [i + 8 * s for i, s in enumerate(sign_l)]
    assert all(torch.equal(x, y) for x, y in zip(
        EK.xyzz_madd_plain(curve, p2, table, idx), got))
    tidx = torch.tensor([7, 0, 3, 3, 5, 1, 6, 2], dtype=torch.int32)
    _, table, idx = EK._signed_table(curve, acc, add, tidx, sign)
    want = EK.xyzz_madd_plain(curve, acc, add, tidx, sign)
    assert all(torch.equal(x, y) for x, y in zip(
        EK.xyzz_madd_plain(curve, acc, table, idx), want))
