"""The port's G2 slice (sppark_tpu_torch: ff/ext.py's Fp2Field, the
degree-2 paths of ec/ and msm/, the plain versions of the fp2 point
kernels) against the JAX package and the oracle on the CPU, word for
word, through the fp2 JAX-plane converters ((c0 planes, c1 planes) <->
(2 n32, ...) words).

  * Fp2Field ops against sppark_tpu.ff.ext.Fp2Field and the Fp2 oracle
    (nonresidues 7 and -5);
  * xyzz_madd / add / dbl against sppark_tpu.ec's CurveOps on test_bm64_g2,
    bn254_g2 and bls12_381_g2 with the planted lanes, and on bls12_377_g2
    against the oracle's formulas;
  * xyzz_to_affine on test_bm64_g2 only; wire ingestion;
  * an MSM on device="cpu" against msm_naive: test_bm64_g2 with infinity,
    0, r - 1, all-equal scalars (the replica spill) and an empty top
    window.

No test interprets a Pallas kernel.  The file takes ~40 s serial by
pytest's count (~50 s wall with the imports) on an 8-core x86 CPU, most of
it the JAX package's first G2 madd per curve.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sppark_tpu import params as jparams
from sppark_tpu.ec import get_curve_ops as jax_curve_ops
from sppark_tpu.ff import get_jax_field
from sppark_tpu.ff.ext import Fp2Field as JaxFp2Field
from sppark_tpu_torch.ec import get_curve_ops
from sppark_tpu_torch.ec import kernels as EK
from sppark_tpu_torch.ff import kernels as FK
from sppark_tpu_torch.ff.bigmont import from_jax_planes, to_jax_planes
from sppark_tpu_torch.ff.ext import get_fp2_ops
from sppark_tpu_torch.msm import MSMContext
from sppark_tpu_torch.oracle.ec import AffinePoint, XyzzPoint, get_oracle
from sppark_tpu_torch.oracle.field import Fp2
from sppark_tpu_torch.oracle.msm import msm_naive
from sppark_tpu_torch.params import get_curve

CURVES = ["test_bm64_g2", "bn254_g2", "bls12_381_g2"]
N = 12


def _jax_el(t):
    return tuple(jnp.asarray(c) for c in to_jax_planes(t, degree=2))


def _jax(pt):
    return tuple(_jax_el(c) for c in pt)


def _same_el(got, want):
    return all(np.array_equal(g, np.asarray(w, np.uint32))
               for g, w in zip(to_jax_planes(got, degree=2), want))


def _same(got, want):
    return all(_same_el(g, w) for g, w in zip(got, want))


def _rand_pairs(p, n, rng):
    edge = [(0, 0), (1, 0), (0, 1), (p - 1, p - 1)]
    return edge + [(rng.randrange(p), rng.randrange(p))
                   for _ in range(n - len(edge))]


@pytest.mark.parametrize("name", ["test_bm64_g2", "bls12_377_g2"])
def test_fp2_field_vs_jax_and_oracle(name):
    """add, sub, neg, mul, sqr and batch_inv (a zero lane included) on the
    extensions with nonresidues 7 and -5 (-1: the point ops below) against
    the oracle, and on test_bm64_g2 the ring ops against the JAX package's
    Fp2Field too (its 384-bit ops and its Fermat chain cost seconds of
    compile each)."""
    cp = get_curve(name)
    F = get_fp2_ops(cp.fp2, FK.PLAIN)
    O = Fp2(cp.fp2)
    rng = random.Random(1)
    xs, ys = _rand_pairs(F.p, 8, rng), _rand_pairs(F.p, 8, rng)[::-1]
    x, y = F.from_int_list(xs), F.from_int_list(ys)
    assert F.to_int_list(x) == xs
    assert torch.equal(from_jax_planes(to_jax_planes(x, degree=2)), x)
    cases = [("add", F.add(x, y), map(O.add, xs, ys)),
             ("sub", F.sub(x, y), map(O.sub, xs, ys)),
             ("neg", F.neg(x), map(O.neg, xs)),
             ("mul", F.mul(x, y), map(O.mul, xs, ys)),
             ("sqr", F.sqr(x), map(O.sqr, xs)),
             ("batch_inv", F.batch_inv(x), map(O.inv, xs))]
    for op, got, want in cases:
        assert F.to_int_list(got) == list(want), op
    if name == "test_bm64_g2":
        jcp = jparams.get_curve(name)
        J = JaxFp2Field(jcp.fp2, get_jax_field(jcp.field))
        jx, jy = _jax_el(x), _jax_el(y)
        for (op, got, _), jwant in zip(cases, (
                J.add(jx, jy), J.sub(jx, jy), J.neg(jx), J.mul(jx, jy),
                J.sqr(jx))):
            assert _same_el(got, jwant), op
    # a broadcast operand, the embedded constants, the lane-wise tests
    assert F.to_int_list(F.mul(x, F.const(xs[5][0], (1,)))) == \
        [O.mul(v, xs[5][0]) for v in xs]
    assert F.to_int_list(F.ones((2,))) == [(1, 0)] * 2
    assert bool(F.is_zero(x)[0]) and not bool(F.is_zero(x)[1:].any())
    assert bool(F.eq(x, x).all()) and \
        F.eq(x, y).tolist() == [u == v for u, v in zip(xs, ys)]


def _cases(curve, seed=0):
    """p: xyzz points with ZZ != 1 (2 P by the plain doubling); a: affine
    points; q: a as xyzz rescaled by a random lambda in F_p^2.  Lane 1
    doubles (a, q == p), lane 2 cancels, lane 3 has a and q at infinity,
    lane 4 an empty bucket, lane 5 both, lane 6 Y == 0 in p."""
    o = get_oracle(get_curve(curve))
    ops = get_curve_ops(curve, FK.PLAIN)
    F = ops.F
    rng = random.Random(seed)
    base = [o.random_point(rng) for _ in range(N)]
    twice = [o.jacobian_to_affine(o.jacobian_dbl(o.to_jacobian(P)))
             for P in base]
    aff = [base[(i + 5) % N] for i in range(N)]
    aff[1] = twice[1]
    aff[2] = o.affine_neg(twice[2])
    aff[3] = aff[5] = o.infinity_affine()
    p = tuple(c.clone() for c in ops.xyzz_dbl(ops.affine_to_xyzz(
        ops.affine_from_ints(base))))
    for c in p:
        c[:, 4:6] = 0
    p[1][:, 6] = 0
    a = ops.affine_from_ints(aff)
    lam = F.from_int_list([(rng.randrange(F.p), rng.randrange(1, F.p))
                           for _ in range(N)])
    l2 = F.sqr(lam)
    l3 = F.mul(l2, lam)
    q = ops._sel(ops.affine_is_inf(a), ops.xyzz_infinity((N,)),
                 (F.mul(a[0], l2), F.mul(a[1], l3), l2, l3))
    return p, a, q


@pytest.mark.parametrize("curve", CURVES)
def test_point_ops_vs_jax(curve):
    """The plain versions of the three fp2 kernels, planted lanes
    included, against the JAX package's CurveOps word for word."""
    p, a, q = _cases(curve)
    J = jax_curve_ops(curve)
    assert _same(EK.xyzz_madd(curve, p, a), J.xyzz_madd(_jax(p), _jax(a)))
    assert _same(EK.xyzz_add(curve, p, q), J.xyzz_add(_jax(p), _jax(q)))
    assert _same(EK.xyzz_dbl(curve, p), J.xyzz_dbl(_jax(p)))


def test_to_affine_vs_jax():
    """The batch normalisation (one base-field batch inversion through the
    norm) on test_bm64_g2, infinity lanes to (0, 0), against the JAX
    package and the oracle; the doubling and cancelling lanes of the madd
    took their legs."""
    curve = "test_bm64_g2"
    p, a, _ = _cases(curve)
    ops = get_curve_ops(curve, FK.PLAIN)
    o = get_oracle(get_curve(curve))
    got = ops.xyzz_to_affine(p)
    assert _same(got, jax_curve_ops(curve).xyzz_to_affine(_jax(p)))
    for (x, y), coords in zip(ops.affine_to_ints(got),
                              zip(*[ops.F.to_int_list(c) for c in p])):
        want = o.xyzz_to_affine(XyzzPoint(*coords))
        assert (x, y) == (want.x, want.y)
    m = ops.affine_to_ints(ops.xyzz_to_affine(EK.xyzz_madd(curve, p, a)))
    P1 = ops.affine_to_ints(a)[1]
    want = o.jacobian_to_affine(o.jacobian_dbl(o.to_jacobian(
        AffinePoint(*P1))))
    assert m[1] == (want.x, want.y) and m[2] == ((0, 0), (0, 0))


@pytest.mark.parametrize("curve", ["test_bm64_g2", "bls12_381_g2"])
def test_wire_ingestion_vs_jax(curve):
    """affine_from_wire from (n, 2 n32) word arrays, c0 || c1, and from the
    strided byte buffer with the inf byte, against the JAX package."""
    ops = get_curve_ops(curve)
    J = jax_curve_ops(curve)
    o = get_oracle(get_curve(curve))
    rng = random.Random(4)
    pts = [o.random_point(rng) for _ in range(4)]
    a = ops.affine_from_ints(pts)
    assert ops.affine_to_ints(a) == [(P.x, P.y) for P in pts]
    xw, yw = ops.affine_to_wire(a)
    assert xw.shape == (4, 2 * get_curve(curve).field.n_ref_limbs)
    assert all(np.array_equal(u, v) for u, v in
               zip((xw, yw), J.affine_to_wire(J.affine_from_ints(pts))))
    assert all(torch.equal(u, v) for u, v in
               zip(ops.affine_from_wire(xw, yw), a))
    cb = ops.coord_bytes()
    assert cb == 4 * xw.shape[1]
    stride = 2 * cb + 8
    buf = np.zeros((4, stride), dtype=np.uint8)
    buf[:, :cb] = xw.view(np.uint8).reshape(4, cb)
    buf[:, cb:2 * cb] = yw.view(np.uint8).reshape(4, cb)
    buf[2, 2 * cb] = 1                      # point 2 flagged at infinity
    got = ops.affine_from_wire(buf=buf.reshape(-1), ffi_affine_sz=stride)
    want = J.affine_from_wire(buf=buf.reshape(-1), ffi_affine_sz=stride)
    assert _same(got, want)
    assert ops.affine_is_inf(got).tolist() == [False, False, True, False]


def test_msm_g2_vs_naive():
    """test_bm64_g2 through MSMContext on the CPU: 64 points from 8
    distinct ones, infinity at 3, scalars 0 and r - 1 planted; resident
    points (a gather table of 4 n32 words per row), 40 equal scalars (one
    bucket spills into replica rows), and scalars below 2^31 (the top of
    the nine 4-bit windows stays empty, so collect must skip its (0, 0)
    sum)."""
    curve = "test_bm64_g2"
    cp = get_curve(curve)
    o = get_oracle(cp)
    rng = random.Random(2)
    base = [o.random_point(rng) for _ in range(8)]
    pts = [base[i % 8] for i in range(64)]
    pts[3] = o.infinity_affine()
    r = cp.scalar.modulus
    sc = [rng.randrange(r) for _ in range(64)]
    sc[0], sc[1] = 0, r - 1
    sc[10:50] = [sc[7]] * 40
    ctx = MSMContext(curve, 64, wbits=4, device="cpu")
    assert ctx.nwins == 9
    ctx.set_points(pts)
    assert ctx._points is None and ctx.rows.shape == (129, 8)
    assert ctx.invoke(sc) == msm_naive(cp, pts, sc)
    small = [s % (1 << 31) for s in sc]
    assert ctx.invoke(small) == msm_naive(cp, pts, small)


def test_point_ops_bls12_377_g2_vs_oracle():
    """The nonresidue -5: the plain point ops, planted lanes included,
    against the oracle's xyzz formulas on exact ints (its MSM runs on the
    card, in chip_smoke.py)."""
    curve = "bls12_377_g2"
    o = get_oracle(get_curve(curve))
    ops = get_curve_ops(curve, FK.PLAIN)
    p, a, q = _cases(curve)
    P = [XyzzPoint(*c) for c in zip(*[ops.F.to_int_list(c) for c in p])]
    Q = [XyzzPoint(*c) for c in zip(*[ops.F.to_int_list(c) for c in q])]
    A = [o.infinity_affine() if v == ((0, 0), (0, 0)) else AffinePoint(*v)
         for v in ops.affine_to_ints(a)]
    for got, want in ((EK.xyzz_madd(curve, p, a), map(o.xyzz_madd, P, A)),
                      (EK.xyzz_add(curve, p, q), map(o.xyzz_add, P, Q)),
                      (EK.xyzz_dbl(curve, p), map(o.xyzz_dbl, P))):
        rows = list(zip(*[ops.F.to_int_list(c) for c in got]))
        assert rows == [(w.x, w.y, w.zz, w.zzz) for w in want]
