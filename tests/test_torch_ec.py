"""The port's G1 point ops (sppark_tpu_torch.ec: the plain versions of the
ec_xyzz_madd / add / dbl kernels) against the JAX package's
sppark_tpu.ec.CurveOps on the CPU, word for word, with the special lanes
planted: an empty bucket, a point at infinity, doubling, cancellation, and
both operands at infinity.  xyzz_to_affine runs on test_bm64 only (the
JAX package takes ~20 s for it on BLS12-381 on this CPU)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sppark_tpu.ec import get_curve_ops as jax_curve_ops
from sppark_tpu_torch.ec import get_curve_ops, kernels as EK
from sppark_tpu_torch.ff import kernels as FK
from sppark_tpu_torch.ff.bigmont import to_jax_planes
from sppark_tpu_torch.oracle.ec import AffinePoint, XyzzPoint, get_oracle
from sppark_tpu_torch.params import get_curve

CURVES = ["test_bm64", "pallas", "bls12_381"]
N = 12


def _jax(pt):
    return tuple(jnp.asarray(to_jax_planes(c)) for c in pt)


def _same(got, want):
    return all(np.array_equal(to_jax_planes(g), np.asarray(w, np.uint32))
               for g, w in zip(got, want))


def _cases(curve, seed=0):
    """p: xyzz points with ZZ != 1 (2 P by the plain doubling); a: affine
    points; q: a as xyzz rescaled by a random lambda.  Lane 1 doubles
    (a, q == p), lane 2 cancels, lane 3 has a and q at infinity, lane 4
    an empty bucket, lane 5 both, lane 6 Y == 0 in p."""
    cp = get_curve(curve)
    o = get_oracle(cp)
    ops = get_curve_ops(curve, FK.PLAIN)
    F = ops.F
    rng = random.Random(seed)
    base = [o.random_point(rng) for _ in range(N)]
    twice = [o.jacobian_to_affine(o.jacobian_dbl(o.to_jacobian(P)))
             for P in base]
    aff = [o.random_point(rng) for _ in range(N)]
    aff[1] = twice[1]
    aff[2] = o.affine_neg(twice[2])
    aff[3] = aff[5] = AffinePoint(0, 0, True)
    p = tuple(c.clone() for c in ops.xyzz_dbl(ops.affine_to_xyzz(
        ops.affine_from_ints(base))))
    for c in p:
        c[:, 4:6] = 0
    p[1][:, 6] = 0
    a = ops.affine_from_ints(aff)
    lam = F.from_int_list([rng.randrange(1, F.p) for _ in range(N)])
    l2 = F.sqr(lam)
    l3 = F.mul(l2, lam)
    q = ops._sel(ops.affine_is_inf(a), ops.xyzz_infinity((N,)),
                 (F.mul(a[0], l2), F.mul(a[1], l3), l2, l3))
    return p, a, q


@pytest.mark.parametrize("curve", CURVES)
def test_madd_vs_jax(curve):
    p, a, _ = _cases(curve)
    got = EK.xyzz_madd(curve, p, a)
    assert _same(got, jax_curve_ops(curve).xyzz_madd(_jax(p), _jax(a)))
    # the doubling and cancelling lanes took their legs
    ops = get_curve_ops(curve, FK.PLAIN)
    o = get_oracle(get_curve(curve))
    x, y = ops.affine_to_ints(ops.xyzz_to_affine(got))[1]
    P1 = ops.affine_to_ints(a)[1]
    want = o.jacobian_to_affine(o.jacobian_dbl(o.to_jacobian(
        AffinePoint(*P1))))
    assert (x, y) == (want.x, want.y)
    assert bool(ops.xyzz_is_inf(got)[2]) and bool(ops.xyzz_is_inf(got)[5])


@pytest.mark.parametrize("curve", CURVES)
def test_add_vs_jax(curve):
    p, _, q = _cases(curve)
    got = EK.xyzz_add(curve, p, q)
    assert _same(got, jax_curve_ops(curve).xyzz_add(_jax(p), _jax(q)))


@pytest.mark.parametrize("curve", CURVES)
def test_dbl_vs_jax(curve):
    p, _, _ = _cases(curve)
    got = EK.xyzz_dbl(curve, p)
    assert _same(got, jax_curve_ops(curve).xyzz_dbl(_jax(p)))


def test_to_affine_vs_jax():
    """The batch normalisation (one batch inversion over zz and zzz) on
    test_bm64, infinity lanes to (0, 0), against the JAX package and the
    oracle."""
    p, a, _ = _cases("test_bm64")
    ops = get_curve_ops("test_bm64", FK.PLAIN)
    got = ops.xyzz_to_affine(p)
    assert _same(got, jax_curve_ops("test_bm64").xyzz_to_affine(_jax(p)))
    o = get_oracle(get_curve("test_bm64"))
    for (x, y), coords in zip(ops.affine_to_ints(got),
                              zip(*[ops.F.to_int_list(c) for c in p])):
        want = o.xyzz_to_affine(XyzzPoint(*coords))
        assert (x, y) == (want.x, want.y)


@pytest.mark.parametrize("curve", CURVES)
def test_wire_ingestion_vs_jax(curve):
    """affine_from_wire from word arrays and from the strided byte buffer
    with the inf byte (Affine_inf_t), against the JAX package."""
    ops = get_curve_ops(curve)
    J = jax_curve_ops(curve)
    o = get_oracle(get_curve(curve))
    rng = random.Random(4)
    pts = [o.random_point(rng) for _ in range(6)]
    a = ops.affine_from_ints(pts)
    assert ops.affine_to_ints(a) == [(P.x, P.y) for P in pts]
    xw, yw = ops.affine_to_wire(a)
    assert all(np.array_equal(u, v) for u, v in
               zip((xw, yw), J.affine_to_wire(J.affine_from_ints(pts))))
    assert all(torch.equal(u, v) for u, v in
               zip(ops.affine_from_wire(xw, yw), a))
    cb = ops.coord_bytes()
    stride = 2 * cb + 8
    buf = np.zeros((6, stride), dtype=np.uint8)
    buf[:, :cb] = xw.view(np.uint8).reshape(6, cb)
    buf[:, cb:2 * cb] = yw.view(np.uint8).reshape(6, cb)
    buf[2, 2 * cb] = 1                      # point 2 flagged at infinity
    got = ops.affine_from_wire(buf=buf.reshape(-1), ffi_affine_sz=stride)
    want = J.affine_from_wire(buf=buf.reshape(-1), ffi_affine_sz=stride)
    assert _same(got, want)
    assert bool(ops.affine_is_inf(got)[2]) and \
        int(ops.affine_is_inf(got).sum()) == 1
    with pytest.raises(ValueError):
        ops.affine_from_wire(buf=buf.reshape(-1)[:-1], ffi_affine_sz=stride)


def test_point_kernels_cpu_contract():
    """A CPU tensor takes the plain version; a CUDA kernel is never asked
    for on the CPU, and int64 words are refused before any launch."""
    p, a, q = _cases("test_bm64")
    assert all(torch.equal(u, v) for u, v in zip(
        EK.xyzz_madd("test_bm64", p, a),
        get_curve_ops("test_bm64", FK.PLAIN).xyzz_madd(p, a)))
    assert EK.KERNELS.field is FK.KERNELS and EK.PLAIN.field is FK.PLAIN
    with pytest.raises(TypeError):
        FK.check_words("ec_xyzz_dbl", get_curve("test_bm64").field,
                       *(c.to(torch.int64) for c in p))


def test_bls12_377_g1_curve():
    """get_curve("bls12_377") carries the JAX package's BLS12_377_G1
    constants; a sampled oracle point (the same as the JAX package's
    oracle draws from the same seed) lies on the curve and in the
    r-subgroup, and crosses into the port's words and back."""
    from sppark_tpu import params as jparams
    from sppark_tpu.oracle.ec import get_oracle as jax_oracle

    cp, jp = get_curve("bls12_377"), jparams.get_curve("bls12_377")
    assert (cp.field.modulus, cp.scalar.modulus, cp.b, cp.a4, cp.cofactor,
            cp.degree) == (jp.field.modulus, jp.scalar.modulus, jp.b, jp.a4,
                           jp.cofactor, 1)
    assert cp.field.n_ref_limbs == 12
    o = get_oracle(cp)
    pt = o.random_point(random.Random(7))
    jpt = jax_oracle(jp).random_point(random.Random(7))
    assert (pt.x, pt.y) == (jpt.x, jpt.y) and not pt.inf
    p = cp.field.modulus
    assert (pt.y * pt.y - pt.x ** 3 - cp.b) % p == 0
    assert o._is_zero(o._int_mul(pt, cp.scalar.modulus).z)
    ops = get_curve_ops("bls12_377", FK.PLAIN)
    assert ops.affine_to_ints(ops.affine_from_ints([pt])) == [(pt.x, pt.y)]
