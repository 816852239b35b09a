"""The port's oracle (sppark_tpu_torch/oracle) on its own and against the
JAX package's (sppark_tpu/oracle), on the CPU.

The nine checks of tests/test_oracle.py run on the port's oracle: the NTT
round trip, the direct DFT, the orders, the coset round trip, the LDE, the
G1 group law (through on_curve, affine_eq and to_xyzz), the scalar
multiple, Pippenger against naive, and G2.  Then, from equal random.Random
states, Fr.pow, Fr.rand, Fp2.rand, the wire helpers, to_xyzz and
random_point give the JAX package's ints exactly (tolerance zero: both are
exact big-int arithmetic).  Both oracles are pure Python: nothing here
compiles.
"""

import random

import pytest

from sppark_tpu import params as jparams
from sppark_tpu.oracle import ec as jec
from sppark_tpu.oracle import field as jfield
from sppark_tpu_torch import params
from sppark_tpu_torch.oracle import (bit_reverse, coset_intt, coset_ntt,
                                     intt_natural, lde, msm_naive,
                                     msm_pippenger, ntt_natural)
from sppark_tpu_torch.oracle.ec import get_oracle
from sppark_tpu_torch.oracle.field import Fp2, Fr
from sppark_tpu_torch.oracle.ntt import apply_order

NTT_FIELDS = [params.BABY_BEAR, params.GOLDILOCKS, params.BN254_FR,
              params.BLS12_381_FR, params.PALLAS_P]
CURVES = [params.PALLAS_G1, params.BN254_G1, params.BLS12_381_G1]


def _horner(coeffs, x, p):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


# -- tests/test_oracle.py's checks on the port's oracle ----------------------------

@pytest.mark.parametrize("field", NTT_FIELDS, ids=lambda f: f.name)
def test_ntt_roundtrip(field, rng):
    for lg in (1, 2, 5, 8):
        v = [rng.randrange(field.modulus) for _ in range(1 << lg)]
        assert intt_natural(field, ntt_natural(field, v)) == v
        assert ntt_natural(field, intt_natural(field, v)) == v


def test_ntt_matches_direct_dft(rng):
    field = params.BABY_BEAR
    p = field.modulus
    for lg in (1, 3, 4):
        n = 1 << lg
        w = field.root_of_unity(lg)
        v = [rng.randrange(p) for _ in range(n)]
        direct = [sum(v[j] * pow(w, j * k, p) for j in range(n)) % p
                  for k in range(n)]
        assert ntt_natural(field, v) == direct


def test_ntt_orders(rng):
    field = params.GOLDILOCKS
    lg = 4
    v = [rng.randrange(field.modulus) for _ in range(1 << lg)]
    nn = apply_order(field, v, lg, "NN")
    assert apply_order(field, bit_reverse(v, lg), lg, "RR") == \
        bit_reverse(nn, lg)
    assert apply_order(field, v, lg, "NR") == bit_reverse(nn, lg)
    assert apply_order(field, bit_reverse(v, lg), lg, "RN") == nn


def test_coset_ntt_roundtrip(rng):
    field = params.BABY_BEAR
    p = field.modulus
    v = [rng.randrange(p) for _ in range(32)]
    assert coset_intt(field, coset_ntt(field, v)) == v
    coeffs = [rng.randrange(p) for _ in range(32)]
    w = field.root_of_unity(5)
    evals = coset_ntt(field, coeffs)
    for k in (0, 1, 7, 31):
        assert evals[k] == _horner(coeffs, field.generator * pow(w, k, p) % p,
                                   p)


def test_lde_consistency(rng):
    field = params.GOLDILOCKS
    n, lg_blowup = 16, 2
    p = field.modulus
    coeffs = [rng.randrange(p) for _ in range(n)]
    ext = lde(field, ntt_natural(field, coeffs), lg_blowup)
    w_big = field.root_of_unity(4 + lg_blowup)
    for k in (0, 5, 63):
        assert ext[k] == _horner(coeffs,
                                 field.generator * pow(w_big, k, p) % p, p)


@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_ec_group_law(curve, rng):
    o = get_oracle(curve)
    a = o.random_point(rng)
    b = o.random_point(rng)
    assert o.on_curve(a) and o.on_curve(b)
    ja, jb = o.to_jacobian(a), o.to_jacobian(b)
    ab = o.jacobian_to_affine(o.jacobian_add(ja, jb))
    ba = o.jacobian_to_affine(o.jacobian_add(jb, ja))
    assert o.affine_eq(ab, ba) and o.on_curve(ab)
    dbl_j = o.jacobian_to_affine(o.jacobian_dbl(ja))
    dbl_x = o.xyzz_to_affine(o.xyzz_dbl(o.to_xyzz(a)))
    add_x = o.xyzz_to_affine(o.xyzz_add(o.to_xyzz(a), o.to_xyzz(a)))
    assert o.affine_eq(dbl_j, dbl_x) and o.affine_eq(dbl_j, add_x)
    # a + b - b == a
    x = o.xyzz_madd(o.xyzz_madd(o.to_xyzz(a), b), b, subtract=True)
    assert o.affine_eq(o.xyzz_to_affine(x), a)
    inf = o.infinity_affine()
    assert o.on_curve(inf) and not o.affine_eq(inf, a)
    assert o.affine_eq(o.xyzz_to_affine(o.xyzz_madd(o.to_xyzz(a), inf)), a)
    assert o.xyzz_to_affine(o.xyzz_madd(o.to_xyzz(a), o.affine_neg(a))).inf
    # off the curve: y + 1
    assert not o.on_curve(type(a)(a.x, (a.y + 1) % curve.field.modulus))


@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_ec_scalar_mul(curve, rng):
    o = get_oracle(curve)
    a = o.random_point(rng)
    r = curve.scalar.modulus
    k1, k2 = rng.randrange(r), rng.randrange(1 << 40)
    lhs = o.scalar_mul(a, (k1 + k2) % r)
    rhs = o.jacobian_add(o.scalar_mul(a, k1), o.scalar_mul(a, k2))
    assert o.affine_eq(o.jacobian_to_affine(lhs), o.jacobian_to_affine(rhs))


@pytest.mark.parametrize("curve", [params.PALLAS_G1, params.BLS12_381_G1],
                         ids=lambda c: c.name)
def test_msm_pippenger_vs_naive(curve, rng):
    o = get_oracle(curve)
    n = 64
    base = [o.random_point(rng) for _ in range(8)]
    points = [base[i % len(base)] for i in range(n)]
    points[3] = o.infinity_affine()
    order = curve.scalar.modulus
    scalars = [rng.randrange(order) for _ in range(n)]
    scalars[5] = 0
    scalars[6] = order - 1
    want = msm_naive(curve, points, scalars)
    assert o.affine_eq(msm_pippenger(curve, points, scalars), want)
    assert o.affine_eq(msm_pippenger(curve, points, scalars, wbits=10), want)


def test_g2_oracle(rng):
    curve = params.BLS12_381_G2
    o = get_oracle(curve)
    a = o.random_point(rng)
    assert o.on_curve(a)
    dbl_j = o.jacobian_to_affine(o.jacobian_dbl(o.to_jacobian(a)))
    add_x = o.xyzz_to_affine(o.xyzz_add(o.to_xyzz(a), o.to_xyzz(a)))
    assert o.affine_eq(dbl_j, add_x)
    want = msm_naive(curve, [a, a], [3, 5])
    assert o.affine_eq(o.jacobian_to_affine(o.scalar_mul(a, 8)), want)


# -- word for word against the JAX package's oracle ----------------------------------

@pytest.mark.parametrize("name", ["baby_bear", "mersenne31", "goldilocks",
                                  "bn254_fr", "bls12_381_fp"])
def test_field_ops_vs_jax(name):
    """Fr.pow, Fr.rand and the wire helpers from equal random.Random
    states."""
    got, want = Fr(params.get_field(name)), jfield.Fr(jparams.get_field(name))
    g, w = random.Random(7), random.Random(7)
    xs = [got.rand(g) for _ in range(16)]
    assert xs == [want.rand(w) for _ in range(16)]
    assert g.getstate() == w.getstate()
    for x in xs + [0, 1, got.p - 1]:
        for e in (0, 1, 2, 5, got.p - 2, (got.p + 1) // 4):
            assert got.pow(x, e) == want.pow(x, e)
        assert got.to_wire(x) == want.to_wire(x)
        assert got.from_wire(got.to_wire(x)) == want.from_wire(
            want.to_wire(x)) == x
        assert got.to_mont(x) == want.to_mont(x)
        assert got.from_mont(x) == want.from_mont(x)


@pytest.mark.parametrize("name", ["bn254", "bls12_381", "test_bm64"])
def test_fp2_rand_vs_jax(name):
    got = Fp2(params.get_curve(f"{name}_g2").fp2)
    want = jfield.Fp2(jparams.get_curve(f"{name}_g2").fp2)
    g, w = random.Random(11), random.Random(11)
    assert [got.rand(g) for _ in range(8)] == [want.rand(w) for _ in range(8)]
    assert g.getstate() == w.getstate()


@pytest.mark.parametrize("name", ["test_gl64", "pallas", "bn254",
                                  "bls12_381", "bls12_381_g2"])
def test_points_vs_jax(name):
    """random_point, on_curve, to_xyzz and affine_eq from equal seeds."""
    o = get_oracle(params.get_curve(name))
    jo = jec.get_oracle(jparams.get_curve(name))
    g, w = random.Random(3), random.Random(3)
    pts = [o.random_point(g) for _ in range(3)]
    jpts = [jo.random_point(w) for _ in range(3)]
    assert [(p.x, p.y, p.inf) for p in pts] == \
        [(p.x, p.y, p.inf) for p in jpts]
    pts.append(o.infinity_affine())
    jpts.append(jo.infinity_affine())
    for p, q in zip(pts, jpts):
        assert o.on_curve(p) and jo.on_curve(q)
        x, jx = o.to_xyzz(p), jo.to_xyzz(q)
        assert (x.x, x.y, x.zz, x.zzz) == (jx.x, jx.y, jx.zz, jx.zzz)
        for r, s in zip(pts, jpts):
            assert o.affine_eq(p, r) == jo.affine_eq(q, s)
