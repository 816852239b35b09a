"""The port's polynomial ops (sppark_tpu_torch.polynomial) against the JAX
package's (sppark_tpu.polynomial), word for word, on the same inputs:
Goldilocks and BabyBear at n = 33, 64 and 1000, the rotate layout, batch
axes and evaluate over several passes; BLS12-381 Fr against the JAX
package at n = 33 (below its 1,024-lane interpret threshold, so it runs
its generic limb path) and against exact ints beyond."""

import random

import numpy as np
import pytest
import torch

from sppark_tpu_torch import polynomial as tpoly
from sppark_tpu_torch.ff import bigmont, gl64
from sppark_tpu_torch.ff.mont32 import get_mont32_ops
from sppark_tpu_torch.params import get_field


def port_words(field, ints, batch_shape):
    """Canonical ints -> the port's words of `field`, (lead, *batch)."""
    params = get_field(field)
    if params.modulus == gl64.P:
        return gl64.from_ints(ints).reshape(batch_shape)
    if params.bits <= 32:
        return get_mont32_ops(field).from_int_list(ints, batch_shape)
    return bigmont.get_field_ops(field).from_int_list(ints, batch_shape)


def port_ints(field, t):
    params = get_field(field)
    if params.modulus == gl64.P:
        return gl64.to_ints(t)
    if params.bits <= 32:
        return get_mont32_ops(field).to_int_list(t)
    return bigmont.get_field_ops(field).to_int_list(t)


def from_jax(field, arr):
    """A JAX package array of `field` -> the port's words."""
    params = get_field(field)
    a = np.array(arr)                   # a writable copy
    if params.modulus == gl64.P:
        return gl64.from_jax_planes(a)
    if params.bits <= 32:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    return bigmont.from_jax_planes(a)


def jax_words(field, ints, batch_shape):
    from sppark_tpu.ff import get_jax_field
    return get_jax_field(field).from_int_list(ints, batch_shape=batch_shape)


def rand_ints(field, n, seed):
    p = get_field(field).modulus
    r = random.Random(seed)
    return [r.randrange(p) for _ in range(n)]


def horner(coeffs, x, p):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


NARROW = ["baby_bear", "goldilocks"]


def exact_prefix(vals, p):
    s, m, sums, prods = 0, 1, [], []
    for v in vals:
        s, m = (s + v) % p, m * v % p
        sums.append(s)
        prods.append(m)
    return sums, prods


@pytest.mark.parametrize("field,n", [("baby_bear", 33), ("goldilocks", 1000),
                                     ("bls12_381_fr", 33)])
def test_prefix_scans_match_jax(field, n):
    """Both scans word for word against the JAX package; for BLS12-381 Fr
    the product (the sum against exact ints: its 16-limb JAX graphs cost
    seconds of compile each)."""
    from sppark_tpu.polynomial import prefix_product, prefix_sum
    vals = rand_ints(field, n, n)
    x = port_words(field, vals, (n,))
    xj = jax_words(field, vals, (n,))
    assert torch.equal(from_jax(field, xj), x)
    got_s, got_p = tpoly.prefix_sum(field, x), tpoly.prefix_product(field, x)
    assert torch.equal(got_p, from_jax(field, prefix_product(field, xj)))
    if field == "bls12_381_fr":
        p = get_field(field).modulus
        assert port_ints(field, got_s) == exact_prefix(vals, p)[0]
    else:
        assert torch.equal(got_s, from_jax(field, prefix_sum(field, xj)))


@pytest.mark.parametrize("field,n", [("baby_bear", 1000), ("goldilocks", 33),
                                     ("bls12_381_fr", 1000)])
def test_prefix_scans_exact(field, n):
    """The other sizes against exact ints."""
    p = get_field(field).modulus
    vals = rand_ints(field, n, 7)
    x = port_words(field, vals, (n,))
    assert (port_ints(field, tpoly.prefix_sum(field, x)),
            port_ints(field, tpoly.prefix_product(field, x))) \
        == exact_prefix(vals, p)


@pytest.mark.parametrize("field,n,rotate", [("baby_bear", 64, True),
                                            ("goldilocks", 1000, False)])
def test_div_by_x_minus_z_matches_jax(field, n, rotate):
    """Word for word against the JAX package (the rotate layout where
    `rotate`; each JAX layout is a compile of its own), and the division
    itself against ints: q (x - z) + r == p, r == p(z)."""
    from sppark_tpu.polynomial import div_by_x_minus_z
    p = get_field(field).modulus
    coeffs = rand_ints(field, n, 100 + n)
    z = rand_ints(field, 1, n)
    c, cj = port_words(field, coeffs, (n,)), jax_words(field, coeffs, (n,))
    zt, zj = port_words(field, z, (1,)), jax_words(field, z, (1,))
    q, r = tpoly.div_by_x_minus_z(field, c, zt)
    qj, rj = div_by_x_minus_z(field, cj, zj)
    assert torch.equal(q, from_jax(field, qj))
    assert torch.equal(r, from_jax(field, rj))
    rot = tpoly.div_by_x_minus_z(field, c, zt, rotate=True)
    if rotate:
        assert torch.equal(rot, from_jax(field, div_by_x_minus_z(
            field, cj, zj, rotate=True)))
    qi, ri = port_ints(field, q), port_ints(field, r)[0]
    assert ri == horner(coeffs, z[0], p) and qi[-1] == 0
    prod = [0] * n
    for k in range(n - 1):
        prod[k + 1] = (prod[k + 1] + qi[k]) % p
        prod[k] = (prod[k] - z[0] * qi[k]) % p
    prod[0] = (prod[0] + ri) % p
    assert prod == coeffs
    assert port_ints(field, rot) == [ri] + qi[:-1]


def test_div_evaluate_wide_exact():
    """A (2, n) batch of BLS12-381 Fr polynomials, one z each, at n =
    200: the quotient and remainder against synthetic division on ints,
    the rotate layout, and evaluate at three points against Horner."""
    field, n = "bls12_381_fr", 200
    p = get_field(field).modulus
    coeffs = rand_ints(field, 2 * n, 11)
    z = rand_ints(field, 2, 12)
    q, r = tpoly.div_by_x_minus_z(field, port_words(field, coeffs, (2, n)),
                                  port_words(field, z, (2, 1)))
    qi, ri = port_ints(field, q), port_ints(field, r)
    for b in range(2):
        cs = coeffs[b * n:(b + 1) * n]
        acc, want = 0, [0] * n
        for k in reversed(range(n)):
            acc = (cs[k] + z[b] * acc) % p
            if k:
                want[k - 1] = acc
        assert qi[b * n:(b + 1) * n] == want
        assert ri[b] == acc == horner(cs, z[b], p)
    rot = tpoly.div_by_x_minus_z(field, port_words(field, coeffs, (2, n)),
                                 port_words(field, z, (2, 1)), rotate=True)
    assert torch.equal(rot[..., 0:1], r) and torch.equal(rot[..., 1:],
                                                         q[..., :-1])
    xs = rand_ints(field, 3, 13)
    ev = port_ints(field, tpoly.evaluate(
        field, port_words(field, coeffs, (2, 1, n)),
        port_words(field, xs, (3,))))
    assert ev == [horner(coeffs[b * n:(b + 1) * n], x, p)
                  for b in range(2) for x in xs]


@pytest.mark.parametrize("field", ["baby_bear"])
def test_evaluate_matches_jax(field):
    from sppark_tpu.polynomial import evaluate
    p = get_field(field).modulus
    n, npts = 33, 5
    coeffs, xs = rand_ints(field, n, 3), rand_ints(field, npts, 4)
    got = tpoly.evaluate(field, port_words(field, coeffs, (n,)),
                         port_words(field, xs, (npts,)))
    want = evaluate(field, jax_words(field, coeffs, (n,)),
                    jax_words(field, xs, (npts,)))
    assert torch.equal(got, from_jax(field, want))
    assert port_ints(field, got) == [horner(coeffs, x, p) for x in xs]


@pytest.mark.parametrize("field", NARROW)
def test_evaluate_batched_passes_match_jax(field, monkeypatch):
    """More points than a pass holds: a pass budget of 64 elements gives
    B = 4 points a pass at n = 16, three passes for 11 points (the JAX
    package's edge-padded tail), on both sides."""
    from sppark_tpu.polynomial import core as pcore
    p = get_field(field).modulus
    n, npts = 16, 11
    coeffs, xs = rand_ints(field, n, 5), rand_ints(field, npts, 6)
    got = tpoly.evaluate(field, port_words(field, coeffs, (n,)),
                         port_words(field, xs, (npts,)), pass_elems=64)
    monkeypatch.setattr(pcore, "_EVAL_PASS_ELEMS", 64)
    want = pcore._evaluate_batched(field, jax_words(field, coeffs, (n,)),
                                   jax_words(field, xs, (npts,)))
    assert torch.equal(got, from_jax(field, want))
    assert port_ints(field, got) == [horner(coeffs, x, p) for x in xs]


def test_batch_axes_goldilocks():
    """A (3, 64) batch: each row's scans, division (one z a row) and
    evaluation equal the rows' own."""
    field, n = "goldilocks", 64
    c = port_words(field, rand_ints(field, 3 * n, 8), (3, n))
    z = port_words(field, rand_ints(field, 3, 9), (3, 1))
    xs = port_words(field, rand_ints(field, 4, 10), (4,))
    q, r = tpoly.div_by_x_minus_z(field, c, z)
    ev = tpoly.evaluate(field, c, xs)
    for b in range(3):
        assert torch.equal(tpoly.prefix_product(field, c)[b],
                           tpoly.prefix_product(field, c[b]))
        qb, rb = tpoly.div_by_x_minus_z(field, c[b], z[b])
        assert torch.equal(q[b], qb) and torch.equal(r[b], rb)
        assert torch.equal(ev[b], tpoly.evaluate(field, c[b], xs))


def test_prefix_bad_op():
    with pytest.raises(ValueError):
        tpoly.prefix_op("baby_bear", torch.zeros(4, dtype=torch.int32), "xor")


def test_mersenne31_exact():
    """Mersenne-31 (canonical words, no NTT): the scans, the division and
    evaluate against exact ints."""
    field, n = "mersenne31", 50
    p = get_field(field).modulus
    vals, xs = rand_ints(field, n, 14), rand_ints(field, 3, 15)
    x = port_words(field, vals, (n,))
    assert (port_ints(field, tpoly.prefix_sum(field, x)),
            port_ints(field, tpoly.prefix_product(field, x))) \
        == exact_prefix(vals, p)
    rot = tpoly.div_by_x_minus_z(field, x, port_words(field, xs[:1], (1,)),
                                 rotate=True)
    assert port_ints(field, rot)[0] == horner(vals, xs[0], p)
    assert port_ints(field, tpoly.evaluate(field, x, port_words(
        field, xs, (3,)))) == [horner(vals, v, p) for v in xs]
