"""The lane layouts of the card tests for the lane-pair fp2 kernels
(tests/test_torch_cuda.py: 16 lanes a warp, exactly one special lane in a
warp of generic ones, and 1, 17 and 65 lanes), here on test_bm64_g2 on the
CPU: the port's plain xyzz_add and its affine pair add (prep ->
batch_inv_flat -> finish) against the JAX package's generic path, word for
word.  The plain versions are the card tests' yardstick; this holds them to
the reference on exactly those layouts.  Every layout is one slice of a
single batch, so each side runs once.  No test interprets a Pallas kernel.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np

from sppark_tpu.ec import get_curve_ops as jax_curve_ops
from sppark_tpu.msm.tree import affine_pair_add as jax_pair_add
from sppark_tpu_torch.ec import get_curve_ops
from sppark_tpu_torch.ec import kernels as EK
from sppark_tpu_torch.ff.bigmont import to_jax_planes
from sppark_tpu_torch.msm import tree
from sppark_tpu_torch.oracle.ec import get_oracle
from sppark_tpu_torch.params import get_curve

CURVE = "test_bm64_g2"


def _lane_pair_warps(specials):
    """For each special lane, a warp of the generic lanes 0..15 with that
    one lane in slot 5; then 1, 17 and 65 lanes (tests/test_torch_cuda.py
    makes the same selections)."""
    out = []
    for s in specials:
        lanes = list(range(16))
        lanes[5] = s
        out.append(lanes)
    return out + [list(range(n)) for n in (1, 17, 65)]


def _pool(seed, n):
    """(numpy generator, Python generator seeded from it, oracle, n
    points of the subgroup drawn by the oracle)."""
    rng = np.random.default_rng(seed)
    o = get_oracle(get_curve(CURVE))
    r = random.Random(int(rng.integers(1 << 32)))
    return rng, r, o, [o.random_point(r) for _ in range(n)]


def _jax(t):
    return tuple(jnp.asarray(c) for c in to_jax_planes(t, degree=2))


def _same(got, want):
    return all(np.array_equal(g, np.asarray(w, np.uint32))
               for g, w in zip(to_jax_planes(got, degree=2), want))


def _slices(layouts):
    """The (start, stop) of each layout in their concatenation."""
    ends = np.cumsum([len(lanes) for lanes in layouts])
    return list(zip(np.concatenate([[0], ends[:-1]]), ends))


def test_add_layouts_vs_jax():
    """xyzz_add on warps with exactly one doubling lane (p == q), one with
    q at infinity, one with p at infinity, one cancelling lane (p == -q),
    and 1, 17 and 65 lanes."""
    rng, r, o, pool = _pool(21, 8)
    ops = get_curve_ops(CURVE, EK.PLAIN.field)
    F = ops.F
    n = 96
    j = rng.integers(0, 8, size=n)
    k = (j + rng.integers(1, 8, size=n)) % 8
    twice = [o.jacobian_to_affine(o.jacobian_dbl(o.to_jacobian(P)))
             for P in pool]
    aff = [pool[v] for v in k]
    aff[33] = twice[j[33]]
    aff[34] = o.affine_neg(twice[j[34]])
    aff[35] = o.infinity_affine()
    # p = 2 P_j by the plain doubling (ZZ != 1); lane 36 an empty bucket
    p = tuple(c.clone() for c in ops.xyzz_dbl(ops.affine_to_xyzz(
        ops.affine_from_ints([pool[v] for v in j]))))
    for c in p:
        c[:, 36] = 0
    a = ops.affine_from_ints(aff)
    lam = F.from_int_list([(r.randrange(F.p), r.randrange(1, F.p))
                           for _ in range(n)])
    l2 = F.sqr(lam)
    q = ops._sel(ops.affine_is_inf(a), ops.xyzz_infinity((n,)),
                 (F.mul(a[0], l2), F.mul(a[1], F.mul(l2, lam)), l2,
                  F.mul(l2, lam)))
    layouts = _lane_pair_warps((33, 35, 36, 34))
    idx = [v for lanes in layouts for v in lanes]
    pw, qw = (tuple(c[:, idx] for c in t) for t in (p, q))
    got = EK.xyzz_add(CURVE, pw, qw)
    want = jax_curve_ops(CURVE).xyzz_add(tuple(_jax(c) for c in pw),
                                         tuple(_jax(c) for c in qw))
    for lo, hi in _slices(layouts):
        assert all(_same(g[:, lo:hi], tuple(x[..., lo:hi] for x in w))
                   for g, w in zip(got, want)), (lo, hi)
    # the planted lanes took their legs: 2 P, infinity, p, q
    ints = ops.affine_to_ints(ops.xyzz_to_affine(got))
    dbl4 = o.jacobian_to_affine(o.jacobian_dbl(o.to_jacobian(twice[j[33]])))
    assert ints[5] == (dbl4.x, dbl4.y)                  # layout 0, lane 33
    assert ints[16 * 3 + 5] == ((0, 0), (0, 0))         # layout 3, lane 34


def test_pair_add_layouts_vs_jax():
    """prep -> batch_inv_flat -> finish on warps of chords with exactly
    one tangent lane, one lane that copies r (USE_R) or one that copies l
    (USE_L), and 1, 17 and 65 lanes."""
    rng, _, o, pool = _pool(22, 8)
    ops = get_curve_ops(CURVE, EK.PLAIN.field)
    n = 96
    j = rng.integers(0, 8, size=n)
    k = (j + rng.integers(1, 8, size=n)) % 8
    L = [pool[v] for v in j]
    R = [pool[v] for v in k]
    R[33] = L[33]
    L[35] = o.infinity_affine()
    R[36] = o.infinity_affine()
    layouts = _lane_pair_warps((33, 35, 36))
    idx = [v for lanes in layouts for v in lanes]
    l = ops.affine_from_ints([L[v] for v in idx])
    r = ops.affine_from_ints([R[v] for v in idx])
    _, flags = EK.affine_pair_prep_plain(CURVE, l, r)
    assert [int(flags[16 * w + 5]) for w in range(3)] == [
        EK.ACTIVE | EK.DBL, EK.USE_R, EK.USE_L]
    # the three warps' special lanes, and the same three among 65 lanes
    assert int((flags == EK.ACTIVE).sum()) == len(idx) - 6
    got = tree.affine_pair_add(CURVE, l, r, EK.PLAIN)
    F = jax_curve_ops(CURVE).F
    want = jax.jit(lambda u, v: jax_pair_add(F, get_curve(CURVE).a4, u, v))(
        tuple(jax.tree.map(lambda c: c[:, None, :], _jax(c)) for c in l),
        tuple(jax.tree.map(lambda c: c[:, None, :], _jax(c)) for c in r))
    for lo, hi in _slices(layouts):
        assert all(_same(g[:, lo:hi], tuple(x[:, 0, lo:hi] for x in w))
                   for g, w in zip(got, want)), (lo, hi)
