"""The port's segmented-tree MSM (sppark_tpu_torch.msm.tree, mode="tree")
against the JAX package's on the CPU, where every kernel wrapper takes its
plain version; tolerance zero throughout (integer arithmetic).

  * make_tree_schedule's eight outputs word for word on test_bm64, with
    zero, r - 1 and repeated scalars planted;
  * the batch-affine pair add (prep -> batch_inv_flat -> finish) against
    sppark_tpu.msm.tree.affine_pair_add on test_bm64 and test_bm64_g2
    with every special lane planted, and on BLS12-381 against the oracle;
  * one window group's tree accumulate (its affine bucket sums) against
    the JAX package's non-fused _tree_acc_jit on test_bm64, which is how
    its own CPU tests reach the tree;
  * whole tree MSMs against msm_naive and the slab mode: test_bm64,
    test_bm64_g2, host points streamed in chunks with Montgomery-form
    scalars, and BLS12-381 with all-equal scalars in a chunked invoke;
  * batch_inv_tree against exact inverses in the base field and in Fp2.

No test interprets a Pallas kernel, and no test runs the JAX package's
whole tree MSM (tens of seconds of compile).  The file takes ~43 s serial
by pytest's count (~50 s wall with the imports) on an 8-core x86 CPU, most
of it the JAX side's compiles and the plain 381-bit Fermat chains (one per
tree level).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sppark_tpu.ec import get_curve_ops as jax_curve_ops
from sppark_tpu.msm.pippenger import _make_breakdown, _tree_acc_jit
from sppark_tpu.msm.tree import affine_pair_add as jax_pair_add
from sppark_tpu.msm.tree import make_tree_schedule as jax_schedule
from sppark_tpu_torch.ec import get_curve_ops
from sppark_tpu_torch.ec import kernels as EK
from sppark_tpu_torch.ff.bigmont import get_field_ops, to_jax_planes
from sppark_tpu_torch.ff.ext import get_fp2_ops
from sppark_tpu_torch.msm import MSMContext, pippenger, slab, tree
from sppark_tpu_torch.oracle.ec import AffinePoint, get_oracle
from sppark_tpu_torch.oracle.msm import msm_naive
from sppark_tpu_torch.params import get_curve

CURVE = "test_bm64"
N, WBITS = 64, 5


def _scalars(curve, n, seed):
    """Seeded scalars with 0, r - 1 and a repeated scalar planted."""
    r = get_curve(curve).scalar.modulus
    rng = random.Random(seed)
    sc = [rng.randrange(r) for _ in range(n)]
    sc[0], sc[1] = 0, r - 1
    for k in range(12, n, 8):
        sc[k] = sc[4]
    return sc


def _words(sc, n_words):
    return np.array([[(s >> (32 * i)) & 0xFFFFFFFF for s in sc]
                     for i in range(n_words)], dtype=np.uint32)


def _points(curve, n, seed):
    """n points from 8 distinct ones, infinity at index 3."""
    o = get_oracle(get_curve(curve))
    rng = random.Random(seed)
    base = [o.random_point(rng) for _ in range(8)]
    pts = [base[i % 8] for i in range(n)]
    pts[3] = AffinePoint(0, 0, True)
    return pts


def _jax(t, curve):
    """Port words -> the JAX package's planes (a (c0, c1) pair for G2)."""
    planes = to_jax_planes(t, degree=get_curve(curve).degree)
    if isinstance(planes, tuple):
        return tuple(jnp.asarray(p) for p in planes)
    return jnp.asarray(planes)


def _same(got, want, curve):
    """Port words == JAX planes, word for word."""
    g = to_jax_planes(got, degree=get_curve(curve).degree)
    if isinstance(g, tuple):
        return all(np.array_equal(a, np.asarray(b, np.uint32))
                   for a, b in zip(g, want))
    return np.array_equal(g, np.asarray(want, np.uint32))


def _schedules(words):
    """The port's and the JAX package's tree schedules of scalar words."""
    cp = get_curve(CURVE)
    nwins = (cp.scalar.bits + WBITS - 1) // WBITS
    nb = 1 << (WBITS - 1)
    want = jax.jit(jax_schedule(_make_breakdown(CURVE, WBITS, nwins, 2,
                                                spread=False), nb))(
        jnp.asarray(words))
    got = tree.make_tree_schedule(
        pippenger.make_breakdown(CURVE, WBITS, nwins, 2), nb)(
        torch.from_numpy(words.view(np.int32)))
    return got, want


def test_tree_schedule_vs_jax():
    """The eight schedule outputs, word for word, with zero, r - 1 and
    repeated scalars (one bucket per window holds at least 8 points)."""
    got, want = _schedules(_words(_scalars(CURVE, N, 1), 2))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    assert int(got[-1][1]) >= 8


def _pair_lanes(curve, n, seed):
    """Oracle pairs (L, R): generic lanes, then planted l == r (doubling),
    l == -r (cancellation), l at infinity, r at infinity, both."""
    o = get_oracle(get_curve(curve))
    rng = random.Random(seed)
    L = [o.random_point(rng) for _ in range(n)]
    R = [o.random_point(rng) for _ in range(n)]
    R[1] = L[1]
    R[2] = o.affine_neg(L[2])
    L[3] = AffinePoint(0, 0, True)
    R[4] = AffinePoint(0, 0, True)
    L[5] = R[5] = AffinePoint(0, 0, True)
    R[6] = L[6]
    return L, R


@pytest.mark.parametrize("curve", ["test_bm64", "test_bm64_g2"])
def test_pair_add_vs_jax(curve):
    """prep -> batch_inv_flat -> finish on the plain versions against the
    JAX package's affine_pair_add, word for word, every case planted; the
    flag word has each of its values."""
    L, R = _pair_lanes(curve, 12, 2)
    ops = get_curve_ops(curve, EK.PLAIN.field)
    l, r = ops.affine_from_ints(L), ops.affine_from_ints(R)
    den, flags = EK.affine_pair_prep_plain(curve, l, r)
    assert sorted(set(flags.tolist())) == [0, 1, 3, 4, 8]
    got = tree.affine_pair_add(curve, l, r, EK.PLAIN)
    F = jax_curve_ops(curve).F
    a4 = get_curve(curve).a4
    want = jax.jit(lambda a, b: jax_pair_add(F, a4, a, b))(
        tuple(jax.tree.map(lambda c: c[:, None, :], _jax(c, curve))
              for c in l),
        tuple(jax.tree.map(lambda c: c[:, None, :], _jax(c, curve))
              for c in r))
    for g, w in zip(got, want):
        assert _same(g, jax.tree.map(lambda c: c[:, 0, :], w), curve)


def test_pair_add_bls12_381_vs_oracle():
    """The 381-bit pair add on the plain versions against the oracle's
    exact sums, every case planted."""
    cp = get_curve("bls12_381")
    o = get_oracle(cp)
    L, R = _pair_lanes("bls12_381", 8, 3)
    ops = get_curve_ops("bls12_381", EK.PLAIN.field)
    got = ops.affine_to_ints(tree.affine_pair_add(
        "bls12_381", ops.affine_from_ints(L), ops.affine_from_ints(R),
        EK.PLAIN))
    for g, a, b in zip(got, L, R):
        s = o.jacobian_to_affine(o.jacobian_add(o.to_jacobian(a),
                                                o.to_jacobian(b)))
        assert g == ((0, 0) if s.inf else (s.x, s.y))


def test_tree_accumulate_vs_jax():
    """One group of two windows: the affine bucket sums of the port's
    accumulate (level 0 gathered from the signed point table, the levels'
    pair adds, each sum taken where its run finished) against the JAX
    package's non-fused accumulate, word for word."""
    words = _words(_scalars(CURVE, N // 2, 4), 2)
    got, want = _schedules(words)
    m0, lmax = tree.plan_layout([int(v) for v in got[-1]])
    assert lmax == 3                # runs of 2, 4 and 8 slots
    ops = get_curve_ops(CURVE)
    px, py = ops.affine_from_ints(_points(CURVE, N // 2, 5))
    g = slice(10, 12)       # the top two windows (the top one is short)
    bx, by = tree.accumulate(CURVE, m0, lmax, *(a[g] for a in got[:-1]),
                             slab.point_rows(ops.F, px, py), EK.PLAIN)
    jx, jy = _tree_acc_jit(CURVE, m0, lmax, False)(
        *(a[g] for a in want[:-1]), (_jax(px, CURVE), _jax(py, CURVE)))
    assert bx.shape == (2, 2, 1 << (WBITS - 1))
    assert _same(bx, jx, CURVE) and _same(by, jy, CURVE)


@pytest.mark.parametrize("curve,n,wbits", [("test_bm64", 64, 4),
                                           ("test_bm64_g2", 32, 4)])
def test_tree_msm_vs_naive_and_slab(curve, n, wbits):
    """mode="tree" on device="cpu" gives msm_naive's point and the slab
    mode's, with infinity, zero, r - 1 and repeated terms planted; the
    tree's stages are a distinct pipeline."""
    pts, sc = _points(curve, n, 6), _scalars(curve, n, 7)
    want = msm_naive(get_curve(curve), pts, sc)
    ctx = MSMContext(curve, n, wbits=wbits, mode="tree", device="cpu")
    assert isinstance(ctx.stages, pippenger.MSMTreeStages)
    assert ctx.invoke(sc, points=pts) == want
    assert MSMContext(curve, n, wbits=wbits, device="cpu").invoke(
        sc, points=pts) == want


def test_tree_msm_host_streamed_chunks():
    """Host numpy points streamed chunk by chunk (a short tail chunk) and
    Montgomery-form scalar words through mode="tree"."""
    cp = get_curve(CURVE)
    n = 40
    pts, sc = _points(CURVE, n, 11), _scalars(CURVE, n, 12)
    ctx = MSMContext(CURVE, n, wbits=4, mode="tree", chunk=16, device="cpu")
    host = tuple(a.numpy().view(np.uint32)
                 for a in ctx.ops.affine_from_ints(pts))
    mont = _words([cp.scalar.to_mont(s) for s in sc], ctx.n_words)
    assert ctx.invoke(mont, points=host, mont=True) == msm_naive(cp, pts, sc)


def test_tree_msm_bls12_381_all_equal_chunked():
    """BLS12-381, every scalar equal (one bucket per window holds every
    point: the tree's adversarial case costs one level per doubling), in a
    chunked invoke of two chunks over resident points."""
    cp = get_curve("bls12_381")
    n = 8
    pts = _points("bls12_381", n, 8)
    k = random.Random(9).randrange(cp.scalar.modulus)
    ctx = MSMContext("bls12_381", n, wbits=4, mode="tree", chunk=4,
                     device="cpu")
    ctx.set_points(pts)
    assert ctx.invoke([k] * n) == msm_naive(cp, pts, [k] * n)


@pytest.mark.parametrize("curve", ["test_bm64", "bls12_381", "test_bm64_g2",
                                   "bls12_381_g2"])
def test_batch_inv_tree_exact(curve):
    """batch_inv_tree against exact inverses (base field: pow(x, -1, p);
    Fp2: conj / norm), 8 lanes; a length that is not a power of two is
    refused."""
    cp = get_curve(curve)
    p = cp.field.modulus
    rng = random.Random(10)
    if cp.fp2 is None:
        F = get_field_ops(cp.field)
        xs = [rng.randrange(1, p) for _ in range(8)]
        want = [pow(x, -1, p) for x in xs]
    else:
        F = get_fp2_ops(cp.fp2)
        nr = cp.fp2.nr_small
        xs = [(rng.randrange(p), rng.randrange(1, p)) for _ in range(8)]
        want = []
        for a0, a1 in xs:
            ninv = pow(a0 * a0 - nr * a1 * a1, -1, p)
            want.append((a0 * ninv % p, -a1 * ninv % p))
    x = F.from_int_list(xs)
    assert F.to_int_list(F.batch_inv_tree(x)) == want
    with pytest.raises(ValueError):
        F.batch_inv_tree(x[:, :6])
