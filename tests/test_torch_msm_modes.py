"""The port's MSM modes "xyzz" and "affine" (sppark_tpu_torch.msm.
pippenger: MSMRoundStages, the spread breakdown, the replica fold) and its
test curves over the one-word fields (params.py, ff/lane.py) against the
JAX package on the CPU, where every kernel wrapper takes its plain
version; tolerance zero throughout (integer arithmetic).

  * toy_bb31, test_gl64 and test_gl64_g2 (and their scalar fields) equal
    sppark_tpu/params.py's;
  * make_breakdown(spread=True) ids and signs word for word against
    _make_breakdown(spread=True), with 0, 1, r // 2, r // 2 + 1 and r - 1
    planted, on test_gl64, test_gl64_g2 and BLS12-381;
  * the integrate with the top window's replica fold (k = 16) against
    the JAX package's _make_integrate(k_spread > 1) on test_gl64 buckets
    with doubling, cancelling and empty replicas planted;
  * MSMContext(mode="xyzz" / "affine") on test_gl64 (n = 96, 8-bit
    windows, tests/test_msm.py's planted edges: an infinity, a zero
    scalar, r - 1, r // 2 + 1, repeated points): the window sums word for
    word against the JAX package's stages, and the point against
    msm_naive;
    msm_naive.

tests/test_torch_msm_modes_g2.py holds the G2 mode and the kernels'
fields.  The JAX side's compiles cost most of the file's ~45 s (its
test_gl64 integrate ~20 s, shared by the tests here).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sppark_tpu.params as jax_params
from sppark_tpu.ec import get_curve_ops as jax_curve_ops
from sppark_tpu.msm.pippenger import _make_breakdown, _pipeline
from sppark_tpu_torch import params
from sppark_tpu_torch.ec import get_curve_ops
from sppark_tpu_torch.ec import kernels as EK
from sppark_tpu_torch.ff import gl64
from sppark_tpu_torch.msm import MSMContext, MSMRoundStages, pippenger, slab
from sppark_tpu_torch.oracle.ec import get_oracle
from sppark_tpu_torch.oracle.msm import msm_naive
from sppark_tpu_torch.params import get_curve

CURVE = "test_gl64"
N, WBITS = 96, 8


def _jax(t, degree=1):
    """The port's one-word Goldilocks words, (degree, ...) int64 -> the
    JAX package's (lo, hi) uint32 planes, an fp2 coordinate a pair."""
    if degree == 2:
        return tuple(gl64.to_jax_planes(c) for c in t)
    return gl64.to_jax_planes(t[0])


def _same(port, jax_out, degree=1):
    return all(np.array_equal(_jax(p, degree), np.asarray(j))
               if degree == 1 else
               all(np.array_equal(a, np.asarray(b))
                   for a, b in zip(_jax(p, 2), j))
               for p, j in zip(port, jax_out))


def _inputs(curve, n, rng, distinct=8):
    """tests/test_msm.py:make_inputs: a replicated point set, infinity at
    index 3, a zero scalar, r - 1 and r // 2 + 1."""
    cp = get_curve(curve)
    o = get_oracle(cp)
    base = [o.random_point(rng) for _ in range(distinct)]
    points = [base[i % distinct] for i in range(n)]
    points[3] = o.infinity_affine()
    r = cp.scalar.modulus
    scalars = [rng.randrange(r) for _ in range(n)]
    scalars[1], scalars[2], scalars[4] = 0, r - 1, r // 2 + 1
    return points, scalars


def _words(curve, scalars):
    cp = get_curve(curve)
    n_words = (cp.scalar.bits + 31) // 32
    return pippenger._scalar_words_from_ints(scalars, cp.scalar.modulus,
                                             n_words)


def _rows(curve, points):
    ops = get_curve_ops(curve, EK.PLAIN.field)
    return slab.point_rows(ops.F, *ops.affine_from_ints(points))


@pytest.mark.parametrize("curve", ["toy_bb31", "test_gl64", "test_gl64_g2"])
def test_test_curves_match_reference(curve):
    a, b = params.get_curve(curve), jax_params.get_curve(curve)
    assert (a.b, a.a4, a.b_c1, a.cofactor) == (b.b, b.a4, b.b_c1, b.cofactor)
    for x, y in ((a.field, b.field), (a.scalar, b.scalar)):
        assert (x.name, x.modulus, x.montgomery_wire) == \
            (y.name, y.modulus, y.montgomery_wire)
        assert params.get_field(x.name) == x
    assert (a.fp2 is None) == (b.fp2 is None)
    if a.fp2:
        assert (a.fp2.name, a.fp2.base.modulus, a.fp2.nonresidue) == \
            (b.fp2.name, b.fp2.base.modulus, b.fp2.nonresidue)


@pytest.mark.parametrize("curve,wbits", [("test_gl64", 8),
                                         ("test_gl64_g2", 5),
                                         ("bls12_381", 13)])
def test_spread_breakdown_vs_jax(curve, wbits):
    cp = get_curve(curve)
    r = cp.scalar.modulus
    n_words = (cp.scalar.bits + 31) // 32
    nwins = (cp.scalar.bits + wbits - 1) // wbits
    assert pippenger.spread_policy(r, wbits, nwins,
                                   1 << (wbits - 1))[1] > 1
    rng = random.Random(curve)
    sc = [rng.randrange(r) for _ in range(200)]
    sc[:5] = [0, 1, r // 2, r // 2 + 1, r - 1]
    w = _words(curve, sc)
    ids, signs = pippenger.make_breakdown(curve, wbits, nwins, n_words,
                                          spread=True)(
        torch.from_numpy(w.view(np.int32)))
    jids, jsigns = _make_breakdown(curve, wbits, nwins, n_words,
                                   spread=True)(jnp.asarray(w))
    assert np.array_equal(ids.numpy(), np.asarray(jids, np.int64))
    assert np.array_equal(signs.numpy(), np.asarray(jsigns))


def test_replica_fold_integrate_vs_jax():
    """Buckets of xyzz points (2 P, ZZ != 1) with the top window's
    replicas planted: equal (the fold doubles), opposite (cancels), empty
    (infinity), then its (k, span) slots folded and integrated."""
    nwins = (get_curve(CURVE).scalar.bits + WBITS - 1) // WBITS
    st = MSMRoundStages(CURVE, WBITS, nwins, 2, kern=EK.PLAIN)
    assert st.k_spread == 16 and st.top_span == 8
    nb = st.nbuckets
    o = get_oracle(get_curve(CURVE))
    rng = random.Random(7)
    pool = [o.random_point(rng) for _ in range(16)]
    pts = [pool[rng.randrange(16)] for _ in range(nwins * nb)]
    top = (nwins - 1) * nb
    span = st.top_span
    pts[top + 0 * span] = pts[top + 1 * span]           # digit 1: doubles
    pts[top + 2 * span + 1] = o.affine_neg(pts[top + 3 * span + 1])
    for k in range(4, 16):                              # digit 3: empty
        pts[top + k * span + 2] = o.infinity_affine()
    ops = get_curve_ops(CURVE, EK.PLAIN.field)
    bucket = ops.xyzz_dbl(ops.affine_to_xyzz(ops.affine_from_ints(pts)))
    bucket = tuple(c.reshape(1, nwins, nb) for c in bucket)
    got = st._integrate(bucket)
    fn = _pipeline(CURVE, WBITS, nwins, 2, "xyzz")
    want = fn.integrate(tuple(jnp.asarray(_jax(c)) for c in bucket))
    assert _same(got, want)


@pytest.mark.parametrize("mode", ["xyzz", "affine"])
def test_msm_mode_vs_jax(mode, rng):
    points, scalars = _inputs(CURVE, N, rng)
    ctx = MSMContext(CURVE, N, wbits=WBITS, mode=mode, device="cpu")
    assert isinstance(ctx.stages, MSMRoundStages) and ctx.stages.k_spread > 1
    w = _words(CURVE, scalars)
    win = ctx.stages.window_sums(torch.from_numpy(w.view(np.int32)),
                                 _rows(CURVE, points))
    fn = _pipeline(CURVE, WBITS, ctx.nwins, ctx.n_words, mode)
    jwin = fn.window_sums(jnp.asarray(w),
                          jax_curve_ops(CURVE).affine_from_ints(points))
    assert _same(win, jwin)
    aff = ctx.stages.to_affine(win)
    assert _same(aff, fn.to_affine(jwin))
    cp = get_curve(CURVE)
    want = msm_naive(cp, points, scalars)
    assert ctx._collect(*aff) == want
