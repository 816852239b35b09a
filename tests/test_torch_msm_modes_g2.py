"""The port's MSM modes "xyzz" and "affine" (sppark_tpu_torch.msm.
pippenger: MSMRoundStages) on G2 and on the kernels' fields, on the CPU,
where every kernel wrapper takes its plain version; tolerance zero
(integer arithmetic).  tests/test_torch_msm_modes.py holds the test
curves, the spread breakdown, the replica fold and the G1 modes against
the JAX package.

  * mode "affine" on test_gl64_g2 (6-bit windows, tests/test_msm.py:242):
    the affine buckets word for word against the JAX package's
    accumulate, the point against msm_naive (its test_gl64_g2 integrate,
    ~35 s of compile, is left out);
  * both modes on test_bm64 and test_bm64_g2 (the kernels' fields),
    chunked, with Montgomery-form scalars, and with all-equal scalars
    (rounds = n) on test_gl64, against msm_naive;
  * an unknown mode raises.

~25 s serial by pytest's count.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sppark_tpu.ec import get_curve_ops as jax_curve_ops
from sppark_tpu.msm.pippenger import _pipeline
from sppark_tpu_torch.ec import get_curve_ops
from sppark_tpu_torch.ec import kernels as EK
from sppark_tpu_torch.ff import gl64
from sppark_tpu_torch.msm import MSMContext, pippenger, slab
from sppark_tpu_torch.oracle.ec import get_oracle
from sppark_tpu_torch.oracle.msm import msm_naive
from sppark_tpu_torch.params import get_curve


def _words(curve, scalars):
    cp = get_curve(curve)
    n_words = (cp.scalar.bits + 31) // 32
    return pippenger._scalar_words_from_ints(scalars, cp.scalar.modulus,
                                             n_words)


def test_msm_g2_affine_vs_jax(rng):
    curve = "test_gl64_g2"
    cp = get_curve(curve)
    o = get_oracle(cp)
    base = [o.random_point(rng) for _ in range(4)]
    n = 16
    points = [base[i % 4] for i in range(n)]
    points[3] = o.infinity_affine()
    scalars = [rng.randrange(cp.scalar.modulus) for _ in range(n)]
    scalars[2] = cp.scalar.modulus - 1
    ctx = MSMContext(curve, n, wbits=6, mode="affine", device="cpu")
    w = _words(curve, scalars)
    st = ctx.stages
    ops = get_curve_ops(curve, EK.PLAIN.field)
    rows = slab.point_rows(ops.F, *ops.affine_from_ints(points))
    bucket = st.accumulate(st.schedule(torch.from_numpy(w.view(np.int32))),
                           rows)
    fn = _pipeline(curve, 6, ctx.nwins, ctx.n_words, "affine")
    jb = fn.accumulate(*fn.schedule(jnp.asarray(w)),
                       *jax_curve_ops(curve).affine_from_ints(points))
    # the port's (2, ...) int64 Goldilocks words, c0's then c1's; the JAX
    # package's coordinate a (c0, c1) pair of (lo, hi) uint32 planes
    for c, (j0, j1) in zip(bucket, jb):
        assert np.array_equal(gl64.to_jax_planes(c[0]), np.asarray(j0))
        assert np.array_equal(gl64.to_jax_planes(c[1]), np.asarray(j1))
    assert ctx.invoke(scalars, points=points) == msm_naive(cp, points,
                                                           scalars)


@pytest.mark.parametrize("mode", ["xyzz", "affine"])
@pytest.mark.parametrize("curve,wbits", [("test_bm64", 5),
                                         ("test_bm64_g2", 4)])
def test_msm_mode_bigmont_vs_naive(curve, wbits, mode):
    """The kernels' fields (plain versions here), with a doubling and a
    cancelling term in one bucket, chunked, and Montgomery-form scalars."""
    cp = get_curve(curve)
    o = get_oracle(cp)
    r = cp.scalar.modulus
    rng = random.Random(curve + mode)
    pool = [o.random_point(rng) for _ in range(8)]
    n = 24
    pts = [pool[i % 8] for i in range(n)]
    pts[3] = o.infinity_affine()
    pts[7] = o.affine_neg(pts[6])
    sc = [rng.randrange(r) for _ in range(n)]
    sc[:8] = [0, r - 1, 7, 11, 2, 2, 3, 3]
    ctx = MSMContext(curve, n, wbits=wbits, mode=mode, chunk=16,
                     device="cpu")
    want = msm_naive(cp, pts, sc)
    assert ctx.invoke(sc, points=pts) == want
    mont = _words(curve, [cp.scalar.to_mont(s) for s in sc])
    assert ctx.invoke(mont, points=pts, mont=True) == want


@pytest.mark.parametrize("mode", ["xyzz", "affine"])
def test_msm_mode_all_equal_scalars(mode):
    """One bucket a window holds every point: rounds = n."""
    cp = get_curve("test_gl64")
    o = get_oracle(cp)
    rng = random.Random(mode)
    pool = [o.random_point(rng) for _ in range(4)]
    n = 24
    pts = [pool[i % 4] for i in range(n)]
    pts[3] = o.infinity_affine()
    pts[5] = o.affine_neg(pts[4])
    same = [rng.randrange(cp.scalar.modulus)] * n
    ctx = MSMContext("test_gl64", n, wbits=4, mode=mode, device="cpu")
    sched = ctx.stages.schedule(torch.from_numpy(
        _words("test_gl64", same).view(np.int32)))
    assert sched[-1] == n
    assert ctx.invoke(same, points=pts) == msm_naive(cp, pts, same)


def test_unknown_mode_raises():
    with pytest.raises(NotImplementedError, match="unknown"):
        MSMContext("test_gl64", 8, mode="jacobian", device="cpu")
