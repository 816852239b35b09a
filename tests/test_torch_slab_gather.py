"""The slab MSM's gather fused into the madd (sppark_tpu_torch.msm.slab's
slot index, ec.kernels.xyzz_madd with `idx`) against the JAX package on
the CPU, where every kernel wrapper takes its plain version.

  * the slot index, read through the gather table, gives slot for slot
    the rows the JAX package's slab gathers (sppark_tpu/msm/slab.py:
    _materialize, its valid and sign selects applied);
  * the indexed madd equals gather-then-madd, and the JAX package's
    CurveOps.xyzz_madd (the plain reference of pallas_ops.py:_madd_call,
    held to the kernel by tests/test_pallas_ec.py) on the same points,
    with indices that hit negated rows, the zero row 2n and repeated rows;
  * the wrapper's refusals.

On test_bm64 and test_bm64_g2.  No test interprets a Pallas kernel: the
interpreted _madd_call took more than ten minutes to compile on an 8-core
x86 CPU.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sppark_tpu.ec import get_curve_ops as jax_curve_ops
from sppark_tpu.msm.pippenger import _make_breakdown
from sppark_tpu.msm.slab import _materialize
from sppark_tpu.msm.slab import make_slab_schedule as jax_schedule
from sppark_tpu_torch.ec import get_curve_ops
from sppark_tpu_torch.ec import kernels as EK
from sppark_tpu_torch.ff import kernels as FK
from sppark_tpu_torch.ff.bigmont import to_jax_planes
from sppark_tpu_torch.msm import pippenger, slab
from sppark_tpu_torch.oracle.ec import get_oracle
from sppark_tpu_torch.params import get_curve

CURVES = ["test_bm64", "test_bm64_g2"]


def _jax_el(t, degree):
    planes = to_jax_planes(t, degree=degree)
    if degree == 1:
        return jnp.asarray(planes)
    return tuple(jnp.asarray(c) for c in planes)


def _same(got, want, degree):
    """Port coordinates against JAX coordinates, word for word."""
    for g, w in zip(got, want):
        gp = to_jax_planes(g, degree=degree)
        ws = [w] if degree == 1 else list(w)
        gs = [gp] if degree == 1 else list(gp)
        if not all(np.array_equal(a, np.asarray(b, np.uint32))
                   for a, b in zip(gs, ws)):
            return False
    return True


def _points(curve, n, seed):
    """n affine points from 6 distinct ones, infinity at lane 3."""
    o = get_oracle(get_curve(curve))
    rng = random.Random(seed)
    pool = [o.random_point(rng) for _ in range(6)]
    pts = [pool[i % 6] for i in range(n)]
    pts[3] = o.infinity_affine()
    return get_curve_ops(curve, FK.PLAIN).affine_from_ints(pts)


def _table(curve, a):
    rows = slab.point_rows(get_curve_ops(curve, FK.PLAIN).F, *a)
    w = a[0].shape[0]
    return rows, (rows[:, :w].T, rows[:, w:].T)


@pytest.mark.parametrize("curve", CURVES)
def test_slot_index_rows_vs_jax_slab(curve):
    """Every slot's row of the table, through the slot index, equals the
    point the JAX package's slab gathers there: signed, and (0, 0) past a
    run's end; replica rows included (24 equal scalars overflow the cap
    of 16)."""
    cp = get_curve(curve)
    degree = cp.degree
    n, wbits = 64, 4
    nwins = (cp.scalar.bits + wbits - 1) // wbits
    rng = np.random.default_rng(2)
    words = rng.integers(0, 1 << 32, size=(2, n), dtype=np.uint64)
    words = words.astype(np.uint32)
    words[-1] %= np.uint32(cp.scalar.modulus >> 32)
    words[:, 30:54] = words[:, 5:6]
    cap, n_rows = slab.plan_slab(n, 1 << (wbits - 1))
    sched = slab.make_slab_schedule(
        pippenger.make_breakdown(curve, wbits, nwins, 2), 1 << (wbits - 1),
        cap, n_rows)(torch.from_numpy(words.view(np.int32)))
    jsched = jax_schedule(_make_breakdown(curve, wbits, nwins, 2,
                                          spread=False),
                          1 << (wbits - 1), cap, n_rows)(jnp.asarray(words))
    assert int(sched[-1][1]) > 1               # some bucket has replicas
    a = _points(curve, n, 1)
    _, table = _table(curve, a)
    idx = slab.slot_index(sched[0], sched[1], sched[2], cap)
    assert idx.dtype == torch.int32 and idx.shape == (cap, nwins * n_rows)
    got = tuple(c.index_select(1, idx.reshape(-1)) for c in table)
    J = jax_curve_ops(curve)
    (gx, gy), valid, sgn = _materialize(
        jsched[0], jsched[1], jsched[2], cap,
        (_jax_el(a[0], degree), _jax_el(a[1], degree)), False)
    zero = J.F.zeros(valid.shape)
    gx = J.F.select(valid, gx, zero)
    gy = J.F.select(valid, gy, zero)
    gy = J.F.select(sgn, J.F.neg(gy), gy)
    flat = lambda x: x.reshape(x.shape[0], -1)          # noqa: E731
    want = tuple(flat(c) if degree == 1 else tuple(flat(k) for k in c)
                 for c in (gx, gy))
    assert _same(got, want, degree)


@pytest.mark.parametrize("curve", CURVES)
def test_indexed_madd_vs_jax(curve):
    """The madd of buckets p and the table's rows idx: with the index (the
    plain version on the CPU), gather-then-madd, and the JAX package's
    xyzz_madd on the same points built on its side (point i, -point i for
    n + i, (0, 0) for 2n) agree word for word.  Planted: a negated row, the
    zero row, the point at infinity, a repeated row, a doubling lane, a
    cancelling lane and an empty bucket."""
    cp = get_curve(curve)
    degree = cp.degree
    n, lanes = 12, 24
    a = _points(curve, n, 3)
    ops = get_curve_ops(curve, FK.PLAIN)
    _, table = _table(curve, a)
    idx = np.random.default_rng(4).integers(0, 2 * n + 1, size=lanes)
    # lanes 0..7: point 0, -point 1, the zero row, point 3 (infinity),
    # point 4 twice, point 2 onto itself (doubling), -point 2 onto point 2
    # (cancelling); lane 8 an empty bucket
    idx[:8] = [0, n + 1, 2 * n, 3, 4, 4, 2, n + 2]
    o = get_oracle(cp)
    rng = random.Random(5)
    pool = [o.random_point(rng) for _ in range(lanes)]
    pool[6] = pool[7] = o.random_point(rng)
    p = tuple(c.clone() for c in ops.affine_to_xyzz(ops.affine_from_ints(
        pool)))
    two = ops.affine_from_ints([pool[6]])
    for k in (0, 1):                    # point 2 of the table := pool[6]
        table[k][:, 2] = two[k][:, 0]
        table[k][:, n + 2] = ops.F.neg(two[k])[:, 0] if k else two[k][:, 0]
    for c in p:
        c[:, 8] = 0
    t_idx = torch.from_numpy(idx.astype(np.int32))
    got = EK.xyzz_madd(curve, p, table, t_idx)
    gathered = tuple(c.index_select(1, t_idx) for c in table)
    assert all(torch.equal(g, w) for g, w in zip(
        got, EK.xyzz_madd_plain(curve, p, gathered)))
    # the JAX side builds the same points from its own planes and ops
    J = jax_curve_ops(curve)
    pos = tuple(c[:, :n] for c in table)
    jx, jy = _jax_el(pos[0], degree), _jax_el(pos[1], degree)
    j = jnp.asarray(idx % n)
    take = lambda c: (jnp.take(c, j, axis=-1) if degree == 1   # noqa: E731
                      else tuple(jnp.take(k, j, axis=-1) for k in c))
    gx, gy = take(jx), take(jy)
    neg = jnp.asarray((idx >= n) & (idx < 2 * n))
    gy = J.F.select(neg, J.F.neg(gy), gy)
    zero = J.F.zeros((lanes,))
    blank = jnp.asarray(idx == 2 * n)
    gx, gy = J.F.select(blank, zero, gx), J.F.select(blank, zero, gy)
    jp = tuple(_jax_el(c, degree) for c in p)
    assert _same(got, J.xyzz_madd(jp, (gx, gy)), degree)
    # the legs taken: lane 7 cancelled, lanes 2 and 3 kept their bucket,
    # lane 6 doubled, lane 8 took its point
    inf = ops.xyzz_is_inf(got)
    assert bool(inf[7]) and not bool(inf[6]) and not bool(inf[8])
    assert all(torch.equal(g[:, 2:4], c[:, 2:4]) for g, c in zip(got, p))


def test_indexed_madd_refusals():
    """An index the madd cannot take is refused: not int32, not 1-D, not
    p's lane count, on another device, past the table's rows; a table not
    two (W, rows) coordinates, or of 2^31 rows."""
    curve = "test_bm64"
    a = _points(curve, 8, 6)
    _, table = _table(curve, a)
    p = get_curve_ops(curve, FK.PLAIN).affine_to_xyzz(a)
    idx = torch.arange(8, dtype=torch.int32)
    assert all(torch.equal(g, w) for g, w in zip(
        EK.xyzz_madd(curve, p, table, idx), EK.xyzz_madd_plain(
            curve, p, tuple(c[:, :8] for c in table))))
    with pytest.raises(TypeError):
        EK.xyzz_madd(curve, p, table, idx.to(torch.int64))
    with pytest.raises(TypeError):
        EK.xyzz_madd(curve, p, table, [0] * 8)
    for bad in (idx[:7], idx.reshape(2, 4),
                torch.zeros(8, dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError):
            EK.xyzz_madd(curve, p, table, bad)
    with pytest.raises((IndexError, RuntimeError)):  # index_select's
        EK.xyzz_madd(curve, p, table, idx + table[0].shape[1] - 7)
    with pytest.raises(ValueError):
        EK.xyzz_madd(curve, p, (table[0],), idx)
    with pytest.raises(ValueError):
        EK.xyzz_madd(curve, p, (table[0][:, None], table[1][:, None]), idx)
    huge = torch.zeros((2, 1), dtype=torch.int32).expand(2, 1 << 31)
    with pytest.raises(ValueError):
        EK.xyzz_madd(curve, p, (huge, huge), idx)
