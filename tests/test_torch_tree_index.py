"""The tree MSM's level 0 as an index into the point table
(sppark_tpu_torch.msm.tree.level0_index) and the pair kernels read through
it (ec.kernels.affine_pair_prep / _finish with `idx`), against the JAX
package on the CPU, where every kernel wrapper takes its plain version.

  * the level-0 index, read through the gather table, gives slot for slot
    the points the JAX package's tree accumulate gathers for its level 0
    (sppark_tpu/msm/tree.py:make_tree_accumulate, its valid and sign
    selects applied), with random and with all-equal scalars;
  * the indexed prep and finish equal gather-then-plain, and the JAX
    package's affine_pair_add on the same points built on its side, with
    rows planted: the zero row 2n (infinity), n + i against i
    (cancellation) and a row against itself (doubling);
  * the wrappers' refusals.

On test_bm64 and test_bm64_g2.  No test interprets a Pallas kernel.  The
JAX package's level 0 is read by catching the first `barrier` of its
accumulate (the one around level 0), so none of its levels runs.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sppark_tpu.msm.tree as jax_tree
from sppark_tpu.ec import get_curve_ops as jax_curve_ops
from sppark_tpu.msm.pippenger import _make_breakdown
from sppark_tpu_torch.ec import get_curve_ops
from sppark_tpu_torch.ec import kernels as EK
from sppark_tpu_torch.ff import kernels as FK
from sppark_tpu_torch.ff.bigmont import to_jax_planes
from sppark_tpu_torch.msm import pippenger, slab, tree
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
        gs = [gp] if degree == 1 else list(gp)
        ws = [w] if degree == 1 else list(w)
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
    """The gather table's rows and its (x, y) coordinate views."""
    rows = slab.point_rows(get_curve_ops(curve, FK.PLAIN).F, *a)
    w = a[0].shape[0]
    return rows, (rows[:, :w].T, rows[:, w:].T)


class _Level0(Exception):
    pass


def _jax_level0(monkeypatch, curve, m0, lmax, jsched, a):
    """The JAX package's level 0, (gx, gy) of shape (.., wg, m0): its tree
    accumulate run eagerly up to the barrier around level 0."""
    def catch(x):
        raise _Level0(x)

    monkeypatch.setattr(jax_tree, "barrier", catch)
    acc = jax_tree.make_tree_accumulate(curve, m0, lmax, False)
    degree = get_curve(curve).degree
    with pytest.raises(_Level0) as got:
        acc(*jsched[:-1], tuple(_jax_el(c, degree) for c in a))
    return got.value.args[0]


@pytest.mark.parametrize("equal", [False, True], ids=["random", "equal"])
@pytest.mark.parametrize("curve", CURVES)
def test_level0_index_vs_jax(monkeypatch, curve, equal):
    """Every slot's row of the table, through the level-0 index, equals the
    point the JAX package's tree gathers there: signed, and (0, 0) past a
    run's end; the index is int32, its even slots in row 0 and its odd
    ones in row 1."""
    cp = get_curve(curve)
    degree = cp.degree
    n, wbits = 48, 4
    nwins = (cp.scalar.bits + wbits - 1) // wbits
    nb = 1 << (wbits - 1)
    rng = np.random.default_rng(21)
    words = rng.integers(0, 1 << 32, size=(2, n), dtype=np.uint64)
    words = words.astype(np.uint32)
    words[-1] %= np.uint32(cp.scalar.modulus >> 32)
    if equal:
        words[:] = words[:, 7:8]
    sched = tree.make_tree_schedule(
        pippenger.make_breakdown(curve, wbits, nwins, 2), nb)(
        torch.from_numpy(words.view(np.int32)))
    jsched = jax_tree.make_tree_schedule(
        _make_breakdown(curve, wbits, nwins, 2, spread=False), nb)(
        jnp.asarray(words))
    m0, lmax = tree.plan_layout([int(v) for v in sched[-1]])
    if equal:
        assert lmax == 6                        # 48 equal: runs of 64
    a = _points(curve, n, 22)
    _, table = _table(curve, a)
    idx = tree.level0_index(*sched[:5], m0)
    assert idx.dtype == torch.int32 and idx.shape == (2, nwins * m0 // 2)
    assert idx.is_contiguous()
    slots = idx.T.reshape(-1)                   # slot q at q, window-major
    got = tuple(c.index_select(1, slots).reshape(c.shape[0], nwins, m0)
                for c in table)
    gx, gy = _jax_level0(monkeypatch, curve, m0, lmax, jsched, a)
    assert _same(got, (gx, gy), degree)
    assert int((slots == 2 * n).sum()) > 0      # padding slots
    assert int(((slots >= n) & (slots < 2 * n)).sum()) > 0  # negated


def _pair_index(n, lanes, seed):
    """(idx_l, idx_r) into a table of n points: random rows, then planted
    pairs: a row with itself (doubling), i with n + i (cancellation), the
    zero row 2n on the left, on the right and on both sides, a negated row
    with itself."""
    g = np.random.default_rng(seed)
    il = g.integers(0, 2 * n + 1, size=lanes)
    ir = g.integers(0, 2 * n + 1, size=lanes)
    il[:6] = [5, 2, 2 * n, 4, 2 * n, n + 1]
    ir[:6] = [5, n + 2, 0, 2 * n, 2 * n, n + 1]
    return tuple(torch.from_numpy(i.astype(np.int32)) for i in (il, ir))


@pytest.mark.parametrize("curve", CURVES)
def test_indexed_pair_vs_gather_and_jax(curve):
    """prep and finish through the index equal gather-then-plain, and
    prep -> batch_inv_flat -> finish equals the JAX package's
    affine_pair_add on the same points built on its side (point i, -point
    i for n + i, (0, 0) for 2n), word for word; every flag word planted."""
    cp = get_curve(curve)
    degree = cp.degree
    n, lanes = 12, 40
    a = _points(curve, n, 23)
    F = get_curve_ops(curve, FK.PLAIN).F
    _, table = _table(curve, a)
    idx = _pair_index(n, lanes, 24)
    den, flags = EK.affine_pair_prep(curve, table, table, idx)
    l, r = (tuple(c.index_select(1, i) for c in table) for i in idx)
    gden, gflags = EK.affine_pair_prep_plain(curve, l, r)
    assert torch.equal(den, gden) and torch.equal(flags, gflags)
    assert sorted(set(flags.tolist())) == [0, 1, 3, 4, 8]
    assert flags[:6].tolist() == [3, 0, 4, 8, 0, 3]
    inv = tree.batch_inv_flat(F, den)
    got = EK.affine_pair_finish(curve, table, table, inv, flags, idx)
    want = EK.affine_pair_finish_plain(curve, l, r, inv, flags)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(
        got, tree.affine_pair_add(curve, table, table, EK.PLAIN, idx)))
    # the JAX side builds the same points from its own planes and ops
    J = jax_curve_ops(curve)
    jx, jy = _jax_el(a[0], degree), _jax_el(a[1], degree)
    zero = J.F.zeros((lanes,))

    def take(i):
        i = i.numpy()
        j = jnp.asarray(i % n)
        pick = lambda c: (jnp.take(c, j, axis=-1) if degree == 1  # noqa
                          else tuple(jnp.take(k, j, axis=-1) for k in c))
        x, y = pick(jx), pick(jy)
        y = J.F.select(jnp.asarray((i >= n) & (i < 2 * n)), J.F.neg(y), y)
        blank = jnp.asarray(i == 2 * n)
        return J.F.select(blank, zero, x), J.F.select(blank, zero, y)

    row = lambda t: jax.tree.map(lambda c: c[:, None, :], t)   # noqa
    jl, jr = (row(take(i)) for i in idx)
    ox, oy = jax.jit(lambda u, v: jax_tree.affine_pair_add(J.F, cp.a4, u,
                                                           v))(jl, jr)
    flat = jax.tree.map(lambda c: c[:, 0, :], (ox, oy))
    assert _same(got, flat, degree)


def test_indexed_pair_refusals():
    """An index the pair wrappers cannot take is refused: not a pair, not
    int32, not 1-D, of two lengths, on another device, past the table's
    rows; a table not two (W, rows) coordinates; the finish's inv of
    another lane count."""
    curve = "test_bm64"
    a = _points(curve, 8, 25)
    _, table = _table(curve, a)
    F = get_curve_ops(curve, FK.PLAIN).F
    i = torch.arange(6, dtype=torch.int32)
    idx = (i, i + 8)
    den, flags = EK.affine_pair_prep(curve, table, table, idx)
    inv = tree.batch_inv_flat(F, den)
    prep = lambda ix, t=table: EK.affine_pair_prep(curve, t, t, ix)  # noqa
    finish = lambda ix, v=inv, t=table: EK.affine_pair_finish(  # noqa
        curve, t, t, v, flags, ix)
    for fn in (prep, finish):
        with pytest.raises(TypeError):
            fn(i)
        with pytest.raises(TypeError):
            fn((i.to(torch.int64), i))
        with pytest.raises(TypeError):
            fn(([0] * 6, i))
        for bad in (i.reshape(2, 3), i[:5],
                    torch.zeros(6, dtype=torch.int32, device="meta")):
            with pytest.raises(ValueError):
                fn((i, bad))
        with pytest.raises((IndexError, RuntimeError)):  # index_select's
            fn((i, i + table[0].shape[1] - 3))
    with pytest.raises(ValueError):
        prep(idx, (table[0],))
    with pytest.raises(ValueError):
        prep(idx, (table[0][:, None], table[1][:, None]))
    with pytest.raises(ValueError):
        finish(idx, inv[:, :5])
