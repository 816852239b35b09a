"""The port's batch inversion (sppark_tpu_torch.ff.kernels.mont_batch_inv
and its plain version, the bigmont_inv_up -> bigmont_pow ->
bigmont_inv_down pipeline of csrc/batch_inv.cu on its own schedule) on the
CPU:

  * the plain version at small blocks (T = 4 threads of C = 3 lanes, so
    several blocks and a ragged last chunk occur) against the JAX
    package's batch_inv and batch_inv_tree (sppark_tpu/ff/base.py:201,232)
    on test_bm64_fp, with zero lanes, n = 0, 1, 7, 300 and a leading batch
    axis;
  * degree 2 against the JAX package's Fp2 norm form
    (sppark_tpu/ff/ext.py:88-107) on test_bm64_g2;
  * one tree level's inversion without padding (the card's
    batch_inv_flat) against the JAX package's padded batch_inv_flat;
  * degree 2 on BLS12-381 and test_bm64_g2 (zero lanes planted) and
    other blocks against exact inverses; the up kernel's arrays; the
    wrapper's routing and refusals.

Everything runs through the JAX package's generic (XLA) path: no Pallas
kernel is interpreted.  The JAX side's CPU compiles cost most: its
zero-tolerant batch_inv at 300 lanes ~7 s, its test_bm64 product tree
over 16 lanes ~3.5 s (shared by the next tests through JAX's cache); a
381-bit JAX comparison would add 15-20 s, so the 381-bit case is held to
Python's exact inverses, which pin the words (a canonical inverse is
unique).  ~17 s in all by pytest's count.
Inputs come from numpy.random.default_rng(seed); integer field arithmetic,
compared exactly (tolerance zero).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sppark_tpu.ec import get_curve_ops as jax_curve_ops
from sppark_tpu.ff import get_jax_field
from sppark_tpu.msm.tree import batch_inv_flat as jax_batch_inv_flat
from sppark_tpu_torch.ec import get_curve_ops
from sppark_tpu_torch.ec import kernels as EK
from sppark_tpu_torch.ff import kernels as FK
from sppark_tpu_torch.ff.bigmont import get_field_ops, to_jax_planes
from sppark_tpu_torch.ff.ext import get_fp2_ops
from sppark_tpu_torch.msm import tree
from sppark_tpu_torch.params import get_curve, get_field
from sppark_tpu_torch.util.errors import SpparkError

T, C = 4, 3


def _ints(p, n, seed, zeros=()):
    """n canonical ints from default_rng(seed), 0 at the lanes `zeros`."""
    k = p.bit_length() // 32 + 2
    rows = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, k),
                                                dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(r)) % p
            for r in rows]
    for z in zeros:
        vals[z] = 0
    return vals


def _same(t, j):
    return np.array_equal(to_jax_planes(t), np.asarray(j, dtype=np.uint32))


def _same2(t, j):
    return all(_same(a, b) for a, b in zip(t.chunk(2), j))


@functools.lru_cache(maxsize=None)
def _batch_inv_ref(field):
    """(3, 100) words with zero lanes, and the JAX package's batch_inv of
    them along the last axis: each lane's inverse, so every slice of the
    input has the same slice of it as its inverse."""
    F = get_field_ops(field)
    x = F.from_int_list(_ints(F.p, 300, 1, zeros=(0, 3, 150, 299)),
                        batch_shape=(3, 100))
    J = get_jax_field(field)
    return x, np.asarray(jax.jit(J.batch_inv)(jnp.asarray(to_jax_planes(x))))


@pytest.mark.parametrize("field", ["test_bm64_fp"])
@pytest.mark.parametrize("case", ["n 1", "n 7", "n 300, leading axis",
                                  "n 300, flat", "n 0"])
def test_batch_inv_plain_vs_jax(field, case):
    """mont_batch_inv_plain (and the CPU wrapper) against the JAX package's
    zero-tolerant batch_inv, word for word."""
    fp = get_field(field)
    x, ref = _batch_inv_ref(field)
    sl = {"n 1": (slice(1), slice(1)), "n 7": (slice(1), slice(7)),
          "n 300, leading axis": (slice(None), slice(None)),
          "n 300, flat": (slice(None), slice(None)),
          "n 0": (slice(None), slice(0))}[case]
    xs, want = x[(slice(None),) + sl], ref[(slice(None),) + sl]
    if case == "n 300, flat":
        xs, want = xs.reshape(fp.n_ref_limbs, 300), want.reshape(-1, 300)
    got = FK.mont_batch_inv_plain(xs, fp, threads=T, chunk=C)
    assert got.shape == xs.shape and _same(got, want)
    assert torch.equal(FK.mont_batch_inv(xs, fp), got)


def test_batch_inv_tree_plain_vs_jax():
    """The same pipeline on batch_inv_tree's inputs (a power-of-two axis,
    non-zero lanes) against the JAX package's product tree."""
    fp = get_field("test_bm64_fp")
    F = get_field_ops(fp)
    x = F.from_int_list([v or 1 for v in _ints(F.p, 16, 2)])
    want = get_jax_field(fp.name).batch_inv_tree(
        jnp.asarray(to_jax_planes(x)))
    assert _same(FK.mont_batch_inv_plain(x, fp, threads=T, chunk=C), want)


def test_fp2_batch_inv_plain_vs_jax():
    """Degree 2 on test_bm64_g2: the norm, its inversion and the conjugate
    multiply against the JAX package's Fp2Field.batch_inv_tree (16 non-zero
    lanes), and the Fp2 field's card-path call (`_batch_inv_dev`) on the
    CPU."""
    F = get_fp2_ops(get_curve("test_bm64_g2").fp2)
    a = _ints(F.p, 32, 3)
    x = F.from_int_list(list(zip(a[:16], [v or 1 for v in a[16:]])))
    want = jax_curve_ops("test_bm64_g2").F.batch_inv_tree(
        to_jax_planes(x, degree=2))
    got = FK.mont_batch_inv_plain(x, F.base.params, 2, F.nr, threads=T,
                                  chunk=C)
    assert _same2(got, want)
    assert torch.equal(F._batch_inv_dev(x), got)


@pytest.mark.parametrize("curve", ["test_bm64_g2", "bls12_381_g2"])
def test_fp2_batch_inv_plain_exact(curve):
    """Degree 2 with zero lanes, (0, c1) and (c0, 0) lanes planted: each
    lane's inverse conj(a) / (a0^2 - nr a1^2) exactly, zero for zero."""
    F = get_fp2_ops(get_curve(curve).fp2)
    p, nr = F.p, F.nr
    a = _ints(p, 26, 4, zeros=(0, 5))
    vals = list(zip(a[:13], a[13:]))
    vals[7], vals[9] = (0, 1), (2, 0)
    got = FK.mont_batch_inv_plain(F.from_int_list(vals), F.base.params, 2,
                                  nr, threads=T, chunk=C)
    want = []
    for a0, a1 in vals:
        ninv = pow(a0 * a0 - nr * a1 * a1, -1, p) if (a0, a1) != (0, 0) \
            else 0
        want.append((a0 * ninv % p, -a1 * ninv % p))
    assert F.to_int_list(got) == want


def test_level_inversion_unpadded_vs_jax():
    """One test_bm64 tree level's denominators (the pair prep of 13 lanes
    with a doubling, a cancelling and an infinite lane): the card's
    batch_inv_flat, any length with no padding, against the JAX package's
    batch_inv_flat, which pads to a power of two, and the port's CPU
    batch_inv_flat."""
    import random
    from sppark_tpu_torch.oracle.ec import get_oracle

    curve = "test_bm64"
    o = get_oracle(get_curve(curve))
    rng = random.Random(11)
    L = [o.random_point(rng) for _ in range(13)]
    R = [o.random_point(rng) for _ in range(13)]
    R[2], R[4], L[6] = L[2], o.affine_neg(L[4]), o.infinity_affine()
    ops = get_curve_ops(curve, FK.PLAIN)
    den, _ = EK.affine_pair_prep_plain(curve, ops.affine_from_ints(L),
                                       ops.affine_from_ints(R))
    got = FK.mont_batch_inv_plain(den, ops.F.params, threads=T, chunk=C)
    want = jax_batch_inv_flat(jax_curve_ops(curve).F,
                              jnp.asarray(to_jax_planes(den))[:, None, :])
    assert _same(got, want[:, 0, :])
    assert torch.equal(tree.batch_inv_flat(ops.F, den), got)


@pytest.mark.parametrize("threads,chunk", [(1, 1), (2, 5), (8, 1), (4, 7),
                                           (FK.INV_THREADS, FK.INV_CHUNK)])
def test_plain_schedule_exact(threads, chunk):
    """Any block of the plain schedule gives the exact inverses (0 -> 0):
    50 lanes, one to several blocks, ragged last chunks."""
    fp = get_field("test_bm64_fp")
    F = get_field_ops(fp)
    vals = _ints(F.p, 50, 5, zeros=(0, 17, 49))
    got = FK.mont_batch_inv_plain(F.from_int_list(vals), fp, threads=threads,
                                  chunk=chunk)
    assert F.to_int_list(got) == [pow(v, -1, F.p) if v else 0 for v in vals]


def test_up_arrays_plain():
    """inv_up_plain's arrays on the kernel's layout: lane b T C + j T + t
    holds its chunk's inclusive prefix, the thread products are each
    chunk's product, the block products each block's."""
    fp = get_field("test_bm64_fp")
    F = get_field_ops(fp)
    p = F.p
    vals = _ints(p, 29, 6, zeros=(4,))
    pre, dn, tp, blk = FK.inv_up_plain(F.from_int_list(vals), fp,
                                       threads=T, chunk=C)
    assert dn is None and tp.shape == (2, 3 * T) and blk.shape == (2, 3)
    chunk = {}
    for i, v in enumerate(vals):
        b, t = i // (T * C), i % T
        chunk[b, t] = chunk.get((b, t), 1) * (v or 1) % p
        assert F.to_int_list(pre[:, i:i + 1]) == [chunk[b, t]]
    thread = [chunk.get((b, t), 1) for b in range(3) for t in range(T)]
    assert F.to_int_list(tp) == thread
    assert F.to_int_list(blk) == [
        int(np.prod(np.array(thread[b * T:(b + 1) * T], dtype=object)) % p)
        for b in range(3)]


def test_batch_inv_wrapper_routes_and_refuses():
    """On the CPU the wrapper and the fields take the plain version and
    launch nothing; the kernels' wrappers refuse a CPU or meta tensor, a
    foreign dtype, a wrong shape and a degree or nonresidue they do not
    take, before any nvcc build (this machine has none)."""
    small = get_field("test_bm64_fp")
    F = get_field_ops(small)
    x = F.from_int_list([2, 3, 0])
    FK.reset_launches()
    assert F.to_int_list(FK.mont_batch_inv(x, small)) == [
        pow(2, -1, F.p), pow(3, -1, F.p), 0]
    assert torch.equal(F.batch_inv(x), FK.mont_batch_inv(x, small))
    assert not any(FK.launches.values())
    fp = get_field("bls12_381_fp")
    F = get_field_ops(fp)
    x = F.from_int_list([2, 3, 0])
    m = x.to("meta")
    with pytest.raises(SpparkError, match="no kernel for device cpu"):
        FK.inv_up(x, fp)
    with pytest.raises(SpparkError, match="no kernel for device meta"):
        FK.mont_batch_inv(m, fp)
    with pytest.raises(SpparkError, match="no kernel for device meta"):
        FK.inv_down(m, m, None, m, m, fp)
    with pytest.raises(TypeError, match="int32 words"):
        FK.mont_batch_inv(m.to(torch.int64), fp)
    with pytest.raises(ValueError, match="is not \\(24, ...\\) words"):
        FK.mont_batch_inv(m, fp, 2, -1)
    for degree, nr in ((2, 0), (1, -1), (3, 0)):
        with pytest.raises(ValueError, match="nonresidue"):
            FK.mont_batch_inv(x, fp, degree, nr)
    with pytest.raises(ValueError, match="power-of-two"):
        F.batch_inv_tree(torch.zeros((12, 3), dtype=torch.int32))
