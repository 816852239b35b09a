"""The port's batch_addition (sppark_tpu_torch/msm/batch_addition.py)
against the JAX package's (sppark_tpu/msm/batch_addition.py) and the
oracle on the CPU, where the point kernels take their plain versions:
tests/test_batch_addition.py's three cases on test_gl64 (bitmap and
refmap with an infinity planted, every point, an empty selection) and a
G2 one on test_gl64_g2, then, against the oracle, test_gl64_g2,
test_bm64_g2 and test_bm64 with device words as input, the lane counts K
(which change nothing: the affine sum is unique) and n not a multiple of
K.  Points are compared as exact ints.  ~40 s serial by pytest's count,
most of it the JAX package's compiles (its G2 case ~15 s).
"""

import random

import pytest

from sppark_tpu.msm import batch_addition as jax_batch_addition
from sppark_tpu_torch.ec import get_curve_ops
from sppark_tpu_torch.ec import kernels as EK
from sppark_tpu_torch.msm import batch_addition
from sppark_tpu_torch.oracle.ec import AffinePoint, get_oracle
from sppark_tpu_torch.params import get_curve

CURVE = "test_gl64"


def _oracle_sum(o, pts, bits, refs):
    acc = o.infinity_xyzz()
    for p, b, r in zip(pts, bits, refs):
        if b:
            acc = o.xyzz_madd(acc, o.affine_neg(p) if r else p)
    return o.xyzz_to_affine(acc)


def _key(p):
    return (p.x, p.y, p.inf)


def test_batch_addition_bitmap_refmap(rng):
    o = get_oracle(get_curve(CURVE))
    n = 32
    pts = [o.random_point(rng) for _ in range(n)]
    pts[3] = AffinePoint(0, 0, True)
    bits = [rng.randrange(2) for _ in range(n)]
    refs = [rng.randrange(2) for _ in range(n)]
    got = batch_addition(CURVE, pts, bits, refs, lanes=8, device="cpu")
    want = _oracle_sum(o, pts, bits, refs)
    assert _key(got) == _key(want)
    assert _key(jax_batch_addition(CURVE, pts, bits, refs, lanes=8)) == \
        _key(got)


def test_batch_addition_all(rng):
    o = get_oracle(get_curve(CURVE))
    pts = [o.random_point(rng) for _ in range(16)]
    got = batch_addition(CURVE, pts, device="cpu")
    want = _oracle_sum(o, pts, [1] * 16, [0] * 16)
    assert _key(got) == _key(want)
    assert _key(jax_batch_addition(CURVE, pts)) == _key(got)


def test_batch_addition_empty_selection(rng):
    o = get_oracle(get_curve(CURVE))
    pts = [o.random_point(rng) for _ in range(8)]
    got = batch_addition(CURVE, pts, [0] * 8, device="cpu")
    assert got.inf and _key(got) == _key(o.infinity_affine())
    assert _key(jax_batch_addition(CURVE, pts, [0] * 8)) == _key(got)


def test_batch_addition_g2_vs_jax():
    curve = "test_gl64_g2"
    o = get_oracle(get_curve(curve))
    rng = random.Random(3)
    pts = [o.random_point(rng) for _ in range(8)]
    pts[2] = o.infinity_affine()
    bits, refs = [1, 0, 1, 1, 0, 1, 1, 1], [0, 1, 0, 0, 0, 1, 0, 0]
    got = batch_addition(curve, pts, bits, refs, lanes=4, device="cpu")
    assert _key(got) == _key(_oracle_sum(o, pts, bits, refs))
    assert _key(jax_batch_addition(curve, pts, bits, refs, lanes=4)) == \
        _key(got)


@pytest.mark.parametrize("curve", ["test_gl64_g2", "test_bm64_g2",
                                   "test_bm64"])
def test_batch_addition_words_and_lanes(curve):
    """Device words in, every lane count from 1 to past n (n = 21 is no
    multiple of most), a doubling and a cancelling pair selected."""
    cp = get_curve(curve)
    o = get_oracle(cp)
    rng = random.Random(curve)
    n = 21
    pts = [o.random_point(rng) for _ in range(n)]
    pts[3] = o.infinity_affine()
    pts[5] = pts[4]
    pts[7] = o.affine_neg(pts[6])
    bits = [rng.randrange(2) for _ in range(n)]
    refs = [rng.randrange(2) for _ in range(n)]
    bits[4:8] = [1] * 4
    refs[4:8] = [0] * 4
    want = _oracle_sum(o, pts, bits, refs)
    words = get_curve_ops(curve, EK.PLAIN.field).affine_from_ints(pts)
    for lanes in (0, 1, 4, 7, 21, 32):
        got = batch_addition(curve, words, bits, refs, lanes=lanes)
        assert _key(got) == _key(want), lanes
    assert _key(batch_addition(curve, pts, device="cpu")) == _key(
        _oracle_sum(o, pts, [1] * n, [0] * n))
