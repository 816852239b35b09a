"""The frozen operation and byte counts against hand counts at small lg,
and the madd count against the program's own signed digits."""

import random

import pytest
import torch

from benchmark.core import roofline as R


@pytest.mark.parametrize("lg,butterflies,products", [
    (1, 1, 0), (2, 4, 1), (3, 12, 5), (4, 32, 17)])
def test_transform_ops_by_hand(lg, butterflies, products):
    # butterflies (n/2) lg; products by twiddles other than w^0 = 1
    assert R.transform_ops(lg, 1, 12, 8) == butterflies * 8 + products * 12
    assert R.transform_ops(lg, 3, 12, 8) == 3 * R.transform_ops(lg, 1, 12, 8)


def test_point_and_field_counts():
    assert R.prod_ops(12) == 576 and R.prod_ops(8) == 256
    assert R.sqr_ops(12) == 3 * 144 + 12
    assert R.madd_ops(12) == 8 * 576 + 2 * 444 == 5496


def test_transform_work_by_hand():
    gl = {"ops_per_mul": 12, "ops_add_sub": 8, "word_bytes": 8}
    assert R.transform_work(gl, 3, 0) == (12 * 8 + 5 * 12, 2 * 8 * 8)
    ops, nbytes = R.transform_work(gl, 2, 2)
    assert ops == (4 * 8 + 1 * 12) + (32 * 8 + 17 * 12)
    assert nbytes == 8 * (4 + 16)


def test_bound_picks_the_larger():
    ms, by = R.bound_ms(3.35e12, 0)
    assert by == "bytes" and ms == pytest.approx(1e3)
    ms, by = R.bound_ms(0, R.INT32_OPS_PER_S / 2)
    assert by == "operations" and ms == pytest.approx(500)
    assert R.INT32_OPS_PER_S == pytest.approx(1.6727e13, rel=1e-4)


@pytest.mark.parametrize("wbits", [4, 10, 16])
def test_msm_madds_match_signed_digits(wbits):
    from sppark_tpu_torch.oracle.msm import signed_digits
    from sppark_tpu_torch.params import get_curve

    r = get_curve("bls12_381").scalar.modulus
    rng = random.Random(wbits)
    scalars = [rng.randrange(r) for _ in range(200)] + [0, 1, r - 1,
                                                        r // 2, r // 2 + 1]
    words = torch.tensor([[(s >> (32 * i)) & 0xFFFFFFFF for s in scalars]
                          for i in range(8)], dtype=torch.int64).to(
        torch.int32)
    nwins = (r.bit_length() + wbits - 1) // wbits
    want = sum(d != 0 for i, s in enumerate(scalars) if i != 3
               for d in signed_digits(s, wbits, nwins, r))
    assert R.msm_madds(words, r, wbits, skip=[3]) == want


def test_msm_madds_skip_every_period():
    """Infinity at base index 1 of a base of 4 tiled to 12 points: points
    1, 5 and 9 need no madd."""
    words = torch.zeros((8, 12), dtype=torch.int32)
    words[0] = 1                            # one nonzero digit each
    assert R.msm_madds(words, 2 ** 255 - 19, 16) == 12
    assert R.msm_madds(words, 2 ** 255 - 19, 16, skip=[1], period=4) == 9
    assert R.msm_madds(words, 2 ** 255 - 19, 16, skip=[1, 3]) == 10
