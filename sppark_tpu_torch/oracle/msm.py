"""Reference MSM on Python ints (oracle).

`msm_naive` is the ground truth (double-and-add per term); `msm_pippenger`
re-implements the host bucket method (msm/pippenger.hpp:220-350) with the
signed-digit window encoding the device uses (msm/pippenger.cuh:63-117),
so the digits and bucket sums can be checked piecewise.
"""

from __future__ import annotations

from typing import List, Sequence

from ..params import CurveParams
from .ec import AffinePoint, get_oracle


def msm_naive(curve: CurveParams, points: Sequence[AffinePoint],
              scalars: Sequence[int]) -> AffinePoint:
    o = get_oracle(curve)
    acc = o.infinity_jacobian()
    for pt, k in zip(points, scalars):
        if pt.inf or k % curve.scalar.modulus == 0:
            continue
        acc = o.jacobian_add(acc, o.scalar_mul(pt, k))
    return o.jacobian_to_affine(acc)


def window_bits(npoints: int, scalar_bits: int) -> int:
    """Window policy of msm_t: wbits = lg2(n + n/2) - 8, clamped to
    [10, 18] (msm/pippenger.cuh:357-365)."""
    n = npoints + npoints // 2
    lg = max(n.bit_length() - 1, 1)
    return min(max(lg - 8, 10), 18)


def signed_digits(scalar: int, wbits: int, nwins: int,
                  order: int) -> List[int]:
    """Signed-digit decomposition of msm/pippenger.cuh:63-117.

    A scalar > order/2 is negated first (a global sign), so every digit
    magnitude fits wbits - 1 bits; a window digit d >= 2^(wbits-1) becomes
    d - 2^wbits, borrowing 1 from the next window, except in the top
    window.  Returns the signed digits."""
    neg = scalar > order // 2
    if neg:
        scalar = order - scalar
    digits = []
    carry = 0
    for w in range(nwins):
        d = ((scalar >> (w * wbits)) & ((1 << wbits) - 1)) + carry
        if d >= (1 << (wbits - 1)) and w != nwins - 1:
            d -= 1 << wbits
            carry = 1
        else:
            carry = 0
        digits.append(-d if neg else d)
    return digits


def msm_pippenger(curve: CurveParams, points: Sequence[AffinePoint],
                  scalars: Sequence[int], wbits: int = 0) -> AffinePoint:
    o = get_oracle(curve)
    order = curve.scalar.modulus
    if not points:
        return o.infinity_affine()
    if not wbits:
        wbits = window_bits(len(points), curve.scalar.bits)
    nwins = (curve.scalar.bits + wbits - 1) // wbits
    nbuckets = 1 << (wbits - 1)
    buckets = [[None] * (nbuckets + 1) for _ in range(nwins)]
    for pt, k in zip(points, scalars):
        if pt.inf:
            continue
        for w, d in enumerate(signed_digits(k % order, wbits, nwins, order)):
            if d == 0:
                continue
            q = pt if d > 0 else o.affine_neg(pt)
            cur = buckets[w][abs(d)]
            buckets[w][abs(d)] = o.xyzz_madd(
                cur if cur is not None else o.infinity_xyzz(), q)
    # integrate: sum_b b * bucket[b] by running suffix sums
    # (msm/pippenger.cuh:225-296)
    total = o.infinity_jacobian()
    for w in reversed(range(nwins)):
        for _ in range(wbits):
            total = o.jacobian_dbl(total)
        acc = o.infinity_xyzz()
        res = o.infinity_xyzz()
        for b in range(nbuckets, 0, -1):
            if buckets[w][b] is not None:
                acc = o.xyzz_add(acc, buckets[w][b])
            res = o.xyzz_add(res, acc)
        total = o.jacobian_add(total, o.xyzz_to_jacobian(res))
    return o.jacobian_to_affine(total)
