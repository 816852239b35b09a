"""Reference NTT / LDE on Python ints: exact math to hold the tensors and
kernels against, with no dependency beyond the field parameters.

Semantics (sppark ntt/ntt.cuh):
  - forward NTT:  y_k = sum_j x_j * w^(j*k),  w = root_of_unity(lg_n)
  - inverse NTT:  x_j = (1/n) * sum_k y_k * w^(-j*k)
  - orders NN/NR/RN/RR: R is bit-reversed index order on that side
  - coset NTT twists inputs by g^j before the forward transform; coset iNTT
    untwists by g^-j after the inverse
  - LDE: iNTT the n evaluations, zero-extend the coefficients to
    n << blowup, coset-twist, forward NTT.
"""

from __future__ import annotations

from typing import List, Sequence

from ..params import FieldParams


def bit_reverse(v: Sequence[int], lg_n: int) -> List[int]:
    n = 1 << lg_n
    assert len(v) == n
    out = [0] * n
    for i in range(n):
        r = int(format(i, f"0{lg_n}b")[::-1], 2) if lg_n else 0
        out[r] = v[i]
    return out


def ntt_natural(field: FieldParams, v: Sequence[int],
                inverse: bool = False) -> List[int]:
    """Natural-order forward/inverse NTT (iterative radix-2 CT)."""
    n = len(v)
    lg_n = n.bit_length() - 1
    assert 1 << lg_n == n
    p = field.modulus
    w = field.inv_root_of_unity(lg_n) if inverse else field.root_of_unity(lg_n)
    a = bit_reverse([x % p for x in v], lg_n)
    m = 1
    for _ in range(lg_n):
        wm = pow(w, n // (2 * m), p)
        for k in range(0, n, 2 * m):
            t = 1
            for j in range(m):
                u = a[k + j]
                x = a[k + j + m] * t % p
                a[k + j] = (u + x) % p
                a[k + j + m] = (u - x) % p
                t = t * wm % p
        m *= 2
    if inverse:
        ninv = field.domain_size_inverse(lg_n)
        a = [x * ninv % p for x in a]
    return a


def intt_natural(field: FieldParams, v: Sequence[int]) -> List[int]:
    return ntt_natural(field, v, inverse=True)


def coset_ntt(field: FieldParams, v: Sequence[int],
              inverse: bool = False) -> List[int]:
    """Coset NTT: evaluate over g*H instead of H."""
    p = field.modulus
    g = field.generator
    if not inverse:
        tw = 1
        twisted = []
        for x in v:
            twisted.append(x * tw % p)
            tw = tw * g % p
        return ntt_natural(field, twisted)
    out = ntt_natural(field, v, inverse=True)
    gi = pow(g, p - 2, p)
    tw = 1
    for j in range(len(v)):
        out[j] = out[j] * tw % p
        tw = tw * gi % p
    return out


def coset_intt(field: FieldParams, v: Sequence[int]) -> List[int]:
    return coset_ntt(field, v, inverse=True)


def lde(field: FieldParams, v: Sequence[int], lg_blowup: int) -> List[int]:
    """Values on H (size n) -> values on the coset g*H' (size n << blowup)."""
    coeffs = ntt_natural(field, v, inverse=True)
    ext = list(coeffs) + [0] * ((len(v) << lg_blowup) - len(v))
    return coset_ntt(field, ext)


def apply_order(field: FieldParams, v: Sequence[int], lg_n: int,
                order: str, inverse: bool = False) -> List[int]:
    """Full NTT honouring an order string in {NN, NR, RN, RR}."""
    x = list(v)
    if order[0] == "R":
        x = bit_reverse(x, lg_n)
    y = ntt_natural(field, x, inverse=inverse)
    if order[1] == "R":
        y = bit_reverse(y, lg_n)
    return y
