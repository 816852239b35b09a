"""Plain short-Weierstrass arithmetic (y^2 = x^3 + b over F_p, a = 0) on
Python ints, and the multi-scalar multiplication it checks the program
against.

Points are Jacobian triples (X, Y, Z), Z = 0 at infinity, or affine pairs
(x, y) with None for infinity.  The formulas are the Explicit-Formulas
Database's dbl-2009-l, madd-2007-bl and add-2007-bl, each with its special
cases (doubling, cancellation, infinity).  `msm` is a Pippenger bucket sum
with unsigned windows: it shares nothing with the program's signed-digit
schedule.  `random_points` draws uniform points of the r-torsion: x
uniform until x^3 + b is a square, y its square root (Tonelli-Shanks),
then the cofactor cleared by the curve's h_eff.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

Affine = Optional[Tuple[int, int]]
Jacobian = Tuple[int, int, int]

INF: Jacobian = (1, 1, 0)


def sqrt_mod(a: int, p: int) -> Optional[int]:
    """A square root of a mod the odd prime p, or None: a^((p + 1) / 4)
    where p = 3 mod 4, else Tonelli-Shanks."""
    a %= p
    if p % 4 == 3:
        y = pow(a, (p + 1) // 4, p)
        return y if y * y % p == a else None
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    q, s = p - 1, 0
    while q % 2 == 0:
        q, s = q // 2, s + 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, x = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2, i = t2 * t2 % p, i + 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, x = i, b * b % p, t * b * b % p, x * b % p
    return x


class Curve:
    def __init__(self, p: int, b: int, r: int, h_eff: int):
        self.p, self.b, self.r, self.h_eff = p, b, r, h_eff

    # -- group law -----------------------------------------------------------------
    def dbl(self, P: Jacobian) -> Jacobian:
        X, Y, Z = P
        p = self.p
        if Z == 0 or Y == 0:
            return INF
        A = X * X % p
        B = Y * Y % p
        C = B * B % p
        D = 2 * ((X + B) * (X + B) - A - C) % p
        E = 3 * A % p
        F = E * E % p
        X3 = (F - 2 * D) % p
        Y3 = (E * (D - X3) - 8 * C) % p
        Z3 = 2 * Y * Z % p
        return X3, Y3, Z3

    def madd(self, P: Jacobian, Q: Affine) -> Jacobian:
        """P + Q, Q affine."""
        if Q is None:
            return P
        X1, Y1, Z1 = P
        x2, y2 = Q
        p = self.p
        if Z1 == 0:
            return x2, y2, 1
        Z1Z1 = Z1 * Z1 % p
        U2 = x2 * Z1Z1 % p
        S2 = y2 * Z1 * Z1Z1 % p
        H = (U2 - X1) % p
        r = 2 * (S2 - Y1) % p
        if H == 0:
            return self.dbl(P) if r == 0 else INF
        HH = H * H % p
        I = 4 * HH % p
        J = H * I % p
        V = X1 * I % p
        X3 = (r * r - J - 2 * V) % p
        Y3 = (r * (V - X3) - 2 * Y1 * J) % p
        Z3 = ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % p
        return X3, Y3, Z3

    def add(self, P: Jacobian, Q: Jacobian) -> Jacobian:
        if P[2] == 0:
            return Q
        if Q[2] == 0:
            return P
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        p = self.p
        Z1Z1 = Z1 * Z1 % p
        Z2Z2 = Z2 * Z2 % p
        U1 = X1 * Z2Z2 % p
        U2 = X2 * Z1Z1 % p
        S1 = Y1 * Z2 * Z2Z2 % p
        S2 = Y2 * Z1 * Z1Z1 % p
        H = (U2 - U1) % p
        r = 2 * (S2 - S1) % p
        if H == 0:
            return self.dbl(P) if r == 0 else INF
        I = 4 * H * H % p
        J = H * I % p
        V = U1 * I % p
        X3 = (r * r - J - 2 * V) % p
        Y3 = (r * (V - X3) - 2 * S1 * J) % p
        Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % p
        return X3, Y3, Z3

    def to_affine(self, P: Jacobian) -> Affine:
        X, Y, Z = P
        if Z == 0:
            return None
        p = self.p
        zi = pow(Z, -1, p)
        zi2 = zi * zi % p
        return X * zi2 % p, Y * zi2 * zi % p

    def mul(self, P: Jacobian, k: int) -> Jacobian:
        """k P by double-and-add, most significant bit first."""
        acc = INF
        for bit in bin(k)[2:] if k > 0 else "":
            acc = self.dbl(acc)
            if bit == "1":
                acc = self.add(acc, P)
        return acc

    def on_curve(self, Q: Affine) -> bool:
        if Q is None:
            return True
        x, y = Q
        return (y * y - x * x * x - self.b) % self.p == 0

    # -- inputs --------------------------------------------------------------------
    def random_points(self, rng: random.Random, n: int) -> List[Affine]:
        """n uniform points of the r-torsion."""
        p = self.p
        out = []
        while len(out) < n:
            x = rng.randrange(p)
            y = sqrt_mod(x * x * x + self.b, p)
            if y is None:
                continue
            if rng.getrandbits(1):
                y = p - y
            out.append(self.to_affine(self.mul((x, y, 1), self.h_eff)))
        return out

    # -- the reference MSM ---------------------------------------------------------
    def msm(self, points: Sequence[Affine], scalars: Sequence[int],
            c: int = 8) -> Affine:
        """sum_i scalars[i] points[i] by c-bit unsigned windows."""
        scalars = [s % self.r for s in scalars]
        nbits = max((s.bit_length() for s in scalars), default=0)
        acc = INF
        mask = (1 << c) - 1
        for w in reversed(range((nbits + c - 1) // c)):
            for _ in range(c):
                acc = self.dbl(acc)
            buckets: List[Jacobian] = [INF] * (1 << c)
            for P, s in zip(points, scalars):
                d = (s >> (w * c)) & mask
                if d and P is not None:
                    buckets[d] = self.madd(buckets[d], P)
            run = tot = INF
            for d in range(mask, 0, -1):
                run = self.add(run, buckets[d])
                tot = self.add(tot, run)
            acc = self.add(acc, tot)
        return self.to_affine(acc)
