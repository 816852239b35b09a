"""Big-int reference G1 and G2 arithmetic (oracle).

The semantics of sppark's ec/affine_t.hpp, ec/jacobian_t.hpp and
ec/xyzz_t.hpp on Python ints (G1) or (c0, c1) int pairs (G2, over
oracle.field.Fp2): the same code serves both, through the coordinate
field's ops:
  - affine infinity encoded as X == Y == 0 (ec/affine_t.hpp:31-36)
  - jacobian infinity Z == 0 (ec/jacobian_t.hpp:16)
  - xyzz infinity ZZ == 0 (ec/xyzz_t.hpp:16)
with the EFD formulas the reference cites: add-2007-bl and dbl-2009-l for
jacobian, add-2008-s, madd-2008-s and dbl-2008-s-1 for xyzz.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Optional

from ..params import CurveParams
from .field import Fp2, Fr

Coord = Any     # an int (G1) or a (c0, c1) pair of ints (G2)


@dataclass
class AffinePoint:
    x: Coord
    y: Coord
    inf: bool = False


@dataclass
class JacobianPoint:
    x: Coord
    y: Coord
    z: Coord


@dataclass
class XyzzPoint:
    x: Coord
    y: Coord
    zz: Coord
    zzz: Coord


class CurveOracle:
    """Exact reference implementation for one G1 or G2 curve."""

    def __init__(self, curve: CurveParams):
        self.curve = curve
        p = curve.field.modulus
        if curve.fp2 is None:
            self.F = Fr(curve.field)
            self.zero, self.one, self.b = 0, 1, curve.b % p
        else:
            self.F = Fp2(curve.fp2)
            self.zero, self.one = (0, 0), (1, 0)
            self.b = (curve.b % p, curve.b_c1 % p)

    def _is_zero(self, a) -> bool:
        if self.curve.fp2 is not None:
            return self.F.is_zero(a)
        return a % self.F.p == 0

    # -- constructors -----------------------------------------------------
    def infinity_affine(self) -> AffinePoint:
        return AffinePoint(self.zero, self.zero, True)

    def infinity_jacobian(self) -> JacobianPoint:
        z = self.zero
        return JacobianPoint(z, z, z)

    def infinity_xyzz(self) -> XyzzPoint:
        z = self.zero
        return XyzzPoint(z, z, z, z)

    def on_curve(self, p: AffinePoint) -> bool:
        """y^2 == x^3 + a4 x + b; infinity is on every curve."""
        if p.inf:
            return True
        F = self.F
        rhs = F.add(F.mul(F.sqr(p.x), p.x), self.b)
        if self.curve.a4:
            rhs = F.add(rhs, F.mul(p.x, self.curve.a4))
        return F.sqr(p.y) == rhs

    # -- conversions -------------------------------------------------------
    def to_jacobian(self, p: AffinePoint) -> JacobianPoint:
        if p.inf:
            return self.infinity_jacobian()
        return JacobianPoint(p.x, p.y, self.one)

    def to_xyzz(self, p: AffinePoint) -> XyzzPoint:
        if p.inf:
            return self.infinity_xyzz()
        return XyzzPoint(p.x, p.y, self.one, self.one)

    def jacobian_to_affine(self, p: JacobianPoint) -> AffinePoint:
        F = self.F
        if self._is_zero(p.z):
            return self.infinity_affine()
        zi = F.inv(p.z)
        zi2 = F.sqr(zi)
        return AffinePoint(F.mul(p.x, zi2), F.mul(p.y, F.mul(zi2, zi)), False)

    def xyzz_to_affine(self, p: XyzzPoint) -> AffinePoint:
        F = self.F
        if self._is_zero(p.zz):
            return self.infinity_affine()
        return AffinePoint(F.mul(p.x, F.inv(p.zz)), F.mul(p.y, F.inv(p.zzz)),
                           False)

    def xyzz_to_jacobian(self, p: XyzzPoint) -> JacobianPoint:
        return self.to_jacobian(self.xyzz_to_affine(p))

    # -- jacobian group law -------------------------------------------------
    def jacobian_dbl(self, p: JacobianPoint) -> JacobianPoint:
        F = self.F
        if self._is_zero(p.z) or self._is_zero(p.y):
            return self.infinity_jacobian()
        # dbl-2009-l with M = 3X^2 + a*Z^4
        A = F.sqr(p.x)
        B = F.sqr(p.y)
        C = F.sqr(B)
        D = F.sub(F.sqr(F.add(p.x, B)), F.add(A, C))
        D = F.add(D, D)
        E = F.add(F.add(A, A), A)
        if self.curve.a4:
            E = F.add(E, F.mul(F.sqr(F.sqr(p.z)), self.curve.a4))
        X3 = F.sub(F.sqr(E), F.add(D, D))
        C8 = F.add(F.add(C, C), F.add(C, C))
        C8 = F.add(C8, C8)
        Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
        Z3 = F.mul(F.add(p.y, p.y), p.z)
        return JacobianPoint(X3, Y3, Z3)

    def jacobian_add(self, p: JacobianPoint,
                     q: JacobianPoint) -> JacobianPoint:
        F = self.F
        if self._is_zero(p.z):
            return q
        if self._is_zero(q.z):
            return p
        # add-2007-bl (ec/jacobian_t.hpp:236-294)
        Z1Z1 = F.sqr(p.z)
        Z2Z2 = F.sqr(q.z)
        U1 = F.mul(p.x, Z2Z2)
        U2 = F.mul(q.x, Z1Z1)
        S1 = F.mul(F.mul(p.y, q.z), Z2Z2)
        S2 = F.mul(F.mul(q.y, p.z), Z1Z1)
        if U1 == U2 and S1 == S2:
            return self.jacobian_dbl(p)
        H = F.sub(U2, U1)
        if self._is_zero(H):
            return self.infinity_jacobian()
        I = F.sqr(F.add(H, H))
        J = F.mul(H, I)
        r = F.add(F.sub(S2, S1), F.sub(S2, S1))
        V = F.mul(U1, I)
        X3 = F.sub(F.sub(F.sqr(r), J), F.add(V, V))
        Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.add(F.mul(S1, J), F.mul(S1, J)))
        Z3 = F.mul(F.sub(F.sqr(F.add(p.z, q.z)), F.add(Z1Z1, Z2Z2)), H)
        return JacobianPoint(X3, Y3, Z3)

    # -- xyzz group law ------------------------------------------------------
    def xyzz_dbl(self, p: XyzzPoint) -> XyzzPoint:
        F = self.F
        if self._is_zero(p.zz) or self._is_zero(p.y):
            return self.infinity_xyzz()
        # dbl-2008-s-1, M = 3X^2 + a*ZZ^2
        U = F.add(p.y, p.y)
        V = F.sqr(U)
        W = F.mul(U, V)
        S = F.mul(p.x, V)
        M = F.mul(F.sqr(p.x), 3)
        if self.curve.a4:
            M = F.add(M, F.mul(F.sqr(p.zz), self.curve.a4))
        X3 = F.sub(F.sqr(M), F.add(S, S))
        Y3 = F.sub(F.mul(M, F.sub(S, X3)), F.mul(W, p.y))
        return XyzzPoint(X3, Y3, F.mul(V, p.zz), F.mul(W, p.zzz))

    def xyzz_add(self, p: XyzzPoint, q: XyzzPoint) -> XyzzPoint:
        F = self.F
        if self._is_zero(p.zz):
            return q
        if self._is_zero(q.zz):
            return p
        # add-2008-s (ec/xyzz_t.hpp:117-201)
        U1 = F.mul(p.x, q.zz)
        U2 = F.mul(q.x, p.zz)
        S1 = F.mul(p.y, q.zzz)
        S2 = F.mul(q.y, p.zzz)
        P = F.sub(U2, U1)
        R = F.sub(S2, S1)
        if self._is_zero(P):
            return self.xyzz_dbl(p) if self._is_zero(R) \
                else self.infinity_xyzz()
        PP = F.sqr(P)
        PPP = F.mul(P, PP)
        Q = F.mul(U1, PP)
        X3 = F.sub(F.sub(F.sqr(R), PPP), F.add(Q, Q))
        Y3 = F.sub(F.mul(R, F.sub(Q, X3)), F.mul(S1, PPP))
        ZZ3 = F.mul(F.mul(p.zz, q.zz), PP)
        ZZZ3 = F.mul(F.mul(p.zzz, q.zzz), PPP)
        return XyzzPoint(X3, Y3, ZZ3, ZZZ3)

    def xyzz_madd(self, p: XyzzPoint, a: AffinePoint,
                  subtract: bool = False) -> XyzzPoint:
        """Mixed add of an affine point, or with `subtract` of its
        negation: the MSM bucket op (ec/xyzz_t.hpp:352-430)."""
        F = self.F
        if a.inf:
            return p
        ay = F.neg(a.y) if subtract else a.y
        if self._is_zero(p.zz):
            return XyzzPoint(a.x, ay, self.one, self.one)
        U2 = F.mul(a.x, p.zz)
        S2 = F.mul(ay, p.zzz)
        P = F.sub(U2, p.x)
        R = F.sub(S2, p.y)
        if self._is_zero(P):
            return self.xyzz_dbl(p) if self._is_zero(R) \
                else self.infinity_xyzz()
        PP = F.sqr(P)
        PPP = F.mul(P, PP)
        Q = F.mul(p.x, PP)
        X3 = F.sub(F.sub(F.sqr(R), PPP), F.add(Q, Q))
        Y3 = F.sub(F.mul(R, F.sub(Q, X3)), F.mul(p.y, PPP))
        return XyzzPoint(X3, Y3, F.mul(p.zz, PP), F.mul(p.zzz, PPP))

    # -- scalar multiplication ------------------------------------------------
    def scalar_mul(self, p: AffinePoint, k: int) -> JacobianPoint:
        return self._int_mul(p, k % self.curve.scalar.modulus)

    def _int_mul(self, p: AffinePoint, k: int) -> JacobianPoint:
        """k*P for a plain integer k (no reduction mod the scalar order)."""
        acc = self.infinity_jacobian()
        addend = self.to_jacobian(p)
        while k:
            if k & 1:
                acc = self.jacobian_add(acc, addend)
            addend = self.jacobian_dbl(addend)
            k >>= 1
        return acc

    def affine_neg(self, p: AffinePoint) -> AffinePoint:
        if p.inf:
            return p
        return AffinePoint(p.x, self.F.neg(p.y), False)

    def affine_eq(self, p: AffinePoint, q: AffinePoint) -> bool:
        if p.inf or q.inf:
            return p.inf == q.inf
        return p.x == q.x and p.y == q.y

    # -- point sampling ---------------------------------------------------------
    def random_point(self, rng: random.Random) -> AffinePoint:
        """A random point of the prime-order subgroup (cofactor cleared).
        It draws from `rng` as the JAX package's oracle does, so one seed
        gives both packages the same points."""
        p = self.curve.field.modulus
        if self.curve.fp2 is not None:
            raw = self._random_fp2_point(rng)
        else:
            while True:
                x = rng.randrange(p)
                y = _sqrt_mod((x * x * x + self.curve.a4 * x + self.curve.b)
                              % p, p)
                if y is not None:
                    if rng.randrange(2):
                        y = (-y) % p
                    break
            raw = AffinePoint(x, y, False)
        if self.curve.cofactor == 1:
            return raw
        return self.jacobian_to_affine(self._int_mul(raw, self.curve.cofactor))

    def _random_fp2_point(self, rng: random.Random) -> AffinePoint:
        """A point of E(F_p^2) from a random x whose x^3 + b is a square."""
        F = self.F
        p = self.curve.field.modulus
        for _ in range(10000):
            x = (rng.randrange(p), rng.randrange(p))
            y = _sqrt_fp2(F.add(F.mul(F.sqr(x), x), self.b), p, F.nr)
            if y is not None:
                return AffinePoint(x, y, False)
        raise RuntimeError(f"{self.curve.name}: no point found")


def _sqrt_mod(a: int, p: int) -> Optional[int]:
    """Tonelli-Shanks square root mod prime p, or None for a non-residue."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r = t * c % p, r * b % p
    return r


def _sqrt_fp2(a, p: int, nr: int):
    """A square root in F_p[u]/(u^2 - nr) through the norm, or None."""
    c0, c1 = a[0] % p, a[1] % p
    if c0 == 0 and c1 == 0:
        return (0, 0)
    alpha = _sqrt_mod((c0 * c0 - nr * c1 * c1) % p, p)
    if alpha is None:
        return None
    inv2 = pow(2, -1, p)
    for sign in (1, -1):
        x0 = _sqrt_mod((c0 + sign * alpha) % p * inv2 % p, p)
        if x0 is None or x0 == 0:
            continue
        x1 = c1 * inv2 % p * pow(x0, -1, p) % p
        if ((x0 * x0 + nr * x1 * x1) % p, 2 * x0 * x1 % p) == (c0, c1):
            return (x0, x1)
    return None


_ORACLES: dict = {}


def get_oracle(curve: CurveParams) -> CurveOracle:
    if curve.name not in _ORACLES:
        _ORACLES[curve.name] = CurveOracle(curve)
    return _ORACLES[curve.name]


def curve_generator(curve: CurveParams,
                    rng: Optional[random.Random] = None) -> AffinePoint:
    """A point of the curve's subgroup (random; deterministic given rng)."""
    return get_oracle(curve).random_point(rng or random.Random(42))
