"""Big-int reference G1 arithmetic (oracle).

The semantics of sppark's ec/affine_t.hpp, ec/jacobian_t.hpp and
ec/xyzz_t.hpp on Python ints:
  - affine infinity encoded as X == Y == 0 (ec/affine_t.hpp:31-36)
  - jacobian infinity Z == 0 (ec/jacobian_t.hpp:16)
  - xyzz infinity ZZ == 0 (ec/xyzz_t.hpp:16)
with the EFD formulas the reference cites: add-2007-bl and dbl-2009-l for
jacobian, add-2008-s, madd-2008-s and dbl-2008-s-1 for xyzz.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional

from ..params import CurveParams
from .field import Fr


@dataclass
class AffinePoint:
    x: int
    y: int
    inf: bool = False


@dataclass
class JacobianPoint:
    x: int
    y: int
    z: int


@dataclass
class XyzzPoint:
    x: int
    y: int
    zz: int
    zzz: int


class CurveOracle:
    """Exact reference implementation for one G1 curve."""

    def __init__(self, curve: CurveParams):
        self.curve = curve
        self.F = Fr(curve.field)

    # -- constructors -----------------------------------------------------
    def infinity_affine(self) -> AffinePoint:
        return AffinePoint(0, 0, True)

    def infinity_jacobian(self) -> JacobianPoint:
        return JacobianPoint(0, 0, 0)

    def infinity_xyzz(self) -> XyzzPoint:
        return XyzzPoint(0, 0, 0, 0)

    # -- conversions -------------------------------------------------------
    def to_jacobian(self, p: AffinePoint) -> JacobianPoint:
        if p.inf:
            return self.infinity_jacobian()
        return JacobianPoint(p.x, p.y, 1)

    def jacobian_to_affine(self, p: JacobianPoint) -> AffinePoint:
        F = self.F
        if p.z % F.p == 0:
            return self.infinity_affine()
        zi = F.inv(p.z)
        zi2 = F.sqr(zi)
        return AffinePoint(F.mul(p.x, zi2), F.mul(p.y, F.mul(zi2, zi)), False)

    def xyzz_to_affine(self, p: XyzzPoint) -> AffinePoint:
        F = self.F
        if p.zz % F.p == 0:
            return self.infinity_affine()
        return AffinePoint(F.mul(p.x, F.inv(p.zz)), F.mul(p.y, F.inv(p.zzz)),
                           False)

    def xyzz_to_jacobian(self, p: XyzzPoint) -> JacobianPoint:
        return self.to_jacobian(self.xyzz_to_affine(p))

    # -- jacobian group law -------------------------------------------------
    def jacobian_dbl(self, p: JacobianPoint) -> JacobianPoint:
        F = self.F
        if p.z % F.p == 0 or p.y % F.p == 0:
            return self.infinity_jacobian()
        # dbl-2009-l with M = 3X^2 + a*Z^4
        A = F.sqr(p.x)
        B = F.sqr(p.y)
        C = F.sqr(B)
        D = F.sub(F.sqr(F.add(p.x, B)), F.add(A, C))
        D = F.add(D, D)
        E = F.add(F.add(A, A), A)
        if self.curve.a4:
            E = F.add(E, F.mul(self.curve.a4, F.sqr(F.sqr(p.z))))
        X3 = F.sub(F.sqr(E), F.add(D, D))
        C8 = F.add(F.add(C, C), F.add(C, C))
        C8 = F.add(C8, C8)
        Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
        Z3 = F.mul(F.add(p.y, p.y), p.z)
        return JacobianPoint(X3, Y3, Z3)

    def jacobian_add(self, p: JacobianPoint,
                     q: JacobianPoint) -> JacobianPoint:
        F = self.F
        if p.z % F.p == 0:
            return q
        if q.z % F.p == 0:
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
        if H == 0:
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
        if p.zz % F.p == 0 or p.y % F.p == 0:
            return self.infinity_xyzz()
        # dbl-2008-s-1, M = 3X^2 + a*ZZ^2
        U = F.add(p.y, p.y)
        V = F.sqr(U)
        W = F.mul(U, V)
        S = F.mul(p.x, V)
        M = F.mul(F.sqr(p.x), 3)
        if self.curve.a4:
            M = F.add(M, F.mul(self.curve.a4, F.sqr(p.zz)))
        X3 = F.sub(F.sqr(M), F.add(S, S))
        Y3 = F.sub(F.mul(M, F.sub(S, X3)), F.mul(W, p.y))
        return XyzzPoint(X3, Y3, F.mul(V, p.zz), F.mul(W, p.zzz))

    def xyzz_add(self, p: XyzzPoint, q: XyzzPoint) -> XyzzPoint:
        F = self.F
        if p.zz % F.p == 0:
            return q
        if q.zz % F.p == 0:
            return p
        # add-2008-s (ec/xyzz_t.hpp:117-201)
        U1 = F.mul(p.x, q.zz)
        U2 = F.mul(q.x, p.zz)
        S1 = F.mul(p.y, q.zzz)
        S2 = F.mul(q.y, p.zzz)
        P = F.sub(U2, U1)
        R = F.sub(S2, S1)
        if P == 0:
            return self.xyzz_dbl(p) if R == 0 else self.infinity_xyzz()
        PP = F.sqr(P)
        PPP = F.mul(P, PP)
        Q = F.mul(U1, PP)
        X3 = F.sub(F.sub(F.sqr(R), PPP), F.add(Q, Q))
        Y3 = F.sub(F.mul(R, F.sub(Q, X3)), F.mul(S1, PPP))
        ZZ3 = F.mul(F.mul(p.zz, q.zz), PP)
        ZZZ3 = F.mul(F.mul(p.zzz, q.zzz), PPP)
        return XyzzPoint(X3, Y3, ZZ3, ZZZ3)

    def xyzz_madd(self, p: XyzzPoint, a: AffinePoint) -> XyzzPoint:
        """Mixed add of an affine point: the MSM bucket op
        (ec/xyzz_t.hpp:352-430)."""
        F = self.F
        if a.inf:
            return p
        if p.zz % F.p == 0:
            return XyzzPoint(a.x, a.y, 1, 1)
        U2 = F.mul(a.x, p.zz)
        S2 = F.mul(a.y, p.zzz)
        P = F.sub(U2, p.x)
        R = F.sub(S2, p.y)
        if P == 0:
            return self.xyzz_dbl(p) if R == 0 else self.infinity_xyzz()
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

    # -- point sampling ---------------------------------------------------------
    def random_point(self, rng: random.Random) -> AffinePoint:
        """A random point of the prime-order subgroup (cofactor cleared)."""
        p = self.curve.field.modulus
        while True:
            x = rng.randrange(p)
            y = _sqrt_mod((x * x * x + self.curve.a4 * x + self.curve.b) % p,
                          p)
            if y is not None:
                if rng.randrange(2):
                    y = (-y) % p
                break
        raw = AffinePoint(x, y, False)
        if self.curve.cofactor == 1:
            return raw
        return self.jacobian_to_affine(self._int_mul(raw, self.curve.cofactor))


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


_ORACLES: dict = {}


def get_oracle(curve: CurveParams) -> CurveOracle:
    if curve.name not in _ORACLES:
        _ORACLES[curve.name] = CurveOracle(curve)
    return _ORACLES[curve.name]


def curve_generator(curve: CurveParams,
                    rng: Optional[random.Random] = None) -> AffinePoint:
    """A point of the curve's subgroup (random; deterministic given rng)."""
    return get_oracle(curve).random_point(rng or random.Random(42))
