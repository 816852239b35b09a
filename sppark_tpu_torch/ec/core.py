"""G1 and G2 point arithmetic over batches of field words: the port of
sppark_tpu/ec/core.py.

A point batch is a tuple of coordinates, each `(n32, *batch)` int32 words
for G1, `(2 n32, *batch)` for G2 (an ff/ext.py:Fp2Field element, c0's
words then c1's; the ops below run unchanged on either field):

  * affine   = (x, y)          infinity encoded x == y == 0
                               (ec/affine_t.hpp:31-36)
  * xyzz     = (x, y, zz, zzz) infinity zz == 0 (ec/xyzz_t.hpp:16)
  * jacobian = (x, y, z)       infinity z == 0 (ec/jacobian_t.hpp)

Every op is branchless across lanes: the legs are evaluated and lanes
select between them.  These are the plain versions of the point kernels
(ec/kernels.py), so the select chains give the kernels' priority order
(sppark_tpu/ec/pallas_ops.py): in `xyzz_add`, q at infinity wins over p at
infinity, where the JAX package's plain add lets p win; the two differ only
in the X and Y words of a sum of two infinities, which the MSM never
forms with nonzero X or Y.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from ..ff.ext import get_fp2_ops
from ..ff.lane import get_base_ops
from ..ff.kernels import KERNELS, FieldKernels
from ..oracle.ec import AffinePoint
from ..params import CurveParams, get_curve


class CurveOps:
    """All point operations for one curve, vectorised over a batch."""

    def __init__(self, curve: CurveParams, kern: FieldKernels = KERNELS):
        self.curve = curve
        self.degree = curve.degree
        self.F = (get_base_ops(curve.field, kern) if curve.fp2 is None
                  else get_fp2_ops(curve.fp2, kern))

    def _sel(self, cond, a, b):
        return tuple(self.F.select(cond, x, y) for x, y in zip(a, b))

    # -- affine ------------------------------------------------------------------
    def affine_is_inf(self, a):
        return self.F.is_zero(a[0]) & self.F.is_zero(a[1])

    def affine_neg(self, a):
        return (a[0], self.F.neg(a[1]))

    def affine_cneg(self, a, flag):
        """Negate y on the lanes where `flag` (a (*batch) bool tensor) is
        set: the signed-digit path (ec/xyzz_t.hpp:362 `subtract`)."""
        return (a[0], self.F.select(flag, self.F.neg(a[1]), a[1]))

    def _affine_z(self, a):
        """One, or zero where a is at infinity."""
        F = self.F
        return F.select(self.affine_is_inf(a), F.zeros(a[0].shape[1:],
                                                       a[0].device),
                        F.ones(a[0].shape[1:], a[0].device))

    def affine_to_xyzz(self, a):
        z = self._affine_z(a)
        return (a[0], a[1], z, z)

    def affine_to_jacobian(self, a):
        return (a[0], a[1], self._affine_z(a))

    def affine_infinity(self, batch_shape=(), device=None):
        z = self.F.zeros(batch_shape, device)
        return (z, z)

    # -- xyzz --------------------------------------------------------------------
    def xyzz_is_inf(self, p):
        return self.F.is_zero(p[2])

    def xyzz_infinity(self, batch_shape=(), device=None):
        z = self.F.zeros(batch_shape, device)
        return (z, z, z, z)

    def _dbl_leg(self, p):
        """dbl-2008-s-1 (6M + 3S; ec/xyzz_t.hpp:111-116), M = 3X^2 +
        a4 ZZ^2, without the special cases."""
        F = self.F
        x, y, zz, zzz = p
        U = F.add(y, y)
        V = F.sqr(U)
        W = F.mul(U, V)
        S = F.mul(x, V)
        x2 = F.sqr(x)
        M = F.add(F.add(x2, x2), x2)
        if self.curve.a4:
            a = F.const(self.curve.a4, x.shape[1:], x.device)
            M = F.add(M, F.mul(a, F.sqr(zz)))
        X3 = F.sub(F.sqr(M), F.add(S, S))
        Y3 = F.sub(F.mul(M, F.sub(S, X3)), F.mul(W, y))
        return (X3, Y3, F.mul(V, zz), F.mul(W, zzz))

    def xyzz_dbl(self, p):
        """Doubling; y == 0 or zz == 0 gives infinity."""
        F = self.F
        bad = F.is_zero(p[1]) | F.is_zero(p[2])
        inf = self.xyzz_infinity(p[0].shape[1:], p[0].device)
        return self._sel(bad, inf, self._dbl_leg(p))

    def xyzz_add(self, p, q):
        """Unified add (add-2008-s, 12M + 2S; ec/xyzz_t.hpp:117-201):
        either infinity, doubling and cancellation handled per lane."""
        F = self.F
        X1, Y1, ZZ1, ZZZ1 = p
        X2, Y2, ZZ2, ZZZ2 = q
        U1 = F.mul(X1, ZZ2)
        S1 = F.mul(Y1, ZZZ2)
        P = F.sub(F.mul(X2, ZZ1), U1)
        R = F.sub(F.mul(Y2, ZZZ1), S1)
        PP = F.sqr(P)
        PPP = F.mul(P, PP)
        Q = F.mul(U1, PP)
        X3 = F.sub(F.sub(F.sqr(R), PPP), F.add(Q, Q))
        Y3 = F.sub(F.mul(R, F.sub(Q, X3)), F.mul(S1, PPP))
        ZZ3 = F.mul(F.mul(ZZ1, ZZ2), PP)
        ZZZ3 = F.mul(F.mul(ZZZ1, ZZZ2), PPP)
        same_x, same_y = F.is_zero(P), F.is_zero(R)
        out = self._sel(same_x & same_y, self.xyzz_dbl(p),
                        (X3, Y3, ZZ3, ZZZ3))
        inf = self.xyzz_infinity(X1.shape[1:], X1.device)
        out = self._sel(same_x & ~same_y, inf, out)
        out = self._sel(self.xyzz_is_inf(p), q, out)
        return self._sel(self.xyzz_is_inf(q), p, out)

    def xyzz_madd(self, p, a, sign=None):
        """Unified mixed add of affine points, the MSM bucket op
        (madd-2008-s, 8M + 2S fast leg; ec/xyzz_t.hpp:352-430).  `sign`
        (bool lanes) subtracts the point instead, for signed digits."""
        F = self.F
        ax, ay = a
        if sign is not None:
            ay = F.select(sign, F.neg(ay), ay)
            a = (ax, ay)
        X1, Y1, ZZ1, ZZZ1 = p
        P = F.sub(F.mul(ax, ZZ1), X1)
        R = F.sub(F.mul(ay, ZZZ1), Y1)
        PP = F.sqr(P)
        PPP = F.mul(P, PP)
        Q = F.mul(X1, PP)
        X3 = F.sub(F.sub(F.sqr(R), PPP), F.add(Q, Q))
        Y3 = F.sub(F.mul(R, F.sub(Q, X3)), F.mul(Y1, PPP))
        added = (X3, Y3, F.mul(ZZ1, PP), F.mul(ZZZ1, PPP))
        a_inf = self.affine_is_inf(a)
        p_inf = self.xyzz_is_inf(p)
        same_x, same_y = F.is_zero(P), F.is_zero(R)
        out = self._sel(same_x & same_y & ~p_inf & ~a_inf,
                        self.xyzz_dbl(p), added)
        inf = self.xyzz_infinity(X1.shape[1:], X1.device)
        out = self._sel(same_x & ~same_y, inf, out)
        out = self._sel(p_inf, self.affine_to_xyzz(a), out)
        return self._sel(a_inf, p, out)

    def xyzz_to_affine(self, p):
        """Batch normalisation along the last axis: ONE Montgomery-trick
        inversion over zz and zzz side by side.  Infinity lanes map to
        (0, 0)."""
        F = self.F
        x, y, zz, zzz = p
        n = zz.shape[-1]
        inv = F.batch_inv(torch.cat([zz, zzz], dim=-1))
        ax = F.mul(x, inv[..., :n])
        ay = F.mul(y, inv[..., n:])
        inf = self.xyzz_is_inf(p)
        zero = torch.zeros_like(x)
        return (F.select(inf, zero, ax), F.select(inf, zero, ay))

    def xyzz_to_jacobian(self, p):
        """Inversion-free conversion (ec/xyzz_t.hpp:87-90): Z' = zz zzz =
        z^5, so X' = x zz^4 and Y' = y zz^6."""
        F = self.F
        x, y, zz, zzz = p
        zz2 = F.sqr(zz)
        zz4 = F.sqr(zz2)
        return (F.mul(x, zz4), F.mul(y, F.mul(zz4, zz2)), F.mul(zz, zzz))

    # -- jacobian ------------------------------------------------------------------
    def jacobian_is_inf(self, p):
        return self.F.is_zero(p[2])

    def jacobian_infinity(self, batch_shape=(), device=None):
        z = self.F.zeros(batch_shape, device)
        return (z, z, z)

    def jacobian_dbl(self, p):
        """dbl-2009-l (ec/jacobian_t.hpp:347-384), with a4 where the curve
        has one; y == 0 or z == 0 gives infinity."""
        F = self.F
        x, y, z = p
        A, B = F.sqr(x), F.sqr(y)
        C = F.sqr(B)
        D = F.sub(F.sqr(F.add(x, B)), F.add(A, C))
        D = F.add(D, D)
        E = F.add(F.add(A, A), A)
        if self.curve.a4:
            a = F.const(self.curve.a4, x.shape[1:], x.device)
            E = F.add(E, F.mul(a, F.sqr(F.sqr(z))))
        X3 = F.sub(F.sqr(E), F.add(D, D))
        C8 = F.add(C, C)
        C8 = F.add(C8, C8)
        C8 = F.add(C8, C8)
        Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
        Z3 = F.mul(F.add(y, y), z)
        bad = F.is_zero(y) | F.is_zero(z)
        return (X3, Y3, F.select(bad, torch.zeros_like(z), Z3))

    def jacobian_add(self, p, q):
        """Unified add (add-2007-bl, ec/jacobian_t.hpp:236-294), the
        special cases per lane (the dadd role, ec/jacobian_t.hpp:92-151)."""
        F = self.F
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        Z1Z1, Z2Z2 = F.sqr(Z1), F.sqr(Z2)
        U1, U2 = F.mul(X1, Z2Z2), F.mul(X2, Z1Z1)
        S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
        S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
        H = F.sub(U2, U1)
        rr = F.sub(S2, S1)
        r = F.add(rr, rr)
        I = F.sqr(F.add(H, H))                          # noqa: E741
        J = F.mul(H, I)
        V = F.mul(U1, I)
        X3 = F.sub(F.sub(F.sqr(r), J), F.add(V, V))
        SJ = F.mul(S1, J)
        Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.add(SJ, SJ))
        Z3 = F.mul(F.sub(F.sqr(F.add(Z1, Z2)), F.add(Z1Z1, Z2Z2)), H)
        p_inf, q_inf = self.jacobian_is_inf(p), self.jacobian_is_inf(q)
        same_x, same_y = F.is_zero(H), F.is_zero(rr)
        out = self._sel(same_x & same_y & ~p_inf & ~q_inf,
                        self.jacobian_dbl(p), (X3, Y3, Z3))
        inf = self.jacobian_infinity(X1.shape[1:], X1.device)
        out = self._sel(same_x & ~same_y, inf, out)
        out = self._sel(q_inf, p, out)
        return self._sel(p_inf, q, out)

    def jacobian_to_affine(self, p):
        """Batch normalisation along the last axis (one batch inversion of
        z); infinity lanes map to (0, 0)."""
        F = self.F
        x, y, z = p
        zi = F.batch_inv(z)
        zi2 = F.sqr(zi)
        ax, ay = F.mul(x, zi2), F.mul(y, F.mul(zi2, zi))
        inf = self.jacobian_is_inf(p)
        zero = torch.zeros_like(x)
        return (F.select(inf, zero, ax), F.select(inf, zero, ay))

    # -- scalar multiplication -------------------------------------------------------
    def scalar_mul(self, a, k: int):
        """k a for every affine lane of a and one host constant k, by
        double and add over xyzz points (a utility of the tests; the MSM
        is the production route).  Returns xyzz points."""
        k %= self.curve.scalar.modulus
        acc = self.xyzz_infinity(a[0].shape[1:], a[0].device)
        addj = self.affine_to_xyzz(a)
        while k:
            if k & 1:
                acc = self.xyzz_add(acc, addj)
            k >>= 1
            if k:
                addj = self.xyzz_dbl(addj)
        return acc

    # -- host conversion -------------------------------------------------------------
    def affine_from_ints(self, pts: Sequence[AffinePoint], device=None):
        """Oracle AffinePoints (or (x, y, inf) records) -> (x, y) words; a
        G2 coordinate is a (c0, c1) pair of ints."""
        zero = (0, 0) if self.degree == 2 else 0
        xs = [zero if getattr(p, "inf", False) else p.x for p in pts]
        ys = [zero if getattr(p, "inf", False) else p.y for p in pts]
        return (self.F.from_int_list(xs, device=device),
                self.F.from_int_list(ys, device=device))

    def affine_to_ints(self, a) -> List[tuple]:
        return list(zip(self.F.to_int_list(a[0]), self.F.to_int_list(a[1])))

    def coord_bytes(self) -> int:
        return 4 * self.F.words

    def affine_from_wire(self, x_words=None, y_words=None, buf=None,
                         ffi_affine_sz: int = 0, device=None):
        """Wire ingestion of an affine batch, the strided FFI upload
        (msm/pippenger.cuh:379, 501-503) with the Affine_inf_t layout
        (ec/affine_t.hpp:75-122).

        Either (n, n32) u32 word arrays per coordinate ((n, 2 n32) for G2,
        c0 || c1), in Montgomery form, or a flat byte `buf` with per-point
        stride `ffi_affine_sz` holding x || y [|| inf]; points whose inf
        byte is set become (0, 0)."""
        if buf is not None:
            raw = np.frombuffer(np.ascontiguousarray(buf), dtype=np.uint8)
            cb = self.coord_bytes()
            sz = ffi_affine_sz or 2 * cb
            if sz < 2 * cb or len(raw) % sz:
                raise ValueError(f"buffer length {len(raw)} is not a "
                                 f"multiple of the point stride {sz} "
                                 f"(coordinate bytes {cb})")
            pts = raw.reshape(-1, sz)
            x_words = np.ascontiguousarray(pts[:, :cb]).view(np.uint32)
            y_words = np.ascontiguousarray(pts[:, cb:2 * cb]).view(np.uint32)
            if sz > 2 * cb:
                inf = pts[:, 2 * cb] != 0
                x_words = np.where(inf[:, None], 0, x_words).astype(np.uint32)
                y_words = np.where(inf[:, None], 0, y_words).astype(np.uint32)
        return (self.F.from_wire_np(x_words, device),
                self.F.from_wire_np(y_words, device))

    def affine_to_wire(self, a):
        """(x, y) words -> ((n, n32), (n, n32)) wire word arrays ((n,
        2 n32) for G2)."""
        return self.F.to_wire_np(a[0]), self.F.to_wire_np(a[1])


@functools.lru_cache(maxsize=None)
def get_curve_ops(name: str, kern: FieldKernels = KERNELS) -> CurveOps:
    return CurveOps(get_curve(name), kern)
