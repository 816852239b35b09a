// xyzz point formulas for the kernels of ec_xyzz.cu and ec_fp2_*.cu
// (the role of sppark's ec/xyzz_t.hpp), one point per thread (or per lane
// pair of threads), every coordinate in registers.  One text serves G1 and
// G2: the formulas are templates over the coordinate's element type E,
// mont::FpCC<N> (G1), mont::Fp2<N> (the G2 dbl) or mont::Fp2Pair<N> (the
// G2 madd and add), whose ops are the overloads of mont.cuh and
// mont_cc.cuh.
//
// A point is (X, Y, ZZ, ZZZ) with x = X/ZZ, y = Y/ZZZ; infinity is ZZ == 0.
// Each function gives, word for word, the result of the TPU kernel's select
// chain (sppark_tpu/ec/pallas_ops.py): the special cases are per-lane
// branches taken in the same priority order, and the fast leg and the
// doubling leg are the same formulas on the same canonical values.  For
// fp2 every zero test reads both coefficients, as the TPU kernel's
// _KCtx.is_zero does.  A lane that doubles runs the doubling leg instead
// of the fast leg; a warp that holds such a lane runs both, one after the
// other.  The TPU kernel gates the doubling leg per block instead
// (pl.when(any(dbl))).

#pragma once

#include "mont.cuh"

namespace xyzz {

using mont::Consts;

template <class E>
struct Point {
    E x, y, zz, zzz;
};

template <class E>
MONT_HD Point<E> infinity() {
    E z = mont::Elem<E>::zero();
    return Point<E>{z, z, z, z};
}

// dbl-2008-s-1 (6M + 3S, ec/xyzz_t.hpp:111-116) with M = 3X^2 + a4 ZZ^2,
// for a point with ZZ != 0; Y == 0 doubles to infinity.
template <class E, int N>
MONT_HD Point<E> dbl_leg(const Point<E>& p, const Consts<N>& c) {
    using namespace mont;
    if (is_zero(p.y)) return infinity<E>();
    E U = add(p.y, p.y, c);
    E V = sqr(U, c);
    E W = mul(U, V, c);
    E S = mul(p.x, V, c);
    E x2 = sqr(p.x, c);
    E M = add(add(x2, x2, c), x2, c);
    E a4 = Elem<E>::embed(c.a4);
    if (!is_zero(a4)) M = add(M, mul(a4, sqr(p.zz, c), c), c);
    Point<E> r;
    r.x = sub(sqr(M, c), add(S, S, c), c);
    r.y = sub(mul(M, sub(S, r.x, c), c), mul(W, p.y, c), c);
    r.zz = mul(V, p.zz, c);
    r.zzz = mul(W, p.zzz, c);
    return r;
}

// Doubling (the port of _dbl_call): Y == 0 or ZZ == 0 gives infinity.
template <class E, int N>
MONT_HD Point<E> dbl(const Point<E>& p, const Consts<N>& c) {
    if (mont::is_zero(p.zz)) return infinity<E>();
    return dbl_leg(p, c);
}

// p + q, add-2008-s (12M + 2S, ec/xyzz_t.hpp:117-201) (the port of
// _add_call).  Priority, as in the TPU kernel: q infinite -> p; p infinite
// -> q; equal points -> doubling leg; opposite points -> infinity.
template <class E, int N>
MONT_HD Point<E> add(const Point<E>& p, const Point<E>& q,
                     const Consts<N>& c) {
    using namespace mont;
    if (is_zero(q.zz)) return p;
    if (is_zero(p.zz)) return q;
    E U1 = mul(p.x, q.zz, c);
    E S1 = mul(p.y, q.zzz, c);
    E P = sub(mul(q.x, p.zz, c), U1, c);
    E R = sub(mul(q.y, p.zzz, c), S1, c);
    if (is_zero(P)) return is_zero(R) ? dbl_leg(p, c) : infinity<E>();
    E PP = sqr(P, c);
    E PPP = mul(P, PP, c);
    E Q = mul(U1, PP, c);
    Point<E> r;
    r.x = sub(sub(sqr(R, c), PPP, c), add(Q, Q, c), c);
    r.y = sub(mul(R, sub(Q, r.x, c), c), mul(S1, PPP, c), c);
    r.zz = mul(mul(p.zz, q.zz, c), PP, c);
    r.zzz = mul(mul(p.zzz, q.zzz, c), PPP, c);
    return r;
}

// p + (ax, ay), madd-2008-s (8M + 2S, ec/xyzz_t.hpp:352-430) (the port of
// _madd_call, the MSM bucket op).  Priority, as in the TPU kernel: the
// affine point infinite (0, 0) -> p; p infinite (an empty bucket) ->
// (ax, ay, 1, 1); equal points -> doubling leg; opposite -> infinity.
template <class E, int N>
MONT_HD Point<E> madd(const Point<E>& p, const E& ax, const E& ay,
                      const Consts<N>& c) {
    using namespace mont;
    if (is_zero(ax) && is_zero(ay)) return p;
    if (is_zero(p.zz)) {
        E one = Elem<E>::embed(c.one);
        return Point<E>{ax, ay, one, one};
    }
    E P = sub(mul(ax, p.zz, c), p.x, c);
    E R = sub(mul(ay, p.zzz, c), p.y, c);
    if (is_zero(P)) return is_zero(R) ? dbl_leg(p, c) : infinity<E>();
    E PP = sqr(P, c);
    E PPP = mul(P, PP, c);
    E Q = mul(p.x, PP, c);
    Point<E> r;
    r.x = sub(sub(sqr(R, c), PPP, c), add(Q, Q, c), c);
    r.y = sub(mul(R, sub(Q, r.x, c), c), mul(p.y, PPP, c), c);
    r.zz = mul(p.zz, PP, c);
    r.zzz = mul(p.zzz, PPP, c);
    return r;
}

}  // namespace xyzz
