// The carry-chain Montgomery element, mont::FpCC<N>: the element of the G1
// point kernels but the pair prep (ec_xyzz.cu, ec_pair.cu), beside
// mont::Fp<N> of mont.cuh with the same overloads (add, sub, mul, sqr, dot,
// is_zero, select, Elem<>), so xyzz.cuh's formulas take it unchanged; and
// its quadratic extensions, the lane pair Fp2PairCC<N> (the fp2 doubling,
// ec_fp2_dbl.cu) and the one-thread Fp2CC<N>, on mont.cuh's fp2 formulas.
// The constants are mont.cuh's Consts<N>.
//
// Its products run on PTX carry chains, as the reference's mont_t
// (ff/mont_t.cuh:381-423, mad_n_redc): mad.lo.cc / madc.hi.cc, which
// ptxas fuses into one IMAD.WIDE.U32.X per 32x32 product, and no 64-bit
// sums, where mont::Fp carries in the top half of 64-bit sums (about three
// instructions a product: IMAD.WIDE, IMAD.X, IADD3):
//   mul, N >= 4: CIOS with each row split into its even and odd columns,
//        two chains that do not wait on each other, merged once at the
//        end.  Each half stays within N words only while p < 2^(32 N - 1):
//        every N >= 4 field of the port has that spare bit (BN254, Pasta,
//        BLS12-381, BLS12-377), and the launch refuses one without it;
//   sqr, N >= 4: the off-diagonal products once, on the same even / odd
//        chains, doubled by funnel shifts, plus the diagonal; then the
//        Montgomery reduction of the low half on the two chains, plus the
//        high half;
//   dot, a b + x y with one reduction: both products' rows on sqr's
//        chains, then sqr's reduction (below, with its bounds);
//   N = 2 (test_bm64's p = 2^64 - 59 and the Goldilocks prime of
//        test_bm64_g2, no spare bit): one chain over N + 2 words of state,
//        and sqr is mul(a, a);
//   add, sub and the final subtraction: chains and a mask, no branch.
// Every op takes canonical inputs (< p) and returns canonical output, so the
// words a kernel stores equal mont::Fp's and the TPU kernels' exactly.
//
// The carry primitives (namespace cc) are csrc/carry.cuh's: PTX on the
// card, an explicit flag on a host compiler, so the arithmetic can be
// checked without a card.

#pragma once

#include "carry.cuh"
#include "mont.cuh"

namespace mont {

namespace cc {

using namespace ::cc;

// -- the rows of the even / odd CIOS (N even, N >= 4) ---------------------
//
// A row's state is two N-word halves: `even` at weight 1 and `odd` at
// weight 2^32 (value even + 2^32 odd).  The products a_j b of even j land
// in `even` as (lo, hi) pairs at words (j, j + 1), those of odd j in `odd`
// at the same words less one: within a half no two pairs overlap, so each
// half is one chain.  `a` below walks every other word of an operand.

// acc = a[0, 2, ..] * b: no carries
template <int N>
CC_HD void mul_n(uint32_t* acc, const uint32_t* a, uint32_t b) {
#pragma unroll
    for (int j = 0; j < N; j += 2) {
        acc[j] = a[j] * b;
        acc[j + 1] = mul_hi(a[j], b);
    }
}

// acc += a[0, 2, ..] * b, one chain; its carry out is left in the flag
template <int N>
CC_HD void cmad_n(uint32_t* acc, const uint32_t* a, uint32_t b) {
    acc[0] = mad_lo_cc(a[0], b, acc[0]);
    acc[1] = madc_hi_cc(a[0], b, acc[1]);
#pragma unroll
    for (int j = 2; j < N; j += 2) {
        acc[j] = madc_lo_cc(a[j], b, acc[j]);
        acc[j + 1] = madc_hi_cc(a[j], b, acc[j + 1]);
    }
}

// odd = (odd >> 2 words) + a[0, 2, ..] * b + the flag
template <int N>
CC_HD void madc_n_rshift(uint32_t* odd, const uint32_t* a, uint32_t b) {
#pragma unroll
    for (int j = 0; j < N - 2; j += 2) {
        odd[j] = madc_lo_cc(a[j], b, odd[j + 2]);
        odd[j + 1] = madc_hi_cc(a[j], b, odd[j + 3]);
    }
    odd[N - 2] = madc_lo_cc(a[N - 2], b, 0);
    odd[N - 1] = madc_hi(a[N - 2], b, 0);
}

// One CIOS row: (state + a b + m p) / 2^32, m = -state_0 p^-1 mod 2^32.
// The halves trade places each row: the caller passes (even, odd), then
// (odd, even).  With a == nullptr the row adds no product (a reduction
// row).  On the first row `even` holds the starting value (or nothing,
// with a product) and `odd` nothing.
template <int N>
CC_HD void cios_row(uint32_t* even, uint32_t* odd, const uint32_t* a,
                    uint32_t b, const Consts<N>& c, bool first) {
    uint32_t m;
    if (first) {
        if (a) {
            mul_n<N>(odd, a + 1, b);
            mul_n<N>(even, a, b);
        }
        m = even[0] * c.m0;
        if (a) {
            cmad_n<N>(odd, c.p + 1, m);
        } else {
            mul_n<N>(odd, c.p + 1, m);
        }
    } else {
        // the previous row's state over 2^32: its odd half, plus word 1 of
        // its even half in word 0 here, the rest of it in this row's odd
        // half, shifted down with the odd products
        even[0] = add_cc(even[0], odd[1]);
        if (a) {
            madc_n_rshift<N>(odd, a + 1, b);
            cmad_n<N>(even, a, b);
            odd[N - 1] = addc(odd[N - 1], 0);
            m = even[0] * c.m0;
            cmad_n<N>(odd, c.p + 1, m);
        } else {
            m = even[0] * c.m0;
            madc_n_rshift<N>(odd, c.p + 1, m);
        }
    }
    cmad_n<N>(even, c.p, m);
    odd[N - 1] = addc(odd[N - 1], 0);
}

// After the last row (odd, even): the state over 2^32, even + (odd >> 32),
// in `even`; below 2^(32 N) by the spare bit.
template <int N>
CC_HD void merge(uint32_t* even, const uint32_t* odd) {
    even[0] = add_cc(even[0], odd[1]);
#pragma unroll
    for (int i = 1; i < N - 1; i++) even[i] = addc_cc(even[i], odd[i + 1]);
    even[N - 1] = addc(even[N - 1], 0);
}

// The Montgomery reduction of a 2N-word w (N >= 4): (w_lo + m p) / R <= p
// by N reduction rows on the even / odd chains, plus w_hi, in w's low N
// words, which it returns; the caller's bound on w_hi keeps the sum within
// N words.
template <int N>
CC_HD uint32_t* redc_wide(uint32_t* w, const Consts<N>& c) {
    uint32_t* even = w;
    uint32_t odd[N];
#pragma unroll
    for (int i = 0; i < N; i += 2) {
        cios_row<N>(even, odd, nullptr, 0, c, i == 0);
        cios_row<N>(odd, even, nullptr, 0, c, false);
    }
    merge<N>(even, odd);
    even[0] = add_cc(even[0], w[N]);
#pragma unroll
    for (int i = 1; i < N - 1; i++) even[i] = addc_cc(even[i], w[N + i]);
    even[N - 1] = addc(even[N - 1], w[2 * N - 1]);
    return even;
}

}  // namespace cc

template <int N>
struct FpCC {
    uint32_t w[N];
};

// A launch's check of the host constants [p, ...] (make_consts): the
// products at n32 >= 4 need a spare bit, p < 2^(32 n32 - 1).
inline bool spare_bit(int n32, const uint32_t* consts) {
    return n32 < 4 || consts[n32 - 1] >> 31 == 0;
}

// The final conditional subtraction: t (N words, and `top`, the bit above
// them) < 2p -> t mod p.  t - p is kept unless it borrowed past `top`.
template <int N>
CC_HD FpCC<N> final_sub(const uint32_t* t, uint32_t top, const Consts<N>& c) {
    FpCC<N> d;
    d.w[0] = cc::sub_cc(t[0], c.p[0]);
#pragma unroll
    for (int i = 1; i < N; i++) d.w[i] = cc::subc_cc(t[i], c.p[i]);
    // top - borrow: 0 where t >= p (or top), all ones where t < p
    uint32_t keep = cc::subc(top, 0);
#pragma unroll
    for (int i = 0; i < N; i++) d.w[i] = (t[i] & keep) | (d.w[i] & ~keep);
    return d;
}

template <int N>
CC_HD bool is_zero(const FpCC<N>& a) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < N; i++) acc |= a.w[i];
    return acc == 0;
}

template <int N>
CC_HD FpCC<N> select(bool s, const FpCC<N>& a, const FpCC<N>& b) {
    FpCC<N> r;
#pragma unroll
    for (int i = 0; i < N; i++) r.w[i] = s ? a.w[i] : b.w[i];
    return r;
}

template <int N>
CC_HD FpCC<N> add(const FpCC<N>& a, const FpCC<N>& b, const Consts<N>& c) {
    uint32_t s[N];
    s[0] = cc::add_cc(a.w[0], b.w[0]);
#pragma unroll
    for (int i = 1; i < N - 1; i++) s[i] = cc::addc_cc(a.w[i], b.w[i]);
    if constexpr (N >= 4) {     // a + b < 2p < 2^(32 N): no carry out
        s[N - 1] = cc::addc(a.w[N - 1], b.w[N - 1]);
        return final_sub<N>(s, 0, c);
    } else {
        s[N - 1] = cc::addc_cc(a.w[N - 1], b.w[N - 1]);
        return final_sub<N>(s, cc::addc(0, 0), c);
    }
}

template <int N>
CC_HD FpCC<N> sub(const FpCC<N>& a, const FpCC<N>& b, const Consts<N>& c) {
    FpCC<N> d;
    d.w[0] = cc::sub_cc(a.w[0], b.w[0]);
#pragma unroll
    for (int i = 1; i < N; i++) d.w[i] = cc::subc_cc(a.w[i], b.w[i]);
    // all ones on a borrow: add p back
    uint32_t mask = cc::subc(0, 0);
    d.w[0] = cc::add_cc(d.w[0], c.p[0] & mask);
#pragma unroll
    for (int i = 1; i < N - 1; i++)
        d.w[i] = cc::addc_cc(d.w[i], c.p[i] & mask);
    d.w[N - 1] = cc::addc(d.w[N - 1], c.p[N - 1] & mask);
    return d;
}

// a * b * R^-1 mod p.
template <int N>
CC_HD FpCC<N> mul(const FpCC<N>& a, const FpCC<N>& b, const Consts<N>& c) {
    if constexpr (N >= 4) {
        uint32_t even[N], odd[N];
#pragma unroll
        for (int i = 0; i < N; i += 2) {
            cc::cios_row<N>(even, odd, a.w, b.w[i], c, i == 0);
            cc::cios_row<N>(odd, even, a.w, b.w[i + 1], c, false);
        }
        cc::merge<N>(even, odd);
        return final_sub<N>(even, 0, c);
    } else {
        // one chain over N + 2 words: each row t += a b_i (the low halves,
        // then the high halves), then t = (t + m p) / 2^32 the same way
        uint32_t t[N + 2];
#pragma unroll
        for (int i = 0; i < N + 2; i++) t[i] = 0;
#pragma unroll
        for (int i = 0; i < 2 * N; i++) {
            bool red = i & 1;
            const uint32_t* x = red ? c.p : a.w;
            uint32_t y = red ? t[0] * c.m0 : b.w[i / 2];
            t[0] = cc::mad_lo_cc(x[0], y, t[0]);
#pragma unroll
            for (int j = 1; j < N; j++) t[j] = cc::madc_lo_cc(x[j], y, t[j]);
            t[N] = cc::addc_cc(t[N], 0);
            t[N + 1] = cc::addc(t[N + 1], 0);
            t[1] = cc::mad_hi_cc(x[0], y, t[1]);
#pragma unroll
            for (int j = 1; j < N; j++)
                t[j + 1] = cc::madc_hi_cc(x[j], y, t[j + 1]);
            t[N + 1] = cc::addc(t[N + 1], 0);
            if (red) {          // word 0 is now 0
#pragma unroll
                for (int j = 0; j <= N; j++) t[j] = t[j + 1];
                t[N + 1] = 0;
            }
        }
        return final_sub<N>(t, t[N], c);
    }
}

// a^2 * R^-1 mod p.
template <int N>
CC_HD FpCC<N> sqr(const FpCC<N>& a, const Consts<N>& c) {
    if constexpr (N >= 4) {
        // off-diagonal a_i a_j, i < j: a pair at words (i + j, i + j + 1),
        // into `ev` for even i + j and `od` for odd, one chain a row in each.
        // A row's carry out lands on a word that holds at most the previous
        // row's carry bit.
        uint32_t ev[2 * N], od[2 * N];
#pragma unroll
        for (int k = 0; k < 2 * N; k++) ev[k] = od[k] = 0;
#pragma unroll
        for (int i = 0; i < N - 1; i++) {
#pragma unroll
            for (int half = 0; half < 2; half++) {
                uint32_t* t = half ? ev : od;
                int j0 = i + 1 + half;
                if (j0 > N - 1) continue;
                t[i + j0] = cc::mad_lo_cc(a.w[i], a.w[j0], t[i + j0]);
                t[i + j0 + 1] = cc::madc_hi_cc(a.w[i], a.w[j0],
                                               t[i + j0 + 1]);
                int j = j0 + 2;
#pragma unroll
                for (; j < N; j += 2) {
                    t[i + j] = cc::madc_lo_cc(a.w[i], a.w[j], t[i + j]);
                    t[i + j + 1] = cc::madc_hi_cc(a.w[i], a.w[j],
                                                  t[i + j + 1]);
                }
                t[i + j] = cc::addc(t[i + j], 0);
            }
        }
        // w = 2 (ev + od) + the diagonal a_i^2 (ev[0..1] and od[0] are 0)
        uint32_t w[2 * N];
        w[0] = 0;
        w[1] = od[1];
        w[2] = cc::add_cc(ev[2], od[2]);
#pragma unroll
        for (int k = 3; k < 2 * N - 1; k++) w[k] = cc::addc_cc(ev[k], od[k]);
        w[2 * N - 1] = cc::addc(ev[2 * N - 1], od[2 * N - 1]);
#pragma unroll
        for (int k = 2 * N - 1; k > 0; k--)
            w[k] = (w[k] << 1) | (w[k - 1] >> 31);
        w[0] = cc::mad_lo_cc(a.w[0], a.w[0], 0);
        w[1] = cc::madc_hi_cc(a.w[0], a.w[0], w[1]);
#pragma unroll
        for (int i = 1; i < N - 1; i++) {
            w[2 * i] = cc::madc_lo_cc(a.w[i], a.w[i], w[2 * i]);
            w[2 * i + 1] = cc::madc_hi_cc(a.w[i], a.w[i], w[2 * i + 1]);
        }
        w[2 * N - 2] = cc::madc_lo_cc(a.w[N - 1], a.w[N - 1], w[2 * N - 2]);
        w[2 * N - 1] = cc::madc_hi(a.w[N - 1], a.w[N - 1], w[2 * N - 1]);
        // (w_lo + m p) / R <= p, then + w_hi < p^2 / R: below 2p
        return final_sub<N>(cc::redc_wide<N>(w, c), 0, c);
    } else {
        return mul(a, a, c);
    }
}

// (a b + x y) R^-1 mod p with ONE Montgomery reduction (mont.cuh's dot, the
// reference's dot_product, ff/mont_t.cuh:697-719): the fp2 lane pair's
// product.
//   N >= 4: the two products' 2N-word sum w on the even / odd chains of
//        sqr's off-diagonal rows, then sqr's reduction.  With the spare
//        bit, a, b, x, y < p < R / 2 give w <= 2 (p - 1)^2 < R^2 / 2: no
//        chain's partial sum, and no half, leaves 2N words, and w_hi =
//        floor(w / R) < 2 p^2 / R < p, so (w_lo + m p) / R + w_hi <= p +
//        p - 1 < 2p and one final subtraction ends it;
//   N = 2 (no spare bit): one chain over N + 2 words, each row adding a
//        b_i and x y_i before its reduction.  The state stays below 3p:
//        (t + a b_i + x y_i + m p) / 2^32 < (3p + 3p (2^32 - 1)) / 2^32 =
//        3p < 2^66, within N + 2 words, so p is subtracted once where it
//        fits, then the final subtraction, as mont.cuh's dot does.
template <int N>
CC_HD FpCC<N> dot(const FpCC<N>& a, const FpCC<N>& b, const FpCC<N>& x,
                  const FpCC<N>& y, const Consts<N>& c) {
    if constexpr (N >= 4) {
        // a_i b_j at words (i + j, i + j + 1): into `ev` for even i + j,
        // `od` for odd, one chain a row in each; x y's row i right after a
        // b's.  A row's carry lands above its chain, on a word that holds
        // at most the carries of the rows before it (row i's chains end
        // at the word below the largest i + j of their parity plus one,
        // which no earlier row's chain reaches); past word 2N - 1 it is 0.
        uint32_t ev[2 * N], od[2 * N];
#pragma unroll
        for (int k = 0; k < 2 * N; k++) ev[k] = od[k] = 0;
#pragma unroll
        for (int i = 0; i < N; i++) {
#pragma unroll
            for (int prod = 0; prod < 2; prod++) {
                const uint32_t* u = prod ? x.w : a.w;
                const uint32_t* v = prod ? y.w : b.w;
#pragma unroll
                for (int j0 = 0; j0 < 2; j0++) {
                    uint32_t* t = (i + j0) % 2 ? od : ev;
                    t[i + j0] = cc::mad_lo_cc(u[i], v[j0], t[i + j0]);
                    t[i + j0 + 1] = cc::madc_hi_cc(u[i], v[j0],
                                                   t[i + j0 + 1]);
                    int j = j0 + 2;
#pragma unroll
                    for (; j < N; j += 2) {
                        t[i + j] = cc::madc_lo_cc(u[i], v[j], t[i + j]);
                        t[i + j + 1] = cc::madc_hi_cc(u[i], v[j],
                                                      t[i + j + 1]);
                    }
                    if (i + j < 2 * N) t[i + j] = cc::addc(t[i + j], 0);
                }
            }
        }
        // w = ev + od (od[0] is 0)
        uint32_t w[2 * N];
        w[0] = ev[0];
        w[1] = cc::add_cc(ev[1], od[1]);
#pragma unroll
        for (int k = 2; k < 2 * N - 1; k++) w[k] = cc::addc_cc(ev[k], od[k]);
        w[2 * N - 1] = cc::addc(ev[2 * N - 1], od[2 * N - 1]);
        return final_sub<N>(cc::redc_wide<N>(w, c), 0, c);
    } else {
        uint32_t t[N + 2];
#pragma unroll
        for (int i = 0; i < N + 2; i++) t[i] = 0;
#pragma unroll
        for (int i = 0; i < 3 * N; i++) {
            // rows a b_k, x y_k, then the reduction, for k = i / 3
            int step = i % 3;
            const uint32_t* u = step == 0 ? a.w : step == 1 ? x.w : c.p;
            uint32_t v = step == 0 ? b.w[i / 3]
                         : step == 1 ? y.w[i / 3] : t[0] * c.m0;
            t[0] = cc::mad_lo_cc(u[0], v, t[0]);
#pragma unroll
            for (int j = 1; j < N; j++) t[j] = cc::madc_lo_cc(u[j], v, t[j]);
            t[N] = cc::addc_cc(t[N], 0);
            t[N + 1] = cc::addc(t[N + 1], 0);
            t[1] = cc::mad_hi_cc(u[0], v, t[1]);
#pragma unroll
            for (int j = 1; j < N; j++)
                t[j + 1] = cc::madc_hi_cc(u[j], v, t[j + 1]);
            t[N + 1] = cc::addc(t[N + 1], 0);
            if (step == 2) {    // word 0 is now 0
#pragma unroll
                for (int j = 0; j <= N; j++) t[j] = t[j + 1];
                t[N + 1] = 0;
            }
        }
        // t (t[N] the word above) < 3p: t - p where it does not borrow
        uint32_t d[N];
        d[0] = cc::sub_cc(t[0], c.p[0]);
#pragma unroll
        for (int i = 1; i < N; i++) d[i] = cc::subc_cc(t[i], c.p[i]);
        uint32_t top = cc::subc(t[N], 0);      // all ones where t < p
        uint32_t keep = (uint32_t)((int32_t)top >> 31);
#pragma unroll
        for (int i = 0; i < N; i++) d[i] = (t[i] & keep) | (d[i] & ~keep);
        return final_sub<N>(d, top & ~keep, c);
    }
}

template <int N>
struct Elem<FpCC<N>> {
    static constexpr int BASE = N, THREADS = 1, WORDS = N;
    static CC_HD FpCC<N> zero() {
        FpCC<N> r;
#pragma unroll
        for (int i = 0; i < N; i++) r.w[i] = 0;
        return r;
    }
    static CC_HD FpCC<N> embed(const uint32_t* w) {
        FpCC<N> r;
#pragma unroll
        for (int i = 0; i < N; i++) r.w[i] = w[i];
        return r;
    }
};

// -- the quadratic extension over FpCC --------------------------------------

// One thread a lane, both coefficients (mont.cuh's Fp2 on this element).
template <int N>
struct Fp2CC {
    FpCC<N> c0, c1;
};

template <int N>
CC_HD bool is_zero(const Fp2CC<N>& a) {
    return is_zero(a.c0) && is_zero(a.c1);
}

template <int N>
CC_HD Fp2CC<N> select(bool s, const Fp2CC<N>& a, const Fp2CC<N>& b) {
    return Fp2CC<N>{select(s, a.c0, b.c0), select(s, a.c1, b.c1)};
}

template <int N>
CC_HD Fp2CC<N> add(const Fp2CC<N>& a, const Fp2CC<N>& b, const Consts<N>& c) {
    return Fp2CC<N>{add(a.c0, b.c0, c), add(a.c1, b.c1, c)};
}

template <int N>
CC_HD Fp2CC<N> sub(const Fp2CC<N>& a, const Fp2CC<N>& b, const Consts<N>& c) {
    return Fp2CC<N>{sub(a.c0, b.c0, c), sub(a.c1, b.c1, c)};
}

template <int N>
CC_HD Fp2CC<N> mul(const Fp2CC<N>& a, const Fp2CC<N>& b, const Consts<N>& c) {
    Fp2CC<N> r;
    fp2_mul(a.c0, a.c1, b.c0, b.c1, r.c0, r.c1, c);
    return r;
}

template <int N>
CC_HD Fp2CC<N> sqr(const Fp2CC<N>& a, const Consts<N>& c) {
    Fp2CC<N> r;
    fp2_sqr(a.c0, a.c1, r.c0, r.c1, c);
    return r;
}

template <int N>
struct Elem<Fp2CC<N>> {
    static constexpr int BASE = N, THREADS = 1, WORDS = 2 * N;
    static CC_HD Fp2CC<N> zero() {
        return Fp2CC<N>{Elem<FpCC<N>>::zero(), Elem<FpCC<N>>::zero()};
    }
    static CC_HD Fp2CC<N> embed(const uint32_t* w) {
        return Fp2CC<N>{Elem<FpCC<N>>::embed(w), Elem<FpCC<N>>::zero()};
    }
};

// The lane pair on the carry chains (mont.cuh's Fp2Pair on this element,
// the fp2 doubling's): thread 2i holds c0 of lane i, thread 2i + 1 holds
// c1.  A product is one carry-chain dot a thread (pair_mul), a square one
// carry-chain product (pair_sqr_prod); the zero test reads both
// coefficients, so every branch on it is pair-uniform.
#ifdef __CUDACC__
template <int N>
struct Fp2PairCC {
    FpCC<N> v;      // c0 on the even thread of the pair, c1 on the odd
};

template <int N>
MONT_D bool is_zero(const Fp2PairCC<N>& a) {
    uint32_t z = is_zero(a.v);
    return z & pair_swap(z);
}

template <int N>
MONT_D Fp2PairCC<N> select(bool s, const Fp2PairCC<N>& a,
                           const Fp2PairCC<N>& b) {
    return Fp2PairCC<N>{select(s, a.v, b.v)};
}

template <int N>
MONT_D Fp2PairCC<N> add(const Fp2PairCC<N>& a, const Fp2PairCC<N>& b,
                        const Consts<N>& c) {
    return Fp2PairCC<N>{add(a.v, b.v, c)};
}

template <int N>
MONT_D Fp2PairCC<N> sub(const Fp2PairCC<N>& a, const Fp2PairCC<N>& b,
                        const Consts<N>& c) {
    return Fp2PairCC<N>{sub(a.v, b.v, c)};
}

template <int N>
MONT_D Fp2PairCC<N> mul(const Fp2PairCC<N>& a, const Fp2PairCC<N>& b,
                        const Consts<N>& c) {
    return Fp2PairCC<N>{pair_mul(pair_odd(), a.v, partner(a.v), b.v,
                                 partner(b.v), c)};
}

template <int N>
MONT_D Fp2PairCC<N> sqr(const Fp2PairCC<N>& a, const Consts<N>& c) {
    bool odd = pair_odd();
    FpCC<N> m = pair_sqr_prod(odd, a.v, partner(a.v), c);
    return Fp2PairCC<N>{pair_sqr(odd, m, partner(m), c)};
}

template <int N>
struct Elem<Fp2PairCC<N>> {
    static constexpr int BASE = N, THREADS = 2, WORDS = 2 * N;
    static MONT_D Fp2PairCC<N> zero() {
        return Fp2PairCC<N>{Elem<FpCC<N>>::zero()};
    }
    static MONT_D Fp2PairCC<N> embed(const uint32_t* w) {
        return Fp2PairCC<N>{select(pair_odd(), Elem<FpCC<N>>::zero(),
                                   Elem<FpCC<N>>::embed(w))};
    }
};
#endif  // __CUDACC__

}  // namespace mont
