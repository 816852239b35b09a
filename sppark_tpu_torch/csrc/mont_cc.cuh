// The carry-chain Montgomery element, mont::FpCC<N>: the element of the G1
// point madd and add (ec_xyzz.cu), beside mont::Fp<N> of mont.cuh with the
// same overloads (add, sub, mul, sqr, is_zero, select, Elem<>), so
// xyzz.cuh's formulas take it unchanged.  The constants are mont.cuh's
// Consts<N>.
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
//   N = 2 (test_bm64's p = 2^64 - 59, no spare bit): one chain over N + 2
//        words of state, and sqr is mul(a, a);
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
        // (w_lo + m p) / R <= p by N reduction rows, then + w_hi < 2p
        uint32_t* even = w;
        uint32_t odd[N];
#pragma unroll
        for (int i = 0; i < N; i += 2) {
            cc::cios_row<N>(even, odd, nullptr, 0, c, i == 0);
            cc::cios_row<N>(odd, even, nullptr, 0, c, false);
        }
        cc::merge<N>(even, odd);
        even[0] = cc::add_cc(even[0], w[N]);
#pragma unroll
        for (int i = 1; i < N - 1; i++)
            even[i] = cc::addc_cc(even[i], w[N + i]);
        even[N - 1] = cc::addc(even[N - 1], w[2 * N - 1]);
        return final_sub<N>(even, 0, c);
    } else {
        return mul(a, a, c);
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

}  // namespace mont
