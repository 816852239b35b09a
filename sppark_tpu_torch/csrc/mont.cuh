// Multi-limb Montgomery field arithmetic over N 32-bit limbs, and its
// quadratic extension, for the kernels of bigmont.cu, ntt_wide.cu,
// ec_xyzz.cu and ec_fp2_*.cu (the role of sppark's ff/mont_t.cuh and
// ff/alt_bn128-fp2.hpp).
//
// An element is N little-endian 32-bit words, R = 2^(32 N), held in
// registers.  The field constants (p, M0 = -p^-1 mod 2^32, the Montgomery
// one, the curve's a4 in Montgomery form, and the quadratic nonresidue as
// a small signed integer) arrive per launch in a Consts<N> passed by
// value, so one instantiation per N serves every field of that width:
// N = 2 (test_bm64, test_bm64_g2), 8 (BN254, Pasta), 12 (BLS12-381,
// BLS12-377).
//
// Fp2<N> is c0 + c1 u with u^2 = nr, |nr| < 16 (-1 for BN254 and
// BLS12-381, -5 for BLS12-377, 7 for test_bm64_g2), as the TPU kernels'
// degree-2 element (sppark_tpu/ec/pallas_ops.py:_KCtx): mul is Karatsuba
// over three base products with nr * t1 by additions, sqr two squarings
// and one product; one thread holds both coefficients.
//
// Fp2Pair<N> is the same element spread over a lane pair, as the
// reference's fp2_t (ff/alt_bn128-fp2.hpp:25-60): two adjacent threads hold
// one element, the even thread c0 and the odd thread c1, so a point op
// needs half the registers per thread.  A product swaps the operands with
// the partner (__shfl_xor_sync over the pair's two lanes) and each thread
// computes its own coefficient as a dot product of two products with ONE
// Montgomery reduction (dot): c0 = a0 b0 + (nr a1) b1, c1 = a1 b0 + a0 b1.
// A square takes the (a + b)(a - b) form, one product a thread: c0 = (a0
// + a1)(a0 + nr a1) - (1 + nr) a0 a1, c1 = 2 a0 a1.  A zero test reads
// both coefficients, so both threads of a pair take every branch
// together; a kernel on this element keeps all its branches pair-uniform.
//
// Every function takes canonical inputs (< p) and returns canonical output,
// so the words a kernel stores are the TPU kernels' words exactly.
//   mul: CIOS (coarsely integrated operand scanning) with 64-bit partial
//        products, N + 2 words of state, one conditional subtraction;
//   sqr: the off-diagonal products once, doubled, plus the diagonal, then
//        an N-step Montgomery reduction of the 2N-word square.
// Both are about 2 N^2 (mul) and 1.5 N^2 (sqr) 32x32->64 products.  The
// reference's mad_n_redc uses PTX carry chains (madc.lo.cc/madc.hi.cc);
// here the carries ride in the top half of 64-bit sums, which nvcc lowers
// to IMAD.WIDE and IADD3 -- simpler, somewhat more instructions.
//
// The functions are also host-callable (MONT_HD), so the arithmetic can be
// compiled by a host C++ compiler and checked without a card.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define MONT_HD __host__ __device__ __forceinline__
#else
#define MONT_HD inline
#endif

namespace mont {

template <int N>
struct Fp {
    uint32_t w[N];
};

template <int N>
struct Consts {
    uint32_t p[N];
    uint32_t one[N];   // R mod p
    uint32_t a4[N];    // curve coefficient a4, Montgomery form (0: none)
    uint32_t m0;       // -p^-1 mod 2^32
    int32_t nr;        // fp2 nonresidue u^2, a small signed integer
};

// Consts from the host array [p (N words), one (N), a4 (N), m0, nr].
template <int N>
inline Consts<N> make_consts(const uint32_t* h) {
    Consts<N> c;
    for (int i = 0; i < N; i++) {
        c.p[i] = h[i];
        c.one[i] = h[N + i];
        c.a4[i] = h[2 * N + i];
    }
    c.m0 = h[3 * N];
    c.nr = (int32_t)h[3 * N + 1];
    return c;
}

template <int N>
MONT_HD Fp<N> zero() {
    Fp<N> r;
#pragma unroll
    for (int i = 0; i < N; i++) r.w[i] = 0;
    return r;
}

template <int N>
MONT_HD Fp<N> from_words(const uint32_t* w) {
    Fp<N> r;
#pragma unroll
    for (int i = 0; i < N; i++) r.w[i] = w[i];
    return r;
}

// What generic code (xyzz.cuh, ec_kernel.cuh) needs of an element type
// beyond the overloaded ops: its zero, a base-field constant embedded in
// it, its base width, the threads that hold one element and the words of
// one element in memory.
template <class E>
struct Elem;

template <int N>
struct Elem<Fp<N>> {
    static constexpr int BASE = N, THREADS = 1, WORDS = N;
    static MONT_HD Fp<N> zero() { return mont::zero<N>(); }
    static MONT_HD Fp<N> embed(const uint32_t* w) {
        return from_words<N>(w);
    }
};

template <int N>
MONT_HD bool is_zero(const Fp<N>& a) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < N; i++) acc |= a.w[i];
    return acc == 0;
}

template <int N>
MONT_HD Fp<N> select(bool c, const Fp<N>& a, const Fp<N>& b) {
    Fp<N> r;
#pragma unroll
    for (int i = 0; i < N; i++) r.w[i] = c ? a.w[i] : b.w[i];
    return r;
}

// r = a - b over N words; returns the borrow out (0 or 1).
template <int N>
MONT_HD uint32_t sub_words(uint32_t* r, const uint32_t* a,
                           const uint32_t* b) {
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < N; i++) {
        uint64_t d = (uint64_t)a[i] - b[i] - borrow;
        r[i] = (uint32_t)d;
        borrow = (uint32_t)(d >> 63);
    }
    return borrow;
}

// The final conditional subtraction: t (N words, plus `top`, the bit above
// them) < 2p -> t mod p.
template <int N>
MONT_HD Fp<N> reduce_once(const uint32_t* t, uint32_t top,
                          const Consts<N>& c) {
    Fp<N> r, d;
#pragma unroll
    for (int i = 0; i < N; i++) r.w[i] = t[i];
    uint32_t borrow = sub_words<N>(d.w, r.w, c.p);
    return (top || !borrow) ? d : r;
}

template <int N>
MONT_HD Fp<N> add(const Fp<N>& a, const Fp<N>& b, const Consts<N>& c) {
    uint32_t s[N];
    uint32_t carry = 0;
#pragma unroll
    for (int i = 0; i < N; i++) {
        uint64_t t = (uint64_t)a.w[i] + b.w[i] + carry;
        s[i] = (uint32_t)t;
        carry = (uint32_t)(t >> 32);
    }
    return reduce_once<N>(s, carry, c);
}

template <int N>
MONT_HD Fp<N> sub(const Fp<N>& a, const Fp<N>& b, const Consts<N>& c) {
    Fp<N> d;
    uint32_t borrow = sub_words<N>(d.w, a.w, b.w);
    if (borrow) {
        uint32_t carry = 0;
#pragma unroll
        for (int i = 0; i < N; i++) {
            uint64_t t = (uint64_t)d.w[i] + c.p[i] + carry;
            d.w[i] = (uint32_t)t;
            carry = (uint32_t)(t >> 32);
        }
    }
    return d;
}

// a * b * R^-1 mod p (CIOS).
template <int N>
MONT_HD Fp<N> mul(const Fp<N>& a, const Fp<N>& b, const Consts<N>& c) {
    uint32_t t[N + 2];
#pragma unroll
    for (int i = 0; i < N + 2; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < N; i++) {
        // t += a * b[i]
        uint64_t C = 0;
#pragma unroll
        for (int j = 0; j < N; j++) {
            uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + C;
            t[j] = (uint32_t)s;
            C = s >> 32;
        }
        uint64_t s = (uint64_t)t[N] + C;
        t[N] = (uint32_t)s;
        t[N + 1] = (uint32_t)(s >> 32);
        // t = (t + m p) / 2^32
        uint32_t m = t[0] * c.m0;
        s = (uint64_t)m * c.p[0] + t[0];
        C = s >> 32;
#pragma unroll
        for (int j = 1; j < N; j++) {
            s = (uint64_t)m * c.p[j] + t[j] + C;
            t[j - 1] = (uint32_t)s;
            C = s >> 32;
        }
        s = (uint64_t)t[N] + C;
        t[N - 1] = (uint32_t)s;
        t[N] = t[N + 1] + (uint32_t)(s >> 32);
    }
    return reduce_once<N>(t, t[N], c);
}

// (a b + x y) R^-1 mod p: CIOS over both products with ONE reduction (the
// reference's dot_product, ff/mont_t.cuh:697-719).  Its state stays below
// 3p, so two conditional subtractions end it for any p < R.
template <int N>
MONT_HD Fp<N> dot(const Fp<N>& a, const Fp<N>& b, const Fp<N>& x,
                  const Fp<N>& y, const Consts<N>& c) {
    uint32_t t[N + 2];
#pragma unroll
    for (int i = 0; i < N + 2; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < N; i++) {
        // t += a * b[i] + x * y[i]
        uint64_t C = 0;
#pragma unroll
        for (int j = 0; j < N; j++) {
            uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + C;
            t[j] = (uint32_t)s;
            C = s >> 32;
        }
        uint64_t s = (uint64_t)t[N] + C;
        t[N] = (uint32_t)s;
        t[N + 1] = (uint32_t)(s >> 32);
        C = 0;
#pragma unroll
        for (int j = 0; j < N; j++) {
            s = (uint64_t)x.w[j] * y.w[i] + t[j] + C;
            t[j] = (uint32_t)s;
            C = s >> 32;
        }
        s = (uint64_t)t[N] + C;
        t[N] = (uint32_t)s;
        t[N + 1] += (uint32_t)(s >> 32);
        // t = (t + m p) / 2^32
        uint32_t m = t[0] * c.m0;
        s = (uint64_t)m * c.p[0] + t[0];
        C = s >> 32;
#pragma unroll
        for (int j = 1; j < N; j++) {
            s = (uint64_t)m * c.p[j] + t[j] + C;
            t[j - 1] = (uint32_t)s;
            C = s >> 32;
        }
        s = (uint64_t)t[N] + C;
        t[N - 1] = (uint32_t)s;
        t[N] = t[N + 1] + (uint32_t)(s >> 32);
    }
    // t + t[N] R < 3p: subtract p once if it is at least p, then the usual
    // final subtraction
    uint32_t d[N];
    uint32_t borrow = sub_words<N>(d, t, c.p);
    bool ge = t[N] || !borrow;
#pragma unroll
    for (int i = 0; i < N; i++) d[i] = ge ? d[i] : t[i];
    return reduce_once<N>(d, ge ? t[N] - borrow : 0, c);
}

// a^2 * R^-1 mod p.
template <int N>
MONT_HD Fp<N> sqr(const Fp<N>& a, const Consts<N>& c) {
    uint32_t t[2 * N];
#pragma unroll
    for (int i = 0; i < 2 * N; i++) t[i] = 0;
    // off-diagonal products a_i a_j, i < j
#pragma unroll
    for (int i = 0; i < N - 1; i++) {
        uint64_t C = 0;
#pragma unroll
        for (int j = i + 1; j < N; j++) {
            uint64_t s = (uint64_t)a.w[i] * a.w[j] + t[i + j] + C;
            t[i + j] = (uint32_t)s;
            C = s >> 32;
        }
        t[i + N] = (uint32_t)C;
    }
    // double them (their sum is < 2^(64N - 1), so no bit leaves the top)
#pragma unroll
    for (int k = 2 * N - 1; k > 0; k--) t[k] = (t[k] << 1) | (t[k - 1] >> 31);
    t[0] <<= 1;
    // add the diagonal a_i^2
    uint64_t C = 0;
#pragma unroll
    for (int i = 0; i < N; i++) {
        uint64_t s = (uint64_t)a.w[i] * a.w[i] + t[2 * i] + C;
        t[2 * i] = (uint32_t)s;
        s = (uint64_t)t[2 * i + 1] + (s >> 32);
        t[2 * i + 1] = (uint32_t)s;
        C = s >> 32;
    }
    // Montgomery reduction of the 2N-word square; `top` carries the bit
    // above the current window from one step to the next
    uint32_t top = 0;
#pragma unroll
    for (int i = 0; i < N; i++) {
        uint32_t m = t[i] * c.m0;
        C = 0;
#pragma unroll
        for (int j = 0; j < N; j++) {
            uint64_t s = (uint64_t)m * c.p[j] + t[i + j] + C;
            t[i + j] = (uint32_t)s;
            C = s >> 32;
        }
        uint64_t s = (uint64_t)t[i + N] + C + top;
        t[i + N] = (uint32_t)s;
        top = (uint32_t)(s >> 32);
    }
    return reduce_once<N>(t + N, top, c);
}

// -- the quadratic extension ---------------------------------------------------

template <int N>
struct Fp2 {
    Fp<N> c0, c1;
};

template <int N>
MONT_HD bool is_zero(const Fp2<N>& a) {
    return is_zero(a.c0) && is_zero(a.c1);
}

template <int N>
MONT_HD Fp2<N> select(bool c, const Fp2<N>& a, const Fp2<N>& b) {
    return Fp2<N>{select(c, a.c0, b.c0), select(c, a.c1, b.c1)};
}

template <int N>
MONT_HD Fp2<N> add(const Fp2<N>& a, const Fp2<N>& b, const Consts<N>& c) {
    return Fp2<N>{add(a.c0, b.c0, c), add(a.c1, b.c1, c)};
}

template <int N>
MONT_HD Fp2<N> sub(const Fp2<N>& a, const Fp2<N>& b, const Consts<N>& c) {
    return Fp2<N>{sub(a.c0, b.c0, c), sub(a.c1, b.c1, c)};
}

// k * t for a small k >= 0, by doubling and adding; B is a base-field
// element, Fp<N> or mont_cc.cuh's FpCC<N>.
template <class B, int N>
MONT_HD B times(const B& t, int k, const Consts<N>& c) {
    if (k == 1) return t;
    B m = Elem<B>::zero(), run = t;
    for (; k; k >>= 1) {
        if (k & 1) m = add(m, run, c);
        if (k > 1) run = add(run, run, c);
    }
    return m;
}

// k * t for a small signed k.
template <class B, int N>
MONT_HD B times_signed(const B& t, int k, const Consts<N>& c) {
    B m = times(t, k < 0 ? -k : k, c);
    return k < 0 ? sub(Elem<B>::zero(), m, c) : m;
}

// t0 + nr * t1.
template <class B, int N>
MONT_HD B add_nr(const B& t0, const B& t1, const Consts<N>& c) {
    B m = times(t1, c.nr < 0 ? -c.nr : c.nr, c);
    return c.nr < 0 ? sub(t0, m, c) : add(t0, m, c);
}

// The fp2 products over a base element B, each as the coefficients it
// gives, so that the one-thread elements (Fp2 here, FpCC's Fp2CC in
// mont_cc.cuh) and the lane-pair ones share them.
// Karatsuba: c0 = a0 b0 + nr a1 b1, c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1.
template <class B, int N>
MONT_HD void fp2_mul(const B& a0, const B& a1, const B& b0, const B& b1,
                     B& c0, B& c1, const Consts<N>& c) {
    B t0 = mul(a0, b0, c);
    B t1 = mul(a1, b1, c);
    B m = mul(add(a0, a1, c), add(b0, b1, c), c);
    c0 = add_nr(t0, t1, c);
    c1 = sub(sub(m, t0, c), t1, c);
}

// c0 = a0^2 + nr a1^2, c1 = 2 a0 a1.
template <class B, int N>
MONT_HD void fp2_sqr(const B& a0, const B& a1, B& c0, B& c1,
                     const Consts<N>& c) {
    B t0 = sqr(a0, c);
    B t1 = sqr(a1, c);
    B m = mul(a0, a1, c);
    c0 = add_nr(t0, t1, c);
    c1 = add(m, m, c);
}

// On a lane pair each thread computes its own coefficient from its own
// words and its partner's (`odd`: this thread holds c1; a, b its own, ao,
// bo the partner's).  A product is a dot product of two products with ONE
// Montgomery reduction (dot): even c0 = a0 b0 + (nr a1) b1, odd c1 = a1 b0
// + a0 b1; selects, not branches, pick the operands, so the pair stays
// converged.
template <class B, int N>
MONT_HD B pair_mul(bool odd, const B& a, const B& ao, const B& b,
                   const B& bo, const Consts<N>& c) {
    B nra = times_signed(ao, c.nr, c);
    return dot(select(odd, ao, a), b, select(odd, a, nra), bo, c);
}

// A square in two steps, one product a thread between them: first m, even
// (a0 + a1)(a0 + nr a1), odd a0 a1; then from m and the partner's m (mo),
// even c0 = m - (1 + nr) a0 a1, odd c1 = 2 m.
template <class B, int N>
MONT_HD B pair_sqr_prod(bool odd, const B& a, const B& ao,
                        const Consts<N>& c) {
    return mul(select(odd, ao, add(a, ao, c)),
               select(odd, a, add(a, times_signed(ao, c.nr, c), c)), c);
}

template <class B, int N>
MONT_HD B pair_sqr(bool odd, const B& m, const B& mo, const Consts<N>& c) {
    return select(odd, add(m, m, c), sub(m, times_signed(mo, 1 + c.nr, c), c));
}

template <int N>
MONT_HD Fp2<N> mul(const Fp2<N>& a, const Fp2<N>& b, const Consts<N>& c) {
    Fp2<N> r;
    fp2_mul(a.c0, a.c1, b.c0, b.c1, r.c0, r.c1, c);
    return r;
}

template <int N>
MONT_HD Fp2<N> sqr(const Fp2<N>& a, const Consts<N>& c) {
    Fp2<N> r;
    fp2_sqr(a.c0, a.c1, r.c0, r.c1, c);
    return r;
}

// -- the quadratic extension on a lane pair ---------------------------------

// The lane pair, on the card only: this thread's parity (1: it holds c1)
// and the partner's copy of a word, by a shuffle over the pair's two lanes
// only, so that pairs may diverge from each other.  Unlike the rest of
// this header, the pair element has no host version.
#ifdef __CUDACC__
#define MONT_D __device__ __forceinline__

MONT_D bool pair_odd() { return threadIdx.x & 1; }

MONT_D uint32_t pair_swap(uint32_t v) {
    return __shfl_xor_sync(3u << (threadIdx.x & 30), v, 1);
}

template <int N>
struct Fp2Pair {
    Fp<N> v;    // c0 on the even thread of the pair, c1 on the odd
};

// the partner's copy of a base element (Fp<N> or FpCC<N>)
template <class B>
MONT_D B partner(const B& a) {
    B r;
#pragma unroll
    for (int i = 0; i < Elem<B>::BASE; i++) r.w[i] = pair_swap(a.w[i]);
    return r;
}

template <int N>
MONT_D bool is_zero(const Fp2Pair<N>& a) {
    uint32_t z = is_zero(a.v);
    return z & pair_swap(z);
}

template <int N>
MONT_D Fp2Pair<N> select(bool c, const Fp2Pair<N>& a, const Fp2Pair<N>& b) {
    return Fp2Pair<N>{select(c, a.v, b.v)};
}

template <int N>
MONT_D Fp2Pair<N> add(const Fp2Pair<N>& a, const Fp2Pair<N>& b,
                       const Consts<N>& c) {
    return Fp2Pair<N>{add(a.v, b.v, c)};
}

template <int N>
MONT_D Fp2Pair<N> sub(const Fp2Pair<N>& a, const Fp2Pair<N>& b,
                       const Consts<N>& c) {
    return Fp2Pair<N>{sub(a.v, b.v, c)};
}

// Each thread holds its own a and b and receives the partner's (pair_mul,
// pair_sqr above).
template <int N>
MONT_D Fp2Pair<N> mul(const Fp2Pair<N>& a, const Fp2Pair<N>& b,
                       const Consts<N>& c) {
    return Fp2Pair<N>{pair_mul(pair_odd(), a.v, partner(a.v), b.v,
                               partner(b.v), c)};
}

template <int N>
MONT_D Fp2Pair<N> sqr(const Fp2Pair<N>& a, const Consts<N>& c) {
    bool odd = pair_odd();
    Fp<N> m = pair_sqr_prod(odd, a.v, partner(a.v), c);
    return Fp2Pair<N>{pair_sqr(odd, m, partner(m), c)};
}

#endif  // __CUDACC__

template <int N>
struct Elem<Fp2<N>> {
    static constexpr int BASE = N, THREADS = 1, WORDS = 2 * N;
    static MONT_HD Fp2<N> zero() {
        return Fp2<N>{mont::zero<N>(), mont::zero<N>()};
    }
    static MONT_HD Fp2<N> embed(const uint32_t* w) {
        return Fp2<N>{from_words<N>(w), mont::zero<N>()};
    }
};

#ifdef __CUDACC__
template <int N>
struct Elem<Fp2Pair<N>> {
    static constexpr int BASE = N, THREADS = 2, WORDS = 2 * N;
    static MONT_D Fp2Pair<N> zero() { return Fp2Pair<N>{mont::zero<N>()}; }
    static MONT_D Fp2Pair<N> embed(const uint32_t* w) {
        return Fp2Pair<N>{select(pair_odd(), mont::zero<N>(),
                                 from_words<N>(w))};
    }
};
#endif  // __CUDACC__

}  // namespace mont
