// The Goldilocks field policy of the Goldilocks NTT kernels
// (csrc/ntt_gl64.cu over csrc/ntt_radix.cuh): p = 2^64 - 2^32 + 1, one u64
// word per element.
//
// Lazy arithmetic, the reference's GL64_PARTIALLY_REDUCED mode: add, sub
// and mul take any u64 representative and return one; canon folds one to
// [0, p), once on each stored word, so the words a kernel stores are the
// TPU kernels' canonical words exactly, whatever 64-bit words came in.
// The ops run on csrc/carry.cuh's 32-bit carry chains, which take fewer
// instructions than 64-bit sums with compares and selects
// (`variants.py --sass ntt_gl64` counts each op's):
//   add: a + b; a carry out of 2^64 is + eps (2^64 = eps = 2^32 - 1 mod
//        p), and a second carry leaves the sum below 2^33;
//   sub: a - b; a borrow is - eps, likewise;
//   mul: the 128-bit product r3 r2 r1 r0 (32-bit words) on mad chains,
//        reduced by 2^64 = eps and 2^96 = -1 to r1 r0 + r2 2^32 - r2 - r3:
//        one carry c out of r1 + r2 and one borrow out of subtracting
//        r2 + r3 leave c - borrow in {-1, 0, 1} times 2^64, added back as
//        that many eps, which can neither overflow nor underflow;
//   canon: one subtraction of p (2^64 - 1 < 2p).
//
// The functions compile for a host compiler too (the carry primitives
// over an explicit flag), so g++ can check them against exact integers
// without a card (tests/test_torch_gl64_host.py).

#pragma once

#include "carry.cuh"

#ifdef __CUDACC__
#define GL64_HD __device__ __forceinline__
#else
#define GL64_HD inline
#endif

namespace narrow {

struct Gl64 {
    // unsigned long long, not uint64_t: __ldg is declared for it
    using word = unsigned long long;
    static constexpr word P = 0xFFFFFFFF00000001ull;

    // the kernels' shape (csrc/ntt_radix.cuh), picked on the card by
    // variants.py: radix 16 (16 words are 32 registers), 256 threads a
    // block; 2^13-word tiles (64 KiB: one row at lg 13, 4 columns at lg
    // 11); the last pass's three stages read their twiddles from device
    // memory, so the table is 8 KiB at lg 13 and three row blocks fit an
    // SM (80 registers a thread), two column blocks (128); 32-byte runs
    // of 4 rows in the transposed store
    static constexpr int RADIX_LG = 4;
    static constexpr int THREADS = 256;
    static constexpr int ROW_MIN_BLOCKS = 3;
    static constexpr int COL_MIN_BLOCKS = 2;
    static constexpr int ROW_TILE_LG = 13;
    static constexpr int COL_TILE_LG = 13;
    static constexpr int RUN_LG = 2;
    static constexpr int TW_GLOBAL = 3;

    GL64_HD static uint32_t lo(word x) { return (uint32_t)x; }
    GL64_HD static uint32_t hi(word x) { return (uint32_t)(x >> 32); }
    GL64_HD static word join(uint32_t lo, uint32_t hi) {
        return (word)hi << 32 | lo;
    }

    GL64_HD word add(word a, word b) const {
        uint32_t s0 = cc::add_cc(lo(a), lo(b));
        uint32_t s1 = cc::addc_cc(hi(a), hi(b));
        const uint32_t m = 0u - cc::addc(0, 0);      // eps after a carry
        s0 = cc::add_cc(s0, m);
        s1 = cc::addc_cc(s1, 0);
        const uint32_t m2 = 0u - cc::addc(0, 0);
        s0 = cc::add_cc(s0, m2);
        return join(s0, cc::addc(s1, 0));
    }

    GL64_HD word sub(word a, word b) const {
        uint32_t d0 = cc::sub_cc(lo(a), lo(b));
        uint32_t d1 = cc::subc_cc(hi(a), hi(b));
        const uint32_t m = cc::subc(0, 0);           // eps after a borrow
        d0 = cc::sub_cc(d0, m);
        d1 = cc::subc_cc(d1, 0);
        const uint32_t m2 = cc::subc(0, 0);
        d0 = cc::sub_cc(d0, m2);
        return join(d0, cc::subc(d1, 0));
    }

    GL64_HD word mul(word a, word b) const {
        const uint32_t a0 = lo(a), a1 = hi(a), b0 = lo(b), b1 = hi(b);
        const uint32_t r0 = a0 * b0;
        uint32_t r1 = cc::mul_hi(a0, b0), r2 = a1 * b1;
        uint32_t r3 = cc::mul_hi(a1, b1);
        r1 = cc::mad_lo_cc(a0, b1, r1);
        r2 = cc::madc_hi_cc(a0, b1, r2);
        r3 = cc::addc(r3, 0);
        r1 = cc::mad_lo_cc(a1, b0, r1);
        r2 = cc::madc_hi_cc(a1, b0, r2);
        r3 = cc::addc(r3, 0);
        // r1 r0 + r2 2^32 - (r2 + r3)
        uint32_t t1 = cc::add_cc(r1, r2);
        const uint32_t c = cc::addc(0, 0);
        const uint32_t s0 = cc::add_cc(r2, r3);
        const uint32_t s1 = cc::addc(0, 0);
        uint32_t t0 = cc::sub_cc(r0, s0);
        t1 = cc::subc_cc(t1, s1);
        const uint32_t d = cc::subc(c, 0);           // -1, 0 or 1, x 2^64
        // + d eps = d 2^32 - d, as a 64-bit two's complement word
        t0 = cc::add_cc(t0, 0u - d);
        return join(t0, cc::addc(t1, (uint32_t)((int32_t)d >> 31)));
    }

    GL64_HD word canon(word x) const { return x >= P ? x - P : x; }
};

}  // namespace narrow
