// The 31-bit Montgomery field policy of the mont32 NTT kernels
// (csrc/ntt_mont32.cu): one u32 word per element, Montgomery form with
// R = 2^32, p < 2^31 (BabyBear, with either generator).  p and
// pinv = p^-1 mod 2^32 arrive per launch, so one build serves every such
// field.
//
// Every op takes canonical words (< p) and returns a canonical word, so the
// words a kernel stores are the TPU kernels' words exactly:
//   add: s = a + b (< 2p < 2^32), min(s, s - p): s - p wraps above s when
//        s < p;
//   sub: d = a - b, min(d, d + p): d wraps above p when a < b;
//   mul: a signed Montgomery reduction.  a b = hi 2^32 + lo; m = lo pinv
//        makes m p's low word lo, so (a b - m p) / 2^32 = hi - umulhi(m,
//        p) exactly, in (-p, p) since hi < p (canonical operands: hi <=
//        (p - 1)^2 / 2^32 < p / 2) and umulhi(m, p) < p; one min folds it
//        to [0, p).  Seven operations: the low and high products of a and
//        b, lo pinv, the high product of m and p, a subtract, an add and a
//        min (the unsigned REDC with its carry test took nine).
// A lazy range between stages does not fit: with values in [0, 2p) a
// butterfly's sum reaches 4p > 2^32 for BabyBear (3p already exceeds
// 2^32), so every op stays canonical.
//
// The functions are host-callable too (M32_HD), so g++ can check them
// against exact integers without a card (tests/test_torch_mont32_host.py).

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define M32_HD __host__ __device__ __forceinline__
#else
#define M32_HD inline
#endif

namespace narrow {

struct Mont32 {
    using word = unsigned int;
    unsigned int p, pinv;    // pinv = p^-1 mod 2^32 = -M0

    // the kernels' shape (csrc/ntt_radix.cuh): radix 16 in 64 registers,
    // two blocks of 512 threads an SM, 2^14-word tiles (2 rows at lg 13, 8
    // columns at lg 11) with the whole twiddle table, 32-byte runs of 8
    // rows in the transposed store
    static constexpr int RADIX_LG = 4;
    static constexpr int THREADS = 512;
    static constexpr int ROW_MIN_BLOCKS = 2;
    static constexpr int COL_MIN_BLOCKS = 2;
    static constexpr int ROW_TILE_LG = 14;
    static constexpr int COL_TILE_LG = 14;
    static constexpr int RUN_LG = 3;
    static constexpr int TW_GLOBAL = 0;

    M32_HD static unsigned int umulhi(unsigned int a, unsigned int b) {
#ifdef __CUDA_ARCH__
        return __umulhi(a, b);
#else
        return (unsigned int)(((unsigned long long)a * b) >> 32);
#endif
    }

    M32_HD static unsigned int umin(unsigned int a, unsigned int b) {
#ifdef __CUDA_ARCH__
        return min(a, b);
#else
        return a < b ? a : b;
#endif
    }

    M32_HD unsigned int add(unsigned int a, unsigned int b) const {
        const unsigned int s = a + b;
        return umin(s, s - p);
    }

    M32_HD unsigned int sub(unsigned int a, unsigned int b) const {
        const unsigned int d = a - b;
        return umin(d, d + p);
    }

    M32_HD unsigned int mul(unsigned int a, unsigned int b) const {
        const unsigned int lo = a * b;
        const unsigned int m = lo * pinv;
        const unsigned int t = umulhi(a, b) - umulhi(m, p);
        return umin(t, t + p);
    }

    // every op is canonical already
    M32_HD unsigned int canon(unsigned int a) const { return a; }
};

}  // namespace narrow
