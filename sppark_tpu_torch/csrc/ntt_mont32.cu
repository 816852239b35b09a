// NTT kernels of the 31-bit Montgomery fields (BabyBear, with either
// generator) for Hopper (sm_90a): the narrow kernels of csrc/ntt_narrow.cuh
// over the Mont32 policy below.
//
// mont32_ntt_rows replaces sppark_tpu/ntt/pallas_kernels.py:_rows_kernel and
// mont32_ntt_cols replaces sppark_tpu/ntt/pallas_kernels.py:_cols_kernel, for
// the mont32 fields (one u32 word per element, Montgomery form, R = 2^32).
// p and M0 = -p^-1 mod 2^32 are launch arguments, so one build serves every
// such field.
//
// The arithmetic is canonical throughout: p < 2^31 leaves no room for a
// lazy range in a u32 word (BabyBear's 3p > 2^32), so add and sub fold with
// one unsigned min (a + b < 2p, and a - b wraps above p when it borrows),
// and the product is 32x32 -> 64 bits (the low word and __umulhi), then
// REDC: t = hi + umulhi(lo M0, p) + (lo != 0), the low words cancelling,
// and t < 2p folds with one min.  REDC needs hi < p, which canonical
// operands give (hi <= (p-1)^2 / 2^32 < p / 2), so every input word,
// twiddle and multiplier must be canonical.  A block holds 2^14 words, 64
// KiB of shared memory, so a column block is 8 columns (32 bytes of a row)
// at n1 = 2^11.
//
// What bounds them on the card: 4 bytes per element read once and written
// once per pass (plus the mul block in the column pass), against 15 32-bit
// integer operations per butterfly counted from the code (the multiply, 9:
// the low and high products of a and b, the low product lo M0, the high
// product of m and p, the carry test, a three-way add, a subtract and a
// min; add and sub: two operations and a min each); at 2^24 the
// operations weigh more than the bytes.

#include "ntt_narrow.cuh"

namespace narrow {

using u32 = unsigned int;

struct Mont32 {
    using word = u32;
    static constexpr int ELEMS = 16384;     // 64 KiB of shared memory
    u32 p, m0;

    __device__ __forceinline__ u32 add(u32 a, u32 b) const {
        const u32 s = a + b;
        return min(s, s - p);
    }

    __device__ __forceinline__ u32 sub(u32 a, u32 b) const {
        const u32 d = a - b;
        return min(d, d + p);
    }

    __device__ __forceinline__ u32 mul(u32 a, u32 b) const {
        const u32 lo = a * b;
        const u32 hi = __umulhi(a, b);
        const u32 m = lo * m0;
        const u32 t = hi + __umulhi(m, p) + (lo != 0);
        return min(t, t - p);
    }

    __device__ __forceinline__ u32 canon(u32 x) const { return x; }
};

}  // namespace narrow

extern "C" {

// x, mul: (OB, B, n) natural order; out: (OB, B, n), or (OB, n, B) when
// out_t.  tw: [w^0 .. w^(n/2-1)].  mul may be null.  Needs 1 <= lg <= 13
// and p < 2^31.
int mont32_ntt_rows(const void* x, const void* tw, const void* mul, void* out,
                    long long ob, long long b, int lg, int in_rev,
                    int out_rev, int out_t, unsigned p, unsigned m0,
                    void* stream) {
    if (p >= (1u << 31)) return (int)cudaErrorInvalidValue;
    return narrow::launch_rows(narrow::Mont32{p, m0}, x, tw, mul, out, ob, b,
                               lg, in_rev, out_rev, out_t, stream);
}

// x, out: (B, n1, M); mul: (n1, M) or null; tw: [w^0 .. w^(n1/2-1)].
// Needs 1 <= lg <= 13, M a power of two and p < 2^31.
int mont32_ntt_cols(const void* x, const void* tw, const void* mul, void* out,
                    long long batch, int lg, long long M, unsigned p,
                    unsigned m0, void* stream) {
    if (p >= (1u << 31)) return (int)cudaErrorInvalidValue;
    return narrow::launch_cols(narrow::Mont32{p, m0}, x, tw, mul, out, batch,
                               lg, M, stream);
}

}  // extern "C"
