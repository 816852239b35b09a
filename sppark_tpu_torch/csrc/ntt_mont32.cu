// NTT kernels of the 31-bit Montgomery fields (BabyBear, with either
// generator) for Hopper (sm_90a): the radix-2^k register kernels of
// csrc/ntt_radix.cuh over the Mont32 policy of csrc/mont32.cuh.
//
// mont32_ntt_rows replaces sppark_tpu/ntt/pallas_kernels.py:_rows_kernel and
// mont32_ntt_cols replaces sppark_tpu/ntt/pallas_kernels.py:_cols_kernel, for
// the mont32 fields (one u32 word per element, Montgomery form, R = 2^32).
// p and M0 = -p^-1 mod 2^32 are launch arguments, so one build serves every
// such field.  Every op is canonical (mont32.cuh), so every input word,
// twiddle and multiplier must be canonical, as every entry point gives
// them.
//
// What bounds them on the card: 4 bytes per element read once and written
// once per pass (plus the mul block in the column pass), against 13 32-bit
// integer operations per butterfly counted from mont32.cuh (the product,
// 7: the low and high products of a and b, the low product lo pinv, the
// high product of m and p, a subtract, an add and a min; add and sub:
// two operations and a min each); at 2^24 the operations weigh more than
// the bytes.  What the design does about it: ntt_radix.cuh's header.

#include "mont32.cuh"
#include "ntt_radix.cuh"

extern "C" {

// x, mul: (OB, B, n) natural order; out: (OB, B, n), or (OB, n, B) when
// out_t.  tw: [w^0 .. w^(n/2-1)].  mul may be null.  Needs 1 <= lg <= 13
// and p < 2^31.
int mont32_ntt_rows(const void* x, const void* tw, const void* mul, void* out,
                    long long ob, long long b, int lg, int in_rev,
                    int out_rev, int out_t, unsigned p, unsigned m0,
                    void* stream) {
    if (p >= (1u << 31)) return (int)cudaErrorInvalidValue;
    return radix::launch_rows(narrow::Mont32{p, 0u - m0}, x, tw, mul, out,
                              ob, b, lg, in_rev, out_rev, out_t, stream);
}

// x, out: (B, n1, M); mul: (n1, M) or null; tw: [w^0 .. w^(n1/2-1)].
// Needs 1 <= lg <= 13, M a power of two and p < 2^31.
int mont32_ntt_cols(const void* x, const void* tw, const void* mul, void* out,
                    long long batch, int lg, long long M, unsigned p,
                    unsigned m0, void* stream) {
    if (p >= (1u << 31)) return (int)cudaErrorInvalidValue;
    return radix::launch_cols(narrow::Mont32{p, 0u - m0}, x, tw, mul, out,
                              batch, lg, M, stream);
}

}  // extern "C"
