// Goldilocks (p = 2^64 - 2^32 + 1) NTT kernels for Hopper (sm_90a): the
// narrow kernels of csrc/ntt_narrow.cuh over the Gl64 policy below.
//
// gl64_ntt_rows replaces sppark_tpu/ntt/pallas_kernels.py:_rows_kernel and
// gl64_ntt_cols replaces sppark_tpu/ntt/pallas_kernels.py:_cols_kernel, for
// the Goldilocks fields (the TPU kernels' (2, ...) u32 planes are one u64
// word here).
//
// The stages run with lazy arithmetic (any representative in [0, 2^64), the
// reference's GL64_PARTIALLY_REDUCED mode) and canonicalise once on the
// store.  A block holds 2^13 words, 64 KiB of shared memory.
//
// What bounds them on the card: 8 bytes per element read once and written
// once per pass (plus the mul block), against ~20 32-bit integer operations
// per butterfly (the 64x64 -> 128-bit product as four 32x32 products, its
// reduction by 2^64 = 2^32 - 1 and 2^96 = -1, one add, one sub); at 2^24
// the operations weigh slightly more than the bytes.

#include "ntt_narrow.cuh"

namespace narrow {

// unsigned long long, not uint64_t: __ldg and __umul64hi are declared for it
using u64 = unsigned long long;

struct Gl64 {
    using word = u64;
    static constexpr int ELEMS = 8192;      // 64 KiB of shared memory
    static constexpr u64 P = 0xFFFFFFFF00000001ull;
    static constexpr u64 EPS = 0xFFFFFFFFull;  // 2^64 mod p

    __device__ __forceinline__ u64 add(u64 a, u64 b) const {
        u64 s = a + b;
        u64 m = s < a ? EPS : 0;           // carry: + 2^64 == + eps
        s += m;
        return s + (s < m ? EPS : 0);      // a second carry leaves s < 2^33
    }

    __device__ __forceinline__ u64 sub(u64 a, u64 b) const {
        u64 d = a - b;
        u64 m = a < b ? EPS : 0;           // borrow: - 2^64 == - eps
        u64 d2 = d - m;
        return d2 - (d < m ? EPS : 0);
    }

    __device__ __forceinline__ u64 mul(u64 a, u64 b) const {
        u64 lo = a * b;
        u64 hi = __umul64hi(a, b);
        u64 w3 = hi >> 32, w2 = hi & EPS;
        u64 r = lo - w3;                   // 2^96 == -1
        r -= lo < w3 ? EPS : 0;
        u64 u = (w2 << 32) - w2;           // w2 * 2^64 == w2 * eps
        u64 s = r + u;
        return s + (s < u ? EPS : 0);
    }

    __device__ __forceinline__ u64 canon(u64 x) const {
        return x >= P ? x - P : x;
    }
};

}  // namespace narrow

extern "C" {

// x, mul: (OB, B, n) natural order; out: (OB, B, n), or (OB, n, B) when
// out_t.  tw: [w^0 .. w^(n/2-1)].  mul may be null.  Needs 1 <= lg <= 13.
int gl64_ntt_rows(const void* x, const void* tw, const void* mul, void* out,
                  long long ob, long long b, int lg, int in_rev, int out_rev,
                  int out_t, void* stream) {
    return narrow::launch_rows(narrow::Gl64{}, x, tw, mul, out, ob, b, lg,
                               in_rev, out_rev, out_t, stream);
}

// x, out: (B, n1, M); mul: (n1, M) or null; tw: [w^0 .. w^(n1/2-1)].
// Needs 1 <= lg <= 13 and M a power of two.
int gl64_ntt_cols(const void* x, const void* tw, const void* mul, void* out,
                  long long batch, int lg, long long M, void* stream) {
    return narrow::launch_cols(narrow::Gl64{}, x, tw, mul, out, batch, lg, M,
                               stream);
}

}  // extern "C"
