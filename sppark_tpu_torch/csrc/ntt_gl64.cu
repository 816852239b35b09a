// Goldilocks (p = 2^64 - 2^32 + 1) NTT kernels for Hopper (sm_90a): the
// radix-2^k register kernels of csrc/ntt_radix.cuh over the lazy Gl64
// policy of csrc/gl64.cuh.
//
// gl64_ntt_rows replaces sppark_tpu/ntt/pallas_kernels.py:_rows_kernel and
// gl64_ntt_cols replaces sppark_tpu/ntt/pallas_kernels.py:_cols_kernel, for
// the Goldilocks fields (the TPU kernels' (2, ...) u32 planes are one u64
// word here).  They take any 64-bit input words, canonical or not, and
// store canonical ones.
//
// What bounds them on the card: 8 bytes per element read once and written
// once per pass (plus the mul block in the column pass), against ~20
// 32-bit integer operations per butterfly (the 64x64 -> 128-bit product as
// four 32x32 products, its reduction by 2^64 = 2^32 - 1 and 2^96 = -1, one
// add, one sub); at 2^24 the row pass is bound by the operations and the
// column pass, which also reads the middle matrix, by the bytes.  What the
// design does about it: ntt_radix.cuh's header and gl64.cuh's shape.

#include "gl64.cuh"
#include "ntt_radix.cuh"

extern "C" {

// x, mul: (OB, B, n) natural order; out: (OB, B, n), or (OB, n, B) when
// out_t.  tw: [w^0 .. w^(n/2-1)].  mul may be null.  Needs 1 <= lg <= 13.
int gl64_ntt_rows(const void* x, const void* tw, const void* mul, void* out,
                  long long ob, long long b, int lg, int in_rev, int out_rev,
                  int out_t, void* stream) {
    return radix::launch_rows(narrow::Gl64{}, x, tw, mul, out, ob, b, lg,
                              in_rev, out_rev, out_t, stream);
}

// x, out: (B, n1, M); mul: (n1, M) or null; tw: [w^0 .. w^(n1/2-1)].
// Needs 1 <= lg <= 13 and M a power of two.
int gl64_ntt_cols(const void* x, const void* tw, const void* mul, void* out,
                  long long batch, int lg, long long M, void* stream) {
    return radix::launch_cols(narrow::Gl64{}, x, tw, mul, out, batch, lg, M,
                              stream);
}

}  // extern "C"
