// xyzz point kernels for Hopper (sm_90a), one point per thread:
//
//   ec_xyzz_madd replaces sppark_tpu/ec/pallas_ops.py:_madd_call
//     (bucket (X, Y, ZZ, ZZZ) += affine (ax, ay), the MSM's slab round);
//   ec_xyzz_add  replaces sppark_tpu/ec/pallas_ops.py:_add_call
//     (xyzz + xyzz: the replica fold, integrate, the chunk combine);
//   ec_xyzz_dbl  replaces sppark_tpu/ec/pallas_ops.py:_dbl_call
//     (xyzz doubling: integrate).
// The formulas and the order of the special cases are in xyzz.cuh, the
// operand views and the launch in ec_kernel.cuh (shared with the G2
// kernels, ec_fp2_*.cu).  All three run on the carry-chain element
// mont::FpCC<n32> (mont_cc.cuh).
//
// What bounds them on the card: a madd is 8M + 2S, ~10 x 2 n32^2
// 32x32->64 multiplies, against 10 n32 words moved per lane, so the integer
// multiply rate bounds them at every supported width.  The whole point op
// stays in one thread's registers, as the TPU kernel keeps it in VMEM, and
// what the design cuts is the instructions a product issues: PTX carry
// chains, which ptxas fuses into one IMAD.WIDE.U32.X a 32x32 product, in
// two chains a row that do not wait on each other (mont::FpCC), where
// mont::Fp's 64-bit sums took about three instructions; and 3 blocks an
// SM (ec_kernel.cuh: cc_min_blocks).  The integrate's doubling runs at a
// few lanes (16 on the BLS12-381 G1 tree), one warp's chain of dependent
// products: there the element's shorter products set its time.
// The madd's affine point is read from the slab MSM's point table through
// the slot index (ec_kernel.cuh), so no slab of points is written and read
// back.  The doubling leg is a per-lane branch: a warp with no doubling
// lane never runs it.

#include "ec_kernel.cuh"

// views: the host array [pointer, sw, sl, index, rows] per input
// coordinate, in order (X, Y, ZZ, ZZZ, ax, ay) for madd, (X1 .. ZZZ1, X2 ..
// ZZZ2) for add, (X, Y, ZZ, ZZZ) for dbl; index 0, or for the madd's ax and
// ay an int32 index into their table of `rows` rows.  out: (4, n32, n).
// consts: [p, one, a4, m0, nr] (ff/kernels.py:field_consts).
extern "C" int ec_xyzz_madd(int n32, const void* views, void* out,
                            long long n, const void* consts, void* stream) {
    if (!mont::spare_bit(n32, static_cast<const uint32_t*>(consts)))
        return (int)cudaErrorInvalidValue;
    return ec::dispatch<mont::FpCC, ec::MADD>(n32, views, 6, out, n, consts,
                                             stream);
}

extern "C" int ec_xyzz_add(int n32, const void* views, void* out, long long n,
                           const void* consts, void* stream) {
    if (!mont::spare_bit(n32, static_cast<const uint32_t*>(consts)))
        return (int)cudaErrorInvalidValue;
    return ec::dispatch<mont::FpCC, ec::ADD>(n32, views, 8, out, n, consts,
                                             stream);
}

extern "C" int ec_xyzz_dbl(int n32, const void* views, void* out, long long n,
                           const void* consts, void* stream) {
    if (!mont::spare_bit(n32, static_cast<const uint32_t*>(consts)))
        return (int)cudaErrorInvalidValue;
    return ec::dispatch<mont::FpCC, ec::DBL>(n32, views, 4, out, n, consts,
                                             stream);
}
