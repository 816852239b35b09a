// Batch-affine pair add kernels for Hopper (sm_90a), G1, one pair of
// affine points per thread:
//
//   ec_pair_prep   replaces sppark_tpu/ec/pallas_ops.py:_pair_prep_call
//     (the chord or tangent denominator and the case flags);
//   ec_pair_finish replaces sppark_tpu/ec/pallas_ops.py:_pair_finish_call
//     (lambda, x3, y3 and the case selects, from the inverted
//     denominator).
// They are the two halves of one level of the segmented-tree MSM
// (msm/tree.py: prep -> batch inversion across all lanes -> finish); the
// inversion between them is a product tree over every lane of the level,
// so it cannot live in one kernel, on the TPU or here.  The formulas and
// the case order are in pair.cuh, the operand views and the launch in
// ec_kernel.cuh (shared with the xyzz kernels), n32 = 2, 8 or 12.  Their
// fp2 twins are in ec_fp2_pair.cu.
//
// What bounds them on the card: prep does three modular additions against
// five coordinates moved per lane, so memory bounds it; finish does two
// products, a squaring and five additions against seven coordinates moved,
// nominally memory-bound at n32 = 12 but on mont::Fp<n32> (985 SASS
// instructions a product) it ran at 0.43 of its bound.
// On a tree's first level the point operands are rows of the point table
// read through the level-0 index, 16 bytes at a time (a row at n32 = 12 is
// 96 bytes: x at byte 0, y at byte 48); on a later level they are the even
// and odd lanes of the level below, read in place.  One thread per pair;
// the tangent leg is a per-lane branch that shares the chord's completion.
//
// The prep's three additions stay on mont::Fp<n32>.  The finish runs on
// the carry-chain element mont::FpCC<n32> (mont_cc.cuh: 397 SASS
// instructions a product at n32 = 12), whose products at n32 >= 4 need a
// spare bit of p (the launch refuses a p without one, as the G1 madd's
// does), with its own minimum of blocks an SM (ec_kernel.cuh:
// cc_min_blocks), and issues its loads (both rows through the index, inv,
// the flag word) before its first product.

#include "ec_kernel.cuh"

// views: the host array [pointer, sw, sl, index or 0, the index's table
// rows] per input, in order (x1, y1, x2, y2) for prep, (x1, y1, x2, y2,
// inv, flags) for finish.  out: (n32 + 1,
// n), den then the flags, for prep; (2, n32, n) for finish.  consts: [p,
// one, a4, m0, nr] (ff/kernels.py:field_consts).
extern "C" int ec_pair_prep(int n32, const void* views, void* out,
                            long long n, const void* consts, void* stream) {
    if (ec::indexed(views))
        return ec::dispatch<mont::Fp, ec::PAIR_PREP, true>(
            n32, views, 4, out, n, consts, stream);
    return ec::dispatch<mont::Fp, ec::PAIR_PREP>(n32, views, 4, out, n,
                                                 consts, stream);
}

extern "C" int ec_pair_finish(int n32, const void* views, void* out,
                              long long n, const void* consts, void* stream) {
    if (!mont::spare_bit(n32, static_cast<const uint32_t*>(consts)))
        return (int)cudaErrorInvalidValue;
    if (ec::indexed(views))
        return ec::dispatch<mont::FpCC, ec::PAIR_FINISH, true>(
            n32, views, 6, out, n, consts, stream);
    return ec::dispatch<mont::FpCC, ec::PAIR_FINISH>(n32, views, 6, out, n,
                                                     consts, stream);
}
