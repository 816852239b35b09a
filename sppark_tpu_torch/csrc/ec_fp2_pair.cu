// G2 (fp2) batch-affine pair add kernels for Hopper (sm_90a):
// ec_fp2_pair_prep and ec_fp2_pair_finish replace
// sppark_tpu/ec/pallas_ops.py:_pair_prep_call and _pair_finish_call for
// degree-2 curves (_KCtx with degree 2, pallas_ops.py:89-220), the two
// halves of one level of the segmented-tree MSM (msm/tree.py) around its
// batch inversion, which for fp2 runs through the norm in the base field.
//
// The formulas and the case order are pair.cuh's, shared with the G1
// kernels of ec_pair.cu; the operand views and the launch are
// ec_kernel.cuh's.  A coordinate is (2 n32, n) words, c0's then c1's, so
// infinity is all 4 n32 words of (x, y) zero.  Widths: n32 = 2
// (test_bm64_g2), 8 (bn254_g2), 12 (bls12_381_g2, bls12_377_g2).
//
// What bounds them on the card: prep moves five fp2 coordinates per lane
// (and two index words on a tree's first level) for six base additions,
// so memory bounds it; finish does two fp2 products and a squaring (about
// 8 base products) against seven coordinates moved, about even between the
// integer multiply rate and memory at n32 = 12.  Both run one pair on a
// lane pair of threads (mont::Fp2Pair<N>, as ec_fp2_madd.cu): each thread
// keeps one coefficient of its fp2 inputs (48 words of x1, y1, x2, y2 at
// n32 = 12, where one thread a pair held 96).  The zero tests combine the
// pair's halves with one shuffle, so both threads hold the same flag word
// and take its branches together; each stores its half of den, the even
// one the flag.  On a tree's first level both read their point operands
// from the point table through the level-0 index, staged in a
// shared-memory tile by coalesced 16-byte cp.async copies (ec_kernel.cuh):
// read straight from the table, a warp's loads touch 32 rows each.  Later
// levels read the even and odd lanes of the level below in place.

#include "ec_kernel.cuh"

// views: the host array [pointer, sw, sl, index or 0, the index's table
// rows] per input, in order (x1, y1, x2, y2) for prep, (x1, y1, x2, y2,
// inv, flags) for finish, each coordinate (2 n32, n) or, through an
// index, (2 n32, rows).  out: (2 n32 + 1, n), den then the flags, for
// prep; (2, 2 n32, n) for finish.  consts: [p, one, a4, m0, nr] of the
// base field (ff/kernels.py:field_consts).
extern "C" int ec_fp2_pair_prep(int n32, const void* views, void* out,
                                long long n, const void* consts,
                                void* stream) {
    if (ec::indexed(views))
        return ec::dispatch<mont::Fp2Pair, ec::PAIR_PREP, true>(
            n32, views, 4, out, n, consts, stream);
    return ec::dispatch<mont::Fp2Pair, ec::PAIR_PREP>(n32, views, 4, out, n,
                                                      consts, stream);
}

extern "C" int ec_fp2_pair_finish(int n32, const void* views, void* out,
                                  long long n, const void* consts,
                                  void* stream) {
    if (ec::indexed(views))
        return ec::dispatch<mont::Fp2Pair, ec::PAIR_FINISH, true>(
            n32, views, 6, out, n, consts, stream);
    return ec::dispatch<mont::Fp2Pair, ec::PAIR_FINISH>(n32, views, 6, out,
                                                        n, consts, stream);
}
