// G2 (fp2) bucket madd for Hopper (sm_90a), one point per lane pair of
// threads: ec_fp2_xyzz_madd replaces sppark_tpu/ec/pallas_ops.py:_madd_call
// for degree-2 curves (bucket (X, Y, ZZ, ZZZ) += affine (ax, ay), the
// MSM's slab round).  Its siblings ec_fp2_add.cu and ec_fp2_dbl.cu port
// _add_call and _dbl_call; each is a source, and so a library, of its own,
// so nvcc builds the three at once (the N = 12 instantiations take
// minutes each).
//
// On the TPU the same Pallas kernels serve G2 through _KCtx with degree 2
// (pallas_ops.py:89-220): a coordinate is stacked c0 || c1 limb planes,
// mul is Karatsuba over three base products with the small signed
// nonresidue applied by additions.  The formulas, with their special cases
// in the TPU kernels' order, are the text xyzz.cuh shares with the G1
// kernels of ec_xyzz.cu; the operand views and the launch are
// ec_kernel.cuh's.  A coordinate is (2 n32, n) words, c0's then c1's, so
// infinity is all 4 n32 words of (x, y) zero.  Widths: n32 = 2
// (test_bm64_g2), 8 (bn254_g2), 12 (bls12_381_g2, bls12_377_g2).
//
// What bounds it on the card: an fp2 product is 3 base products and 5-9
// additions, so a madd is ~30 base products, ~120 n32^2 32-bit
// operations, against 20 n32 words moved per lane: the integer multiply
// rate bounds it.  One thread per bucket (mont::Fp2<N>, as ec_fp2_dbl.cu
// still runs) holds an Fp2<12> in 24 registers and ~10 of them live, so
// it used all 255 registers, spilled, and ran at 0.139 of that bound.
// Here, as in ec_fp2_add.cu and ec_fp2_pair.cu's finish, the element is
// mont::Fp2Pair<N>, the reference's warp-lane-pair fp2
// (ff/alt_bn128-fp2.hpp:25-60): thread 2i holds c0 of every coordinate of
// bucket i, thread 2i + 1 holds c1 (it reads rows n32 .. 2 n32 - 1 of
// each coordinate), so each thread keeps half the words; a product is two base products with one reduction a thread
// (mont.cuh:dot) after a shuffle of the operands.  Every branch of the
// formulas is per bucket and its zero tests read both coefficients, so
// both threads of a pair branch together and the pair-masked shuffles
// are defined in diverged warps.  ptxas's registers and spills are
// printed by chip_smoke.py.

#include "ec_kernel.cuh"

// views: the host array [pointer, sw, sl] per input coordinate, in order
// (X, Y, ZZ, ZZZ, ax, ay), each (2 n32, n).  out: (4, 2 n32, n).  consts:
// [p, one, a4, m0, nr] of the base field (ff/kernels.py:field_consts).
extern "C" int ec_fp2_xyzz_madd(int n32, const void* views, void* out,
                                long long n, const void* consts,
                                void* stream) {
    return ec::dispatch<mont::Fp2Pair, ec::MADD>(n32, views, 6, out, n,
                                                 consts, stream);
}
