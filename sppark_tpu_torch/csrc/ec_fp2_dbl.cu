// G2 (fp2) xyzz doubling for Hopper (sm_90a), one point per lane pair of
// threads: ec_fp2_xyzz_dbl replaces sppark_tpu/ec/pallas_ops.py:_dbl_call
// for degree-2 curves (the MSM's integrate).
//
// Its bound is the integer multiply rate (dbl-2008-s-1, 6M + 3S in fp2),
// but on the MSM it runs on a window's few lanes (17 on the BLS12-381 G2
// slab and tree), where one thread's chain of dependent products and the
// launch, not the bound, set its time.  So the design shortens that
// chain twice over: the lane pair (mont::Fp2PairCC<N>, mont_cc.cuh; thread
// 2i holds c0 of every coordinate of lane i, thread 2i + 1 holds c1) gives
// each thread one coefficient, an fp2 product one dot a thread (a b + x y,
// one Montgomery reduction) in place of a thread's three products; and the
// coefficients are mont::FpCC<N>, whose products run on PTX carry chains
// (about 400 SASS instructions a product at N = 12 against mont::Fp's
// ~985).  The Y == 0 and ZZ == 0 tests read both coefficients, so every
// branch is pair-uniform.  As the G1 carry-chain kernels, it refuses a p
// without a spare bit at n32 >= 4 (the chains' bound, mont_cc.cuh).

#include "ec_kernel.cuh"

// views: [pointer, sw, sl, index (0), rows] per input coordinate, (X, Y,
// ZZ, ZZZ), each (2 n32, n).  out: (4, 2 n32, n).  consts: [p, one, a4,
// m0, nr].
extern "C" int ec_fp2_xyzz_dbl(int n32, const void* views, void* out,
                               long long n, const void* consts,
                               void* stream) {
    if (!mont::spare_bit(n32, static_cast<const uint32_t*>(consts)))
        return (int)cudaErrorInvalidValue;
    return ec::dispatch<mont::Fp2PairCC, ec::DBL>(n32, views, 4, out, n,
                                                  consts, stream);
}
