// G2 (fp2) xyzz add for Hopper (sm_90a), one point per lane pair of
// threads: ec_fp2_xyzz_add replaces sppark_tpu/ec/pallas_ops.py:_add_call
// for degree-2 curves (the MSM's replica fold, integrate and chunk
// combine).  Its bound is the integer multiply rate (add-2008-s, 12M + 2S
// in fp2, ~40 base products).  It runs xyzz.cuh's add, with the doubling
// leg for equal points, on mont::Fp2Pair<N> as ec_fp2_madd.cu does (the
// design is there): thread 2i holds c0 of every coordinate of lane i,
// thread 2i + 1 holds c1.  Both points, 16 fp2 coordinates, no longer
// sit in one thread's registers, which at n32 = 12 spilled (255
// registers with one thread a lane).  Every zero test reads both
// coefficients, so the special cases (either point at infinity, equal or
// opposite points) branch a pair together.

#include "ec_kernel.cuh"

// views: [pointer, sw, sl] per input coordinate, (X1 .. ZZZ1, X2 .. ZZZ2),
// each (2 n32, n).  out: (4, 2 n32, n).  consts: [p, one, a4, m0, nr].
extern "C" int ec_fp2_xyzz_add(int n32, const void* views, void* out,
                               long long n, const void* consts,
                               void* stream) {
    return ec::dispatch<mont::Fp2Pair, ec::ADD>(n32, views, 8, out, n,
                                                consts, stream);
}
