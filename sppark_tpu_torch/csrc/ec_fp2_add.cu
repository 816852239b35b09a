// G2 (fp2) xyzz add for Hopper (sm_90a), one point per thread:
// ec_fp2_xyzz_add replaces sppark_tpu/ec/pallas_ops.py:_add_call for
// degree-2 curves (the MSM's replica fold, integrate and chunk combine).
// The design, its bound (integer multiplies: 12M + 2S in fp2, ~40 base
// products) and why it spills at n32 = 12 are in ec_fp2_madd.cu.

#include "ec_kernel.cuh"

// views: [pointer, sw, sl] per input coordinate, (X1 .. ZZZ1, X2 .. ZZZ2),
// each (2 n32, n).  out: (4, 2 n32, n).  consts: [p, one, a4, m0, nr].
extern "C" int ec_fp2_xyzz_add(int n32, const void* views, void* out,
                               long long n, const void* consts,
                               void* stream) {
    return ec::dispatch<mont::Fp2, ec::ADD>(n32, views, 8, out, n, consts,
                                            stream);
}
