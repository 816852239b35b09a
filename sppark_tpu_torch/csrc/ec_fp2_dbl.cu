// G2 (fp2) xyzz doubling for Hopper (sm_90a), one point per thread:
// ec_fp2_xyzz_dbl replaces sppark_tpu/ec/pallas_ops.py:_dbl_call for
// degree-2 curves (the MSM's integrate).  The design and its bound
// (integer multiplies: 6M + 3S in fp2) are in ec_fp2_madd.cu; on the MSM
// it runs on a window's few lanes, where the launch and one thread's
// latency, not the bound, set its time.

#include "ec_kernel.cuh"

// views: [pointer, sw, sl] per input coordinate, (X, Y, ZZ, ZZZ), each
// (2 n32, n).  out: (4, 2 n32, n).  consts: [p, one, a4, m0, nr].
extern "C" int ec_fp2_xyzz_dbl(int n32, const void* views, void* out,
                               long long n, const void* consts,
                               void* stream) {
    return ec::dispatch<mont::Fp2, ec::DBL>(n32, views, 4, out, n, consts,
                                            stream);
}
