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
// kernels, ec_fp2_*.cu); here the element is mont::Fp<n32>.
//
// What bounds them on the card: a madd is 8M + 2S, ~10 x 2 n32^2
// 32x32->64 multiplies, against 10 n32 words moved per lane, so the integer
// multiply rate bounds them at every supported width.  This first design
// keeps the whole point op in one thread's registers, as the TPU kernel
// keeps it in VMEM; at n32 = 12 a madd holds ~10 field elements live, and
// ptxas's register and spill counts (printed by chip_smoke.py) say what
// that costs.  The doubling leg is a per-lane branch: a warp with no
// doubling lane never runs it.  Warp-cooperative limbs, a gather fused into
// the madd, and CUDA graphs for the integrate loop are later work.

#include "ec_kernel.cuh"

// views: the host array [pointer, sw, sl] per input coordinate, in order
// (X, Y, ZZ, ZZZ, ax, ay) for madd, (X1 .. ZZZ1, X2 .. ZZZ2) for add,
// (X, Y, ZZ, ZZZ) for dbl.  out: (4, n32, n).  consts: [p, one, a4, m0,
// nr] (ff/kernels.py:field_consts).
extern "C" int ec_xyzz_madd(int n32, const void* views, void* out,
                            long long n, const void* consts, void* stream) {
    return ec::dispatch<mont::Fp, ec::MADD>(n32, views, 6, out, n, consts,
                                           stream);
}

extern "C" int ec_xyzz_add(int n32, const void* views, void* out, long long n,
                           const void* consts, void* stream) {
    return ec::dispatch<mont::Fp, ec::ADD>(n32, views, 8, out, n, consts,
                                           stream);
}

extern "C" int ec_xyzz_dbl(int n32, const void* views, void* out, long long n,
                           const void* consts, void* stream) {
    return ec::dispatch<mont::Fp, ec::DBL>(n32, views, 4, out, n, consts,
                                           stream);
}
