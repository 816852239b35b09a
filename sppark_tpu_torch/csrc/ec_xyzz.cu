// xyzz point kernels for Hopper (sm_90a), one point per thread:
//
//   ec_xyzz_madd replaces sppark_tpu/ec/pallas_ops.py:_madd_call
//     (bucket (X, Y, ZZ, ZZZ) += affine (ax, ay), the MSM's slab round);
//   ec_xyzz_add  replaces sppark_tpu/ec/pallas_ops.py:_add_call
//     (xyzz + xyzz: the replica fold, integrate, the chunk combine);
//   ec_xyzz_dbl  replaces sppark_tpu/ec/pallas_ops.py:_dbl_call
//     (xyzz doubling: integrate).
// The formulas and the order of the special cases are in xyzz.cuh.
//
// Operands: each input coordinate is an (n32, n) view given by a pointer and
// two strides in words, `sw` between words and `sl` between lanes, so the
// kernels read limb-major tensors (sw = n, sl = 1), point-major rows of the
// MSM's slab (sw = 1, sl = 2 n32) and broadcast constants (sl = 0) without
// a copy.  The output is one contiguous (4, n32, n) block, stored coalesced.
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
//
// Each entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "xyzz.cuh"

namespace {

constexpr int THREADS = 128;

struct View {
    const uint32_t* p;
    long long sw, sl;
};

enum Op { MADD = 0, ADD = 1, DBL = 2 };

template <int N>
struct Args {
    View in[8];
    uint32_t* out;
    long long n;
    mont::Consts<N> c;
};

template <int N>
__device__ __forceinline__ mont::Fp<N> load(const View& v, long long i) {
    mont::Fp<N> r;
#pragma unroll
    for (int w = 0; w < N; w++) r.w[w] = v.p[w * v.sw + i * v.sl];
    return r;
}

template <int N>
__device__ __forceinline__ xyzz::Point<N> load_point(const View* v,
                                                     long long i) {
    return xyzz::Point<N>{load<N>(v[0], i), load<N>(v[1], i),
                          load<N>(v[2], i), load<N>(v[3], i)};
}

template <int N>
__device__ __forceinline__ void store(uint32_t* out, long long n, long long i,
                                      int coord, const mont::Fp<N>& a) {
#pragma unroll
    for (int w = 0; w < N; w++) out[((long long)coord * N + w) * n + i] = a.w[w];
}

template <int N, int OP>
__global__ void __launch_bounds__(THREADS)
ec_kernel(const __grid_constant__ Args<N> a) {
    long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= a.n) return;
    xyzz::Point<N> r;
    if (OP == MADD) {
        r = xyzz::madd(load_point<N>(a.in, i), load<N>(a.in[4], i),
                       load<N>(a.in[5], i), a.c);
    } else if (OP == ADD) {
        r = xyzz::add(load_point<N>(a.in, i), load_point<N>(a.in + 4, i),
                      a.c);
    } else {
        r = xyzz::dbl(load_point<N>(a.in, i), a.c);
    }
    store(a.out, a.n, i, 0, r.x);
    store(a.out, a.n, i, 1, r.y);
    store(a.out, a.n, i, 2, r.zz);
    store(a.out, a.n, i, 3, r.zzz);
}

template <int N, int OP>
void launch(const long long* views, int n_in, uint32_t* out, long long n,
            const uint32_t* consts, cudaStream_t s) {
    Args<N> a;
    for (int k = 0; k < 8; k++) {
        bool used = k < n_in;
        a.in[k].p = used ? (const uint32_t*)views[3 * k] : nullptr;
        a.in[k].sw = used ? views[3 * k + 1] : 0;
        a.in[k].sl = used ? views[3 * k + 2] : 0;
    }
    a.out = out;
    a.n = n;
    a.c = mont::make_consts<N>(consts);
    unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    ec_kernel<N, OP><<<blocks, THREADS, 0, s>>>(a);
}

template <int OP>
int dispatch(int n32, const void* views, int n_in, void* out, long long n,
             const void* consts, void* stream) {
    auto V = static_cast<const long long*>(views);
    auto O = static_cast<uint32_t*>(out);
    auto C = static_cast<const uint32_t*>(consts);
    auto s = static_cast<cudaStream_t>(stream);
    switch (n32) {
        case 2: launch<2, OP>(V, n_in, O, n, C, s); break;
        case 8: launch<8, OP>(V, n_in, O, n, C, s); break;
        case 12: launch<12, OP>(V, n_in, O, n, C, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// views: the host array [pointer, sw, sl] per input coordinate, in order
// (X, Y, ZZ, ZZZ, ax, ay) for madd, (X1 .. ZZZ1, X2 .. ZZZ2) for add,
// (X, Y, ZZ, ZZZ) for dbl.  out: (4, n32, n).  consts: [p, one, a4, m0].
extern "C" int ec_xyzz_madd(int n32, const void* views, void* out,
                            long long n, const void* consts, void* stream) {
    return dispatch<MADD>(n32, views, 6, out, n, consts, stream);
}

extern "C" int ec_xyzz_add(int n32, const void* views, void* out, long long n,
                           const void* consts, void* stream) {
    return dispatch<ADD>(n32, views, 8, out, n, consts, stream);
}

extern "C" int ec_xyzz_dbl(int n32, const void* views, void* out, long long n,
                           const void* consts, void* stream) {
    return dispatch<DBL>(n32, views, 4, out, n, consts, stream);
}
