// Elementwise Montgomery product and square for Hopper (sm_90a).
//
// bigmont_ew replaces sppark_tpu/ff/bigmont.py:_ew_call_cached, the Pallas
// kernel behind every BigMontField.mul / sqr on the TPU: out = x * y * R^-1
// (or x^2 * R^-1) mod p, canonical, lane by lane.
//
// Layout: an element is n32 32-bit words, limb-major (n32, n) -- word w of
// lane i at w * n + i -- so one thread per lane reads and writes coalesced.
// The TPU kernel's (L, rows, 128) blocks of 16-bit limbs, its row padding
// and its block-row choice are Mosaic's shapes and have no counterpart here.
//
// What bounds it on the card: a product is ~2 n32^2 32x32->64 multiplies
// (~4 n32^2 IMADs) against 3 n32 words moved, so at n32 = 12 the integer
// multiply rate bounds it, not HBM.  This first design keeps the whole
// product in one thread's registers (CIOS, mont.cuh); at the (nwins,)
// lanes of the MSM's Fermat chains the launch, not the arithmetic, is the
// cost.  Warp-cooperative limbs and a fused inversion chain are later work.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "mont.cuh"

namespace {

constexpr int THREADS = 256;

template <int N, bool SQR>
__global__ void __launch_bounds__(THREADS)
ew_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
          uint32_t* __restrict__ out, long long n, mont::Consts<N> c) {
    long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    mont::Fp<N> a, r;
#pragma unroll
    for (int w = 0; w < N; w++) a.w[w] = x[w * n + i];
    if (SQR) {
        r = mont::sqr(a, c);
    } else {
        mont::Fp<N> b;
#pragma unroll
        for (int w = 0; w < N; w++) b.w[w] = y[w * n + i];
        r = mont::mul(a, b, c);
    }
#pragma unroll
    for (int w = 0; w < N; w++) out[w * n + i] = r.w[w];
}

template <int N>
void launch(int sqr, const uint32_t* x, const uint32_t* y, uint32_t* out,
            long long n, const uint32_t* consts, cudaStream_t s) {
    mont::Consts<N> c = mont::make_consts<N>(consts);
    unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    if (sqr)
        ew_kernel<N, true><<<blocks, THREADS, 0, s>>>(x, y, out, n, c);
    else
        ew_kernel<N, false><<<blocks, THREADS, 0, s>>>(x, y, out, n, c);
}

}  // namespace

// out (n32, n) = x * y (sqr = 0) or x^2 (sqr = 1), Montgomery, mod p.
// consts: the host array [p (n32 words), one (n32), a4 (n32), m0, nr].
extern "C" int bigmont_ew(int n32, int sqr, const void* x, const void* y,
                          void* out, long long n, const void* consts,
                          void* stream) {
    auto X = static_cast<const uint32_t*>(x);
    auto Y = static_cast<const uint32_t*>(y);
    auto O = static_cast<uint32_t*>(out);
    auto C = static_cast<const uint32_t*>(consts);
    auto s = static_cast<cudaStream_t>(stream);
    switch (n32) {
        case 2: launch<2>(sqr, X, Y, O, n, C, s); break;
        case 8: launch<8>(sqr, X, Y, O, n, C, s); break;
        case 12: launch<12>(sqr, X, Y, O, n, C, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
