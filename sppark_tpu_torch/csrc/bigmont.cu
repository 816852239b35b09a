// Elementwise Montgomery product and square, and the fixed-exponent power,
// for Hopper (sm_90a).
//
// bigmont_ew replaces sppark_tpu/ff/bigmont.py:_ew_call_cached, the Pallas
// kernel behind every BigMontField.mul / sqr on the TPU: out = x * y * R^-1
// (or x^2 * R^-1) mod p, canonical, lane by lane.
//
// bigmont_pow is the same kernel's products chained inside one launch:
// out = x^e (Montgomery form in and out) for an exponent fixed per launch,
// the Fermat inversion x^(p-2) of every BigMontField.inv.  The JAX package
// runs that chain as one compiled lax.scan of ew calls
// (sppark_tpu/ff/base.py:pow_const); a Python loop of bigmont_ew launches,
// one per square and per multiply, cost 608 launches for one 381-bit
// inversion, each of them far more host time than card time.
// Here one thread per lane keeps x and the accumulator in registers and
// runs the whole chain: MSB first (pow_byref, ff/pow.hpp), by fixed
// windows of POW_WINDOW bits (4: a table of x^1 .. x^15 in local memory,
// 14 products, then a product per non-zero digit: ~490 products for p - 2
// of BLS12-381 where bit by bit takes 608).  Any chain gives the unique
// canonical x^e, so the words are the JAX chain's; 0 maps to 0 (e > 0),
// and e = 0 gives the Montgomery one.
//
// Layout: an element is n32 32-bit words, limb-major (n32, n) -- word w of
// lane i at w * n + i -- so one thread per lane reads and writes coalesced.
// The TPU kernel's (L, rows, 128) blocks of 16-bit limbs, its row padding
// and its block-row choice are Mosaic's shapes and have no counterpart here.
//
// What bounds them on the card: a product is ~2 n32^2 32x32->64 multiplies
// (~4 n32^2 IMADs) against 3 n32 words moved, so at n32 = 12 the integer
// multiply rate bounds bigmont_ew at width, not HBM.  This first design
// keeps the whole product in one thread's registers (CIOS, mont.cuh).  At
// the one lane of the MSM tree's root inversions, bigmont_pow is bound by
// neither: one thread runs ~490 dependent products, so the latency of its
// instruction chain sets its time.
//
// The entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>

#include "mont.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int POW_THREADS = 128;
constexpr int EXP_WORDS = 12;     // exponents up to 384 bits: p - 2 fits

constexpr int POW_WINDOW = 4;     // bits of an exponent digit
static_assert(32 % POW_WINDOW == 0, "a window must not straddle words");

// The exponent, passed by value in the launch's parameters.
struct Exp {
    uint32_t w[EXP_WORDS];
    int nbits;                    // bit length; 0 for e = 0

    __device__ __forceinline__ uint32_t digit(int d, int bits) const {
        return (w[d * bits / 32] >> (d * bits % 32)) & ((1u << bits) - 1);
    }
};

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

template <int N, int WIN>
__global__ void __launch_bounds__(POW_THREADS)
pow_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
           long long n, const __grid_constant__ Exp e, mont::Consts<N> c) {
    long long i = (long long)blockIdx.x * POW_THREADS + threadIdx.x;
    if (i >= n) return;
    mont::Fp<N> a, acc;
#pragma unroll
    for (int w = 0; w < N; w++) a.w[w] = x[w * n + i];
    if (e.nbits == 0) {
        acc = mont::from_words<N>(c.one);
    } else {
        // tbl[k] = a^k; a digit of 0 takes no product
        mont::Fp<N> tbl[1 << WIN];
        tbl[1] = a;
#pragma unroll 1
        for (int k = 2; k < (1 << WIN); k++)
            tbl[k] = mont::mul(tbl[k - 1], a, c);
        int top = (e.nbits - 1) / WIN;
        acc = tbl[e.digit(top, WIN)];          // the top digit is not 0
#pragma unroll 1
        for (int d = top - 1; d >= 0; d--) {
#pragma unroll
            for (int s = 0; s < WIN; s++) acc = mont::sqr(acc, c);
            uint32_t k = e.digit(d, WIN);
            if (k) acc = mont::mul(acc, tbl[k], c);
        }
    }
#pragma unroll
    for (int w = 0; w < N; w++) out[w * n + i] = acc.w[w];
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

template <int N>
void launch_pow(const uint32_t* x, uint32_t* out, long long n, const Exp& e,
                const uint32_t* consts, cudaStream_t s) {
    mont::Consts<N> c = mont::make_consts<N>(consts);
    unsigned blocks = (unsigned)((n + POW_THREADS - 1) / POW_THREADS);
    pow_kernel<N, POW_WINDOW><<<blocks, POW_THREADS, 0, s>>>(x, out, n, e,
                                                             c);
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

// out (n32, n) = x^e, Montgomery form in and out, mod p.  exp_words: the
// host array of e's little-endian 32-bit words, (nbits + 31) / 32 of them;
// nbits: e's bit length, at most 384 (0: e = 0, out = the Montgomery one).
// consts: as for bigmont_ew.
extern "C" int bigmont_pow(int n32, const void* x, void* out, long long n,
                           const void* exp_words, int nbits,
                           const void* consts, void* stream) {
    if (nbits < 0 || nbits > 32 * EXP_WORDS)
        return (int)cudaErrorInvalidValue;
    Exp e = {};
    auto E = static_cast<const uint32_t*>(exp_words);
    for (int k = 0; k < (nbits + 31) / 32; k++) e.w[k] = E[k];
    e.nbits = nbits;
    auto X = static_cast<const uint32_t*>(x);
    auto O = static_cast<uint32_t*>(out);
    auto C = static_cast<const uint32_t*>(consts);
    auto s = static_cast<cudaStream_t>(stream);
    switch (n32) {
        case 2: launch_pow<2>(X, O, n, e, C, s); break;
        case 8: launch_pow<8>(X, O, n, e, C, s); break;
        case 12: launch_pow<12>(X, O, n, e, C, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
