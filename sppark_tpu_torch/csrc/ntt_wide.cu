// Wide-field (multi-limb Montgomery) NTT kernels for Hopper (sm_90a).
//
// bigmont_ntt_rows replaces sppark_tpu/ntt/pallas_kernels.py:_rows_kernel
//   in its wide use (traced with _RawOps' bigmont branch): batched NTTs
//   along the last axis of (n32, OB, B, n), n = 2^lg <= 2^11, with the
//   input bit reversal (in_rev), an output bit reversal (out_rev), a
//   multiply of the result by a same-shape block (mul) and a transposed
//   store to (n32, OB, n, B) (out_t), as gl64_ntt_rows has them.
// bigmont_ntt_cols replaces _cols_kernel in its wide use: batched NTTs
//   along axis -2 of (n32, B, n1, M) (the wide path multiplies its middle
//   twiddles in bigmont_ntt_mid, so it takes no multiplier).
// bigmont_ntt_mid replaces _mid_factored_kernel: the factored four-step
//   middle twiddles, out[.., k1, j] = x[.., k1, j] * A[k1, j / block] *
//   B[k1, j mod block] over (n32, B, n1, M), A (n32, n1, M / block), B
//   (n32, n1, block).
//
// An element is N 32-bit words in Montgomery form (mont.cuh, instantiated
// for N = 2 and N = 8), canonical in and out of every operation, so the
// stored words are the TPU kernels' words exactly.  A butterfly is one
// Montgomery product, one add and one sub.
//
// Layout: limb-major in device memory, as ff/bigmont.py holds it (word k
// of element e at k * plane + e), so neighbouring threads touch
// neighbouring words; limb-major in shared memory too (s[k * T + i]).  A
// butterfly's N word loads then each fall on distinct banks across a warp;
// an element-major tile (s[i * N + k]) would put lane-adjacent words
// 4 N bytes apart, an 8-way bank conflict at N = 8.
//
// What bounds them on the card: a butterfly's product is ~2 N^2 32x32->64
// multiplies against 8 N bytes of shared-memory traffic and, per pass,
// 8 N bytes of device memory per element, so at N = 8 they are bound by
// integer operations, not by bytes.  This first design keeps one tile of
// 2^11 elements (64 KiB at N = 8, the gl64 kernels' budget) in shared
// memory: one transform, a few rows, or C adjacent columns (C * 4 bytes
// per row read: C = 8 fills a 32-byte sector), runs all lg radix-2 stages
// there with a __syncthreads() per stage, and reads twiddles through the
// read-only cache.  A register-resident radix-2^k butterfly and the mid
// multiply fused into the column pass are later work.
//
// Each entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "mont.cuh"

namespace {

using mont::Consts;
using mont::Fp;

constexpr int THREADS = 256;
constexpr int LG_TILE = 11;
constexpr int TILE = 1 << LG_TILE;       // elements of one block's tile

__device__ __forceinline__ int brev(int i, int lg) {
    return (int)(__brev((unsigned)i) >> (32 - lg));
}

// element i of a limb-major array whose limb planes are `plane` apart
template <int N>
__device__ __forceinline__ Fp<N> gload(const uint32_t* __restrict__ p,
                                       long long plane, long long i) {
    Fp<N> r;
#pragma unroll
    for (int k = 0; k < N; k++) r.w[k] = __ldg(p + k * plane + i);
    return r;
}

template <int N>
__device__ __forceinline__ void gstore(uint32_t* __restrict__ p,
                                       long long plane, long long i,
                                       const Fp<N>& v) {
#pragma unroll
    for (int k = 0; k < N; k++) p[k * plane + i] = v.w[k];
}

template <int N>
__device__ __forceinline__ Fp<N> sload(const uint32_t* s, int T, int i) {
    Fp<N> r;
#pragma unroll
    for (int k = 0; k < N; k++) r.w[k] = s[k * T + i];
    return r;
}

template <int N>
__device__ __forceinline__ void sstore(uint32_t* s, int T, int i,
                                       const Fp<N>& v) {
#pragma unroll
    for (int k = 0; k < N; k++) s[k * T + i] = v.w[k];
}

// s[i0], s[i1] = s[i0] + w s[i1], s[i0] - w s[i1]
template <int N>
__device__ __forceinline__ void butterfly(uint32_t* s, int T, int i0, int i1,
                                          const Fp<N>& w,
                                          const Consts<N>& c) {
    const Fp<N> a = sload<N>(s, T, i0);
    const Fp<N> b = mont::mul(sload<N>(s, T, i1), w, c);
    sstore<N>(s, T, i0, mont::add(a, b, c));
    sstore<N>(s, T, i1, mont::sub(a, b, c));
}

// One block transforms `rpb` consecutive rows of length n = 2^lg, held in
// shared memory as s[k * T + r * n + i], T = rpb * n.
template <int N>
__global__ void __launch_bounds__(THREADS)
rows_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
            const uint32_t* __restrict__ mul, uint32_t* __restrict__ out,
            long long rows, long long B, int lg, int rpb, int in_rev,
            int out_rev, int out_t, Consts<N> c) {
    extern __shared__ uint32_t s[];
    const int n = 1 << lg;
    const int T = rpb << lg;
    const long long plane = rows << lg;
    const long long row0 = (long long)blockIdx.x * rpb;
    const int nrows = (int)min((long long)rpb, rows - row0);
    const int total = nrows << lg;
    const long long e0 = row0 << lg;

    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int i = e & (n - 1);
        const int d = (e & ~(n - 1)) | (in_rev ? brev(i, lg) : i);
#pragma unroll
        for (int k = 0; k < N; k++)
            s[k * T + d] = __ldg(x + k * plane + e0 + e);
    }
    __syncthreads();

    const int half_n = n >> 1;
    for (int st = 1; st <= lg; ++st) {
        const int h = 1 << (st - 1);
        for (int t = threadIdx.x; t < (total >> 1); t += blockDim.x) {
            const int r = t >> (lg - 1);
            const int q = t & (half_n - 1);
            const int j = q & (h - 1);
            const int i0 = (r << lg) + ((q >> (st - 1)) << st) + j;
            butterfly<N>(s, T, i0, i0 + h,
                         gload<N>(tw, half_n, (long long)j << (lg - st)), c);
        }
        __syncthreads();
    }

    if (!out_t) {
        for (int e = threadIdx.x; e < total; e += blockDim.x) {
            const int i = e & (n - 1);
            Fp<N> v = sload<N>(s, T, (e & ~(n - 1)) |
                                         (out_rev ? brev(i, lg) : i));
            if (mul) v = mont::mul(v, gload<N>(mul, plane, e0 + e), c);
            gstore<N>(out, plane, e0 + e, v);
        }
        return;
    }
    // transposed store: out[ob, i, b] = y[ob, b, i]; the row index runs
    // fastest so that neighbouring threads write neighbouring words
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int r = e % nrows;
        const int i = e / nrows;
        Fp<N> v = sload<N>(s, T, (r << lg) | (out_rev ? brev(i, lg) : i));
        const long long row = row0 + r;
        if (mul) v = mont::mul(v, gload<N>(mul, plane, (row << lg) + i), c);
        const long long ob = row / B, b = row - ob * B;
        gstore<N>(out, plane, (ob * n + i) * B + b, v);
    }
}

// One block transforms C = 2^lgc adjacent columns of one (n1, M) slice,
// held in shared memory as s[k * T + r * C + col], T = n1 * C;
// neighbouring threads take neighbouring columns.
template <int N>
__global__ void __launch_bounds__(THREADS)
cols_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
            uint32_t* __restrict__ out, int lg, long long M, int lgc,
            long long blocks_per_slice, long long plane, Consts<N> c) {
    extern __shared__ uint32_t s[];
    const int n = 1 << lg;
    const int C = 1 << lgc;
    const int T = n << lgc;
    const long long slice = blockIdx.x / blocks_per_slice;
    const long long col0 = (blockIdx.x - slice * blocks_per_slice) * C;
    const long long base = slice * n * M + col0;

    for (int e = threadIdx.x; e < T; e += blockDim.x) {
        const int r = e >> lgc, col = e & (C - 1);
        const int d = (brev(r, lg) << lgc) | col;
#pragma unroll
        for (int k = 0; k < N; k++)
            s[k * T + d] = __ldg(x + k * plane + base + r * M + col);
    }
    __syncthreads();

    const int half_n = n >> 1;
    for (int st = 1; st <= lg; ++st) {
        const int h = 1 << (st - 1);
        for (int t = threadIdx.x; t < (T >> 1); t += blockDim.x) {
            const int col = t & (C - 1);
            const int q = t >> lgc;
            const int j = q & (h - 1);
            const int i0 = ((q >> (st - 1)) << st) + j;
            butterfly<N>(s, T, (i0 << lgc) | col, ((i0 + h) << lgc) | col,
                         gload<N>(tw, half_n, (long long)j << (lg - st)), c);
        }
        __syncthreads();
    }

    for (int e = threadIdx.x; e < T; e += blockDim.x) {
        const int r = e >> lgc, col = e & (C - 1);
        gstore<N>(out, plane, base + r * M + col, sload<N>(s, T, e));
    }
}

// One thread per element of (B, n1, M): n1, M and block are powers of two.
template <int N>
__global__ void __launch_bounds__(THREADS)
mid_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ a,
           const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
           long long total, int lg1, int lgm, int lgb, Consts<N> c) {
    const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (e >= total) return;
    const long long j = e & ((1LL << lgm) - 1);
    const long long k1 = (e >> lgm) & ((1LL << lg1) - 1);
    const int lga = lgm - lgb;               // A's width, lg(M / block)
    const long long ia = (k1 << lga) + (j >> lgb);
    const long long ib = (k1 << lgb) + (j & ((1LL << lgb) - 1));
    Fp<N> v = gload<N>(x, total, e);
    v = mont::mul(v, gload<N>(a, 1LL << (lg1 + lga), ia), c);
    v = mont::mul(v, gload<N>(b, 1LL << (lg1 + lgb), ib), c);
    gstore<N>(out, total, e, v);
}

int threads_for(long long elems) {
    long long t = elems / 2;
    if (t > THREADS) t = THREADS;
    if (t < 32) t = 32;
    return (int)t;
}

template <int N>
int rows_launch(const uint32_t* x, const uint32_t* tw, const uint32_t* mul,
                uint32_t* out, long long ob, long long b, int lg, int in_rev,
                int out_rev, int out_t, const uint32_t* consts,
                cudaStream_t stream) {
    const long long n = 1LL << lg;
    const long long rows = ob * b;
    long long rpb = TILE / n;
    if (rpb > rows) rpb = rows;
    const long long grid = (rows + rpb - 1) / rpb;
    const size_t smem = (size_t)N * 4 * rpb * n;
    cudaError_t err = cudaFuncSetAttribute(
        rows_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    rows_kernel<N><<<(unsigned)grid, threads_for(rpb * n), smem, stream>>>(
        x, tw, mul, out, rows, b, lg, (int)rpb, in_rev, out_rev, out_t,
        mont::make_consts<N>(consts));
    return (int)cudaGetLastError();
}

template <int N>
int cols_launch(const uint32_t* x, const uint32_t* tw, uint32_t* out,
                long long batch, int lg, long long M, const uint32_t* consts,
                cudaStream_t stream) {
    const long long n = 1LL << lg;
    long long C = TILE / n;
    if (C > M) C = M;
    int lgc = 0;
    while ((1LL << lgc) < C) ++lgc;
    const long long per_slice = M / C;
    const size_t smem = (size_t)N * 4 * C * n;
    cudaError_t err = cudaFuncSetAttribute(
        cols_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    cols_kernel<N><<<(unsigned)(batch * per_slice), threads_for(C * n), smem,
                     stream>>>(x, tw, out, lg, M, lgc, per_slice,
                               batch * n * M, mont::make_consts<N>(consts));
    return (int)cudaGetLastError();
}

template <int N>
int mid_launch(const uint32_t* x, const uint32_t* a, const uint32_t* b,
               uint32_t* out, long long total, int lg1, int lgm, int lgb,
               const uint32_t* consts, cudaStream_t stream) {
    const long long grid = (total + THREADS - 1) / THREADS;
    mid_kernel<N><<<(unsigned)grid, THREADS, 0, stream>>>(
        x, a, b, out, total, lg1, lgm, lgb, mont::make_consts<N>(consts));
    return (int)cudaGetLastError();
}

bool pow2(long long v) { return v > 0 && !(v & (v - 1)); }

int lg_of(long long v) {
    int k = 0;
    while ((1LL << k) < v) ++k;
    return k;
}

}  // namespace

extern "C" {

// x, mul: (n32, OB, B, n) natural order; out: (n32, OB, B, n), or
// (n32, OB, n, B) when out_t.  tw: (n32, n/2), [w^0 .. w^(n/2-1)].  mul may
// be null.  consts: [p (n32 words), one (n32), a4 (n32), m0].
// Needs 1 <= lg <= 11 and n32 of 2 or 8.
int bigmont_ntt_rows(int n32, const void* x, const void* tw, const void* mul,
                     void* out, long long ob, long long b, int lg,
                     int in_rev, int out_rev, int out_t, const void* consts,
                     void* stream) {
    if (lg < 1 || lg > LG_TILE || ob < 1 || b < 1)
        return (int)cudaErrorInvalidValue;
    auto X = static_cast<const uint32_t*>(x);
    auto W = static_cast<const uint32_t*>(tw);
    auto Mu = static_cast<const uint32_t*>(mul);
    auto O = static_cast<uint32_t*>(out);
    auto C = static_cast<const uint32_t*>(consts);
    auto s = static_cast<cudaStream_t>(stream);
    switch (n32) {
        case 2: return rows_launch<2>(X, W, Mu, O, ob, b, lg, in_rev, out_rev,
                                      out_t, C, s);
        case 8: return rows_launch<8>(X, W, Mu, O, ob, b, lg, in_rev, out_rev,
                                      out_t, C, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// x, out: (n32, B, n1, M); tw: (n32, n1/2).
// Needs 1 <= lg <= 11 and M a power of two.
int bigmont_ntt_cols(int n32, const void* x, const void* tw, void* out,
                     long long batch, int lg, long long M, const void* consts,
                     void* stream) {
    if (lg < 1 || lg > LG_TILE || batch < 1 || !pow2(M))
        return (int)cudaErrorInvalidValue;
    auto X = static_cast<const uint32_t*>(x);
    auto W = static_cast<const uint32_t*>(tw);
    auto O = static_cast<uint32_t*>(out);
    auto C = static_cast<const uint32_t*>(consts);
    auto s = static_cast<cudaStream_t>(stream);
    switch (n32) {
        case 2: return cols_launch<2>(X, W, O, batch, lg, M, C, s);
        case 8: return cols_launch<8>(X, W, O, batch, lg, M, C, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// x, out: (n32, B, n1, M); a: (n32, n1, M / block); b: (n32, n1, block).
// Needs n1, M and block powers of two, block <= M.
int bigmont_ntt_mid(int n32, const void* x, const void* a, const void* b,
                    void* out, long long batch, long long n1, long long M,
                    long long block, const void* consts, void* stream) {
    if (batch < 1 || !pow2(n1) || !pow2(M) || !pow2(block) || block > M)
        return (int)cudaErrorInvalidValue;
    auto X = static_cast<const uint32_t*>(x);
    auto A = static_cast<const uint32_t*>(a);
    auto Bm = static_cast<const uint32_t*>(b);
    auto O = static_cast<uint32_t*>(out);
    auto C = static_cast<const uint32_t*>(consts);
    auto s = static_cast<cudaStream_t>(stream);
    const long long total = batch * n1 * M;
    const int lg1 = lg_of(n1), lgm = lg_of(M), lgb = lg_of(block);
    switch (n32) {
        case 2: return mid_launch<2>(X, A, Bm, O, total, lg1, lgm, lgb, C, s);
        case 8: return mid_launch<8>(X, A, Bm, O, total, lg1, lgm, lgb, C, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
