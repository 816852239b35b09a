// The narrow NTT kernels for Hopper (sm_90a), one text over a field policy:
// Goldilocks (csrc/ntt_gl64.cu) instantiates it.  The 31-bit Montgomery
// fields (csrc/ntt_mont32.cu) run the register-resident radix-16 kernels of
// csrc/ntt_radix.cuh instead.
//
// rows_kernel<F> replaces sppark_tpu/ntt/pallas_kernels.py:_rows_kernel:
//   batched NTTs along the last axis of (OB, B, n), n = 2^lg <= 2^13, with
//   the input bit reversal (in_rev), an output bit reversal (out_rev), a
//   multiply of the result by a same-shape block (mul) and a transposed
//   store to (OB, n, B) (out_t).
// cols_kernel<F> replaces sppark_tpu/ntt/pallas_kernels.py:_cols_kernel:
//   batched NTTs along axis -2 of (B, n1, M), with the four-step middle
//   twiddle matrix (n1, M) multiplied in the same pass (mul).
//
// Both read natural-order input, bit-reverse it on the load into shared
// memory, run all lg radix-2 Cooley-Tukey stages there with the policy's
// add/sub/mul, and apply the policy's canon once on the store.  Stage s
// (half-block h = 2^(s-1)) takes twiddle j from the compact power table
// [w^0 .. w^(n/2-1)] at index (j mod h) << (lg - s).
//
// A field policy F has a word type, ELEMS (the elements a block holds in
// shared memory) and __device__ add, sub, mul and canon over words (lazy
// for Goldilocks: any u64 representative).
//
// What bounds them on the card: each element is read once and written once
// (plus the mul block), so the floor is device-memory bytes unless the
// butterflies' integer operations weigh more.  This first design keeps a
// whole transform in shared memory, so HBM sees each element twice per
// pass; it pays a __syncthreads() per stage and shared-memory traffic per
// butterfly.  csrc/ntt_radix.cuh is the register-resident radix-16
// design (after the reference's ct_mixed_radix_narrow.cu).  The column kernel takes C
// adjacent columns per block so every row read is C words contiguous; the
// transposed row store writes rows_per_block words contiguous.
//
// Each launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#pragma once

#include <cuda_runtime.h>

namespace narrow {

constexpr int LG_MAX = 13;
constexpr int MAX_THREADS = 512;

__device__ __forceinline__ int brev(int i, int lg) {
    return (int)(__brev((unsigned)i) >> (32 - lg));
}

// One block transforms `rpb` consecutive rows of length n = 2^lg, held
// in shared memory as s[r * n + i].
template <class F>
__global__ void rows_kernel(F f, const typename F::word* __restrict__ x,
                            const typename F::word* __restrict__ tw,
                            const typename F::word* __restrict__ mul,
                            typename F::word* __restrict__ out,
                            long long rows, long long B, int lg, int rpb,
                            int in_rev, int out_rev, int out_t) {
    using W = typename F::word;
    extern __shared__ __align__(16) unsigned char smem[];
    W* s = reinterpret_cast<W*>(smem);
    const int n = 1 << lg;
    const long long row0 = (long long)blockIdx.x * rpb;
    const int nrows = (int)min((long long)rpb, rows - row0);
    const int total = nrows << lg;
    const W* xb = x + row0 * n;

    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int i = e & (n - 1);
        const int d = in_rev ? brev(i, lg) : i;
        s[(e & ~(n - 1)) | d] = xb[e];
    }
    __syncthreads();

    const int half_total = total >> 1;
    for (int st = 1; st <= lg; ++st) {
        const int h = 1 << (st - 1);
        for (int t = threadIdx.x; t < half_total; t += blockDim.x) {
            const int r = t >> (lg - 1);
            const int q = t & ((n >> 1) - 1);
            const int j = q & (h - 1);
            const int i0 = (r << lg) + ((q >> (st - 1)) << st) + j;
            const W w = __ldg(tw + ((long long)j << (lg - st)));
            const W a = s[i0];
            const W b = f.mul(s[i0 + h], w);
            s[i0] = f.add(a, b);
            s[i0 + h] = f.sub(a, b);
        }
        __syncthreads();
    }

    if (!out_t) {
        for (int e = threadIdx.x; e < total; e += blockDim.x) {
            const int i = e & (n - 1);
            const int src = out_rev ? brev(i, lg) : i;
            W v = f.canon(s[(e & ~(n - 1)) | src]);
            if (mul) v = f.canon(f.mul(v, __ldg(mul + row0 * n + e)));
            out[row0 * n + e] = v;
        }
        return;
    }
    // transposed store: out[ob, i, b] = y[ob, b, i]; the row index runs
    // fastest so that neighbouring threads write neighbouring words
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int r = e % nrows;
        const int i = e / nrows;
        const int src = out_rev ? brev(i, lg) : i;
        W v = f.canon(s[(r << lg) | src]);
        const long long row = row0 + r;
        if (mul) v = f.canon(f.mul(v, __ldg(mul + row * n + i)));
        const long long ob = row / B, b = row - ob * B;
        out[(ob * n + i) * B + b] = v;
    }
}

// One block transforms C = 2^lgc adjacent columns of one (n1, M) slice,
// held in shared memory row-major as s[i * C + c]; neighbouring threads
// take neighbouring columns.
template <class F>
__global__ void cols_kernel(F f, const typename F::word* __restrict__ x,
                            const typename F::word* __restrict__ tw,
                            const typename F::word* __restrict__ mul,
                            typename F::word* __restrict__ out,
                            int lg, long long M, int lgc,
                            long long blocks_per_slice) {
    using W = typename F::word;
    extern __shared__ __align__(16) unsigned char smem[];
    W* s = reinterpret_cast<W*>(smem);
    const int n = 1 << lg;
    const int C = 1 << lgc;
    const long long slice = blockIdx.x / blocks_per_slice;
    const long long col0 = (blockIdx.x - slice * blocks_per_slice) * C;
    const long long base = slice * n * M + col0;
    const int total = n << lgc;

    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int r = e >> lgc, c = e & (C - 1);
        s[(brev(r, lg) << lgc) | c] = x[base + r * M + c];
    }
    __syncthreads();

    const int half_total = total >> 1;
    for (int st = 1; st <= lg; ++st) {
        const int h = 1 << (st - 1);
        for (int t = threadIdx.x; t < half_total; t += blockDim.x) {
            const int c = t & (C - 1);
            const int q = t >> lgc;
            const int j = q & (h - 1);
            const int i0 = ((q >> (st - 1)) << st) + j;
            const W w = __ldg(tw + ((long long)j << (lg - st)));
            const int k0 = (i0 << lgc) | c, k1 = ((i0 + h) << lgc) | c;
            const W a = s[k0];
            const W b = f.mul(s[k1], w);
            s[k0] = f.add(a, b);
            s[k1] = f.sub(a, b);
        }
        __syncthreads();
    }

    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int r = e >> lgc, c = e & (C - 1);
        W v = f.canon(s[e]);
        if (mul) v = f.canon(f.mul(v, __ldg(mul + col0 + r * M + c)));
        out[base + r * M + c] = v;
    }
}

inline int threads_for(long long total) {
    long long t = total / 2;
    if (t > MAX_THREADS) t = MAX_THREADS;
    if (t < 32) t = 32;
    return (int)t;
}

// x, mul: (OB, B, n) natural order; out: (OB, B, n), or (OB, n, B) when
// out_t.  tw: [w^0 .. w^(n/2-1)].  mul may be null.  Needs 1 <= lg <= 13.
template <class F>
int launch_rows(F f, const void* x, const void* tw, const void* mul,
                void* out, long long ob, long long b, int lg, int in_rev,
                int out_rev, int out_t, void* stream) {
    using W = typename F::word;
    if (lg < 1 || lg > LG_MAX || ob < 1 || b < 1)
        return (int)cudaErrorInvalidValue;
    const int n = 1 << lg;
    const long long rows = ob * b;
    long long rpb = n >= F::ELEMS ? 1 : F::ELEMS / n;
    if (rpb > rows) rpb = rows;
    const long long grid = (rows + rpb - 1) / rpb;
    const size_t smem = (size_t)rpb * n * sizeof(W);
    cudaError_t err = cudaFuncSetAttribute(
        rows_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    rows_kernel<F><<<(unsigned)grid, threads_for(rpb * n), smem,
                     (cudaStream_t)stream>>>(
        f, (const W*)x, (const W*)tw, (const W*)mul, (W*)out, rows, b, lg,
        (int)rpb, in_rev, out_rev, out_t);
    return (int)cudaGetLastError();
}

// x, out: (B, n1, M); mul: (n1, M) or null; tw: [w^0 .. w^(n1/2-1)].
// Needs 1 <= lg <= 13 and M a power of two.
template <class F>
int launch_cols(F f, const void* x, const void* tw, const void* mul,
                void* out, long long batch, int lg, long long M,
                void* stream) {
    using W = typename F::word;
    if (lg < 1 || lg > LG_MAX || batch < 1 || M < 1 || (M & (M - 1)))
        return (int)cudaErrorInvalidValue;
    const int n = 1 << lg;
    long long C = n >= F::ELEMS ? 1 : F::ELEMS / n;
    if (C > M) C = M;
    int lgc = 0;
    while ((1LL << lgc) < C) ++lgc;
    const long long per_slice = M / C;
    const size_t smem = (size_t)C * n * sizeof(W);
    cudaError_t err = cudaFuncSetAttribute(
        cols_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    cols_kernel<F><<<(unsigned)(batch * per_slice), threads_for(C * n), smem,
                     (cudaStream_t)stream>>>(
        f, (const W*)x, (const W*)tw, (const W*)mul, (W*)out, lg, M, lgc,
        per_slice);
    return (int)cudaGetLastError();
}

}  // namespace narrow
