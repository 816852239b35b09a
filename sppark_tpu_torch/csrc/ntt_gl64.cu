// Goldilocks (p = 2^64 - 2^32 + 1) NTT kernels for Hopper (sm_90a).
//
// gl64_ntt_rows replaces sppark_tpu/ntt/pallas_kernels.py:_rows_kernel:
//   batched NTTs along the last axis of (OB, B, n), n = 2^lg <= 2^13, with
//   the input bit reversal (in_rev), an output bit reversal (out_rev), a
//   multiply of the result by a same-shape block (mul) and a transposed
//   store to (OB, n, B) (out_t).
// gl64_ntt_cols replaces sppark_tpu/ntt/pallas_kernels.py:_cols_kernel:
//   batched NTTs along axis -2 of (B, n1, M), with the four-step middle
//   twiddle matrix (n1, M) multiplied in the same pass (mul).
//
// Both read natural-order input, bit-reverse it on the load into shared
// memory, run all lg radix-2 Cooley-Tukey stages there with lazy
// arithmetic (any representative in [0, 2^64), the reference's
// GL64_PARTIALLY_REDUCED mode), and canonicalise once on the store.  Stage
// s (half-block h = 2^(s-1)) takes twiddle j from the compact power table
// [w^0 .. w^(n/2-1)] at index (j mod h) << (lg - s).
//
// What bounds them on the card: each element is read once and written once
// (plus the mul block), so the floor is device-memory bytes; the butterflies
// are ~20 32-bit integer operations each.  This first design keeps a whole
// transform in shared memory so HBM sees each element twice per pass; it
// pays a __syncthreads() per stage and shared-memory traffic per butterfly.
// A register-resident radix-2^k design (the reference's
// ct_mixed_radix_narrow.cu) is later work.  The column kernel takes C
// adjacent columns per block so every row read is C * 8 contiguous bytes;
// the transposed row store writes rows_per_block * 8 contiguous bytes.
//
// Each entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

// unsigned long long, not uint64_t: __ldg and __umul64hi are declared for it
using u64 = unsigned long long;

constexpr u64 P = 0xFFFFFFFF00000001ull;
constexpr u64 EPS = 0xFFFFFFFFull;        // 2^64 mod p
constexpr int MAX_THREADS = 512;
constexpr int ELEMS_PER_BLOCK = 8192;      // 64 KiB of shared memory

__device__ __forceinline__ u64 add_lazy(u64 a, u64 b) {
    u64 s = a + b;
    u64 m = s < a ? EPS : 0;               // carry: + 2^64 == + eps
    s += m;
    return s + (s < m ? EPS : 0);          // a second carry leaves s < 2^33
}

__device__ __forceinline__ u64 sub_lazy(u64 a, u64 b) {
    u64 d = a - b;
    u64 m = a < b ? EPS : 0;               // borrow: - 2^64 == - eps
    u64 d2 = d - m;
    return d2 - (d < m ? EPS : 0);
}

__device__ __forceinline__ u64 mul_lazy(u64 a, u64 b) {
    u64 lo = a * b;
    u64 hi = __umul64hi(a, b);
    u64 w3 = hi >> 32, w2 = hi & EPS;
    u64 r = lo - w3;                       // 2^96 == -1
    r -= lo < w3 ? EPS : 0;
    u64 u = (w2 << 32) - w2;               // w2 * 2^64 == w2 * eps
    u64 s = r + u;
    return s + (s < u ? EPS : 0);
}

__device__ __forceinline__ u64 canon(u64 x) {
    return x >= P ? x - P : x;
}

__device__ __forceinline__ int brev(int i, int lg) {
    return (int)(__brev((unsigned)i) >> (32 - lg));
}

// One block transforms `rpb` consecutive rows of length n = 2^lg, held
// in shared memory as s[r * n + i].
__global__ void rows_kernel(const u64* __restrict__ x,
                            const u64* __restrict__ tw,
                            const u64* __restrict__ mul,
                            u64* __restrict__ out,
                            long long rows, long long B, int lg, int rpb,
                            int in_rev, int out_rev, int out_t) {
    extern __shared__ u64 s[];
    const int n = 1 << lg;
    const long long row0 = (long long)blockIdx.x * rpb;
    const int nrows = (int)min((long long)rpb, rows - row0);
    const int total = nrows << lg;
    const u64* xb = x + row0 * n;

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
            const u64 w = __ldg(tw + ((long long)j << (lg - st)));
            const u64 a = s[i0];
            const u64 b = mul_lazy(s[i0 + h], w);
            s[i0] = add_lazy(a, b);
            s[i0 + h] = sub_lazy(a, b);
        }
        __syncthreads();
    }

    if (!out_t) {
        for (int e = threadIdx.x; e < total; e += blockDim.x) {
            const int i = e & (n - 1);
            const int src = out_rev ? brev(i, lg) : i;
            u64 v = canon(s[(e & ~(n - 1)) | src]);
            if (mul) v = canon(mul_lazy(v, __ldg(mul + row0 * n + e)));
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
        u64 v = canon(s[(r << lg) | src]);
        const long long row = row0 + r;
        if (mul) v = canon(mul_lazy(v, __ldg(mul + row * n + i)));
        const long long ob = row / B, b = row - ob * B;
        out[(ob * n + i) * B + b] = v;
    }
}

// One block transforms C = 2^lgc adjacent columns of one (n1, M) slice,
// held in shared memory row-major as s[i * C + c]; neighbouring threads
// take neighbouring columns.
__global__ void cols_kernel(const u64* __restrict__ x,
                            const u64* __restrict__ tw,
                            const u64* __restrict__ mul,
                            u64* __restrict__ out,
                            int lg, long long M, int lgc,
                            long long blocks_per_slice) {
    extern __shared__ u64 s[];
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
            const u64 w = __ldg(tw + ((long long)j << (lg - st)));
            const int k0 = (i0 << lgc) | c, k1 = ((i0 + h) << lgc) | c;
            const u64 a = s[k0];
            const u64 b = mul_lazy(s[k1], w);
            s[k0] = add_lazy(a, b);
            s[k1] = sub_lazy(a, b);
        }
        __syncthreads();
    }

    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int r = e >> lgc, c = e & (C - 1);
        u64 v = canon(s[e]);
        if (mul) v = canon(mul_lazy(v, __ldg(mul + col0 + r * M + c)));
        out[base + r * M + c] = v;
    }
}

int threads_for(int total) {
    int t = total / 2;
    if (t > MAX_THREADS) t = MAX_THREADS;
    if (t < 32) t = 32;
    return t;
}

}  // namespace

extern "C" {

// x, mul: (OB, B, n) natural order; out: (OB, B, n), or (OB, n, B) when
// out_t.  tw: [w^0 .. w^(n/2-1)].  mul may be null.  Needs 1 <= lg <= 13.
int gl64_ntt_rows(const void* x, const void* tw, const void* mul, void* out,
                  long long ob, long long b, int lg, int in_rev, int out_rev,
                  int out_t, void* stream) {
    if (lg < 1 || lg > 13 || ob < 1 || b < 1) return (int)cudaErrorInvalidValue;
    const int n = 1 << lg;
    const long long rows = ob * b;
    long long rpb = n >= ELEMS_PER_BLOCK ? 1 : ELEMS_PER_BLOCK / n;
    if (rpb > rows) rpb = rows;
    const long long grid = (rows + rpb - 1) / rpb;
    const size_t smem = (size_t)rpb * n * sizeof(u64);
    cudaError_t err = cudaFuncSetAttribute(
        rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    rows_kernel<<<(unsigned)grid, threads_for((int)(rpb * n)), smem,
                  (cudaStream_t)stream>>>(
        (const u64*)x, (const u64*)tw, (const u64*)mul,
        (u64*)out, rows, b, lg, (int)rpb, in_rev, out_rev, out_t);
    return (int)cudaGetLastError();
}

// x, out: (B, n1, M); mul: (n1, M) or null; tw: [w^0 .. w^(n1/2-1)].
// Needs 1 <= lg <= 13 and M a power of two.
int gl64_ntt_cols(const void* x, const void* tw, const void* mul, void* out,
                  long long batch, int lg, long long M, void* stream) {
    if (lg < 1 || lg > 13 || batch < 1 || M < 1 || (M & (M - 1)))
        return (int)cudaErrorInvalidValue;
    const int n = 1 << lg;
    long long C = n >= ELEMS_PER_BLOCK ? 1 : ELEMS_PER_BLOCK / n;
    if (C > M) C = M;
    int lgc = 0;
    while ((1LL << lgc) < C) ++lgc;
    const long long per_slice = M / C;
    const size_t smem = (size_t)C * n * sizeof(u64);
    cudaError_t err = cudaFuncSetAttribute(
        cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cols_kernel<<<(unsigned)(batch * per_slice), threads_for((int)(C * n)),
                  smem, (cudaStream_t)stream>>>(
        (const u64*)x, (const u64*)tw, (const u64*)mul,
        (u64*)out, lg, M, lgc, per_slice);
    return (int)cudaGetLastError();
}

}  // extern "C"
