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
// An element is N 32-bit words in Montgomery form, canonical in and out of
// every operation, so the stored words are the TPU kernels' words exactly.
// The row and column passes run on the carry-chain element mont::FpCC<N>
// (mont_cc.cuh), which needs a spare bit at N >= 4 (every N = 8 NTT field
// has one; the entry points refuse a p without it), the mid pass on
// mont::Fp<N> (mont.cuh).  N is 2 or 8.
//
// What bounds them on the card: a butterfly's product is ~2 N^2 32x32->64
// multiplies against 8 N bytes of device memory per element and pass, so
// at N = 8 they are bound by integer operations, not by bytes.  A block
// holds one tile of at most 2^11 elements (64 KiB at N = 8) in shared
// memory: one transform, a few rows, or C adjacent columns (C * 4 bytes
// per row read: C = 8 fills a 32-byte sector).  What the design cuts is
// the instructions and the waits around the products:
//   - the element: mont::FpCC's products on PTX carry chains, about 0.4 of
//     mont::Fp's instructions;
//   - radix 2^RADIX_LG: a thread loads 2^RADIX_LG elements of the tile into
//     registers, runs RADIX_LG radix-2 stages on them and stores them back,
//     one __syncthreads() a pass instead of one a stage;
//   - the first pass's twiddles are known at compile time: the products by
//     w^0 = 1 (all of stage 1, half of stage 2, ...) are left out, which
//     is the same canonical word (7 of its 12 products at radix 8);
//   - twiddles from a stage-major table in shared memory (stage h's
//     w_2h^j at h - 1 + j, filled once a block from the power table), so
//     the lanes of a warp read neighbouring or equal words;
//   - the tile's words sit at an XOR swizzle (swz) of their index, so the
//     bit-reversed scatter, the strided groups of the early passes and the
//     column layout fall on distinct banks across a warp.
//
// Each entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "mont_cc.cuh"

namespace {

using mont::Consts;
using mont::Fp;
using mont::FpCC;

constexpr int THREADS = 256;
constexpr int LG_TILE = 11;
constexpr int TILE = 1 << LG_TILE;       // elements of one block's tile
constexpr int RADIX_LG = 3;              // stages a thread runs per pass

__device__ __forceinline__ int brev(int i, int lg) {
    return (int)(__brev((unsigned)i) >> (32 - lg));
}

// The shared-memory slot of tile element i: i with its low 5 bits XORed by
// a function of the bits above them, a permutation within each run of 32
// words.  Over a warp it maps to 32 distinct banks: 32 consecutive
// elements; 32 groups of 8 consecutive ones (the first pass); 4 x 8 of a
// stride of 64 (the second pass, C = 8 columns of 4 rows); and the
// bit-reversed scatter of 32 consecutive elements at lg 10 and of 4 rows x
// 8 columns at lg 8.
__device__ __forceinline__ int swz(int i) {
    const int h = i >> 5;
    return i ^ ((h & 7) | ((((h >> 1) ^ (h >> 3) ^ (h >> 5)) & 3) << 3));
}

// element i of a limb-major array whose limb planes are `plane` apart
template <template <int> class E, int N>
__device__ __forceinline__ E<N> gload(const uint32_t* __restrict__ p,
                                      long long plane, long long i) {
    E<N> r;
#pragma unroll
    for (int k = 0; k < N; k++) r.w[k] = __ldg(p + k * plane + i);
    return r;
}

template <template <int> class E, int N>
__device__ __forceinline__ void gstore(uint32_t* __restrict__ p,
                                       long long plane, long long i,
                                       const E<N>& v) {
#pragma unroll
    for (int k = 0; k < N; k++) p[k * plane + i] = v.w[k];
}

// the tile (limb planes P apart, swizzled) and the twiddle table (planes
// Q apart, not swizzled)
template <int N>
__device__ __forceinline__ FpCC<N> sload(const uint32_t* s, int P, int a) {
    FpCC<N> r;
#pragma unroll
    for (int k = 0; k < N; k++) r.w[k] = s[k * P + a];
    return r;
}

template <int N>
__device__ __forceinline__ void sstore(uint32_t* s, int P, int a,
                                       const FpCC<N>& v) {
#pragma unroll
    for (int k = 0; k < N; k++) s[k * P + a] = v.w[k];
}

// u, v = u + w v, u - w v; w = 1 (no product) when ONE
template <int N, bool ONE>
__device__ __forceinline__ void bfly(FpCC<N>& u, FpCC<N>& v,
                                     const FpCC<N>& w, const Consts<N>& c) {
    const FpCC<N> t = ONE ? v : mont::mul(v, w, c);
    v = mont::sub(u, t, c);
    u = mont::add(u, t, c);
}

// The tile's stage-major twiddle table, entries 1 .. n - 2: stage h's
// w_2h^j = tw[j n / 2h] at h - 1 + j (entry 0, w^0, is never read).
template <int N>
__device__ __forceinline__ void fill_twiddles(uint32_t* t, int Q,
                                              const uint32_t* __restrict__ tw,
                                              int lg) {
    const int half_n = 1 << (lg - 1);
    for (int q = threadIdx.x + 1; q < 2 * half_n - 1; q += blockDim.x) {
        const int lh = 31 - __clz(q + 1);          // h = 2^lh
        const int j = q + 1 - (1 << lh);
#pragma unroll
        for (int k = 0; k < N; k++)
            t[k * Q + q] = __ldg(tw + k * half_n + (j << (lg - 1 - lh)));
    }
}

// One pass: the K stages st0 .. st0 + K - 1 (stage st pairs elements
// h = 2^(st - 1) apart) over the tile's transforms of length 2^lg, each
// held at element (r 2^lg + pos) C + col for col < C = 2^lgc.  A group is
// the 2^K elements pos = hi 2^(st0 - 1 + K) + m 2^(st0 - 1) + lo of one
// transform and column; consecutive groups take consecutive col, then lo.
// FIRST: st0 = 1, lo = 0, so every twiddle index is known here.
template <int N, int K, bool FIRST>
__device__ __forceinline__ void pass(uint32_t* s, int P, const uint32_t* t,
                                     int Q, int groups, int lg, int lgc,
                                     int st0, const Consts<N>& c) {
    const int sh = FIRST ? 0 : st0 - 1;
    const int h0 = 1 << sh;
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
        const int col = g & ((1 << lgc) - 1);
        const int q = g >> lgc;
        const int lo = FIRST ? 0 : q & (h0 - 1);
        const int hi = (q & ((1 << (lg - K)) - 1)) >> sh;
        const int r = q >> (lg - K);
        const int base = (((r << lg) | (hi << (sh + K)) | lo) << lgc) | col;
        const int stride = h0 << lgc;
        FpCC<N> x[1 << K];
#pragma unroll
        for (int m = 0; m < (1 << K); m++)
            x[m] = sload<N>(s, P, swz(base + m * stride));
#pragma unroll
        for (int sg = 0; sg < K; sg++) {
            const int hs = 1 << sg;
            // the pairs (m, m + hs) whose twiddle index is lo + jm h0
#pragma unroll
            for (int jm = 0; jm < hs; jm++) {
                if (FIRST && jm == 0) {
#pragma unroll
                    for (int m = 0; m < (1 << K); m += 2 * hs)
                        bfly<N, true>(x[m], x[m + hs], x[m], c);
                    continue;
                }
                const FpCC<N> w =
                    sload<N>(t, Q, (h0 << sg) - 1 + lo + jm * h0);
#pragma unroll
                for (int m = jm; m < (1 << K); m += 2 * hs)
                    bfly<N, false>(x[m], x[m + hs], w, c);
            }
        }
#pragma unroll
        for (int m = 0; m < (1 << K); m++)
            sstore<N>(s, P, swz(base + m * stride), x[m]);
    }
}

// The pass of k <= K stages from st0 (k is known only at run time: the
// last pass takes what is left).
template <int N, int K>
__device__ __forceinline__ void pass_of(int k, uint32_t* s, int P,
                                        const uint32_t* t, int Q, int total,
                                        int lg, int lgc, int st0,
                                        const Consts<N>& c) {
    if (k < K) {
        if constexpr (K > 1)
            pass_of<N, K - 1>(k, s, P, t, Q, total, lg, lgc, st0, c);
    } else if (st0 == 1) {
        pass<N, K, true>(s, P, t, Q, total >> K, lg, lgc, st0, c);
    } else {
        pass<N, K, false>(s, P, t, Q, total >> K, lg, lgc, st0, c);
    }
}

// Every stage of the tile's transforms, RADIX_LG a pass; the tile and the
// table are filled, and the block synchronised, before, and the block is
// synchronised after.
template <int N>
__device__ __forceinline__ void stages(uint32_t* s, int P, const uint32_t* t,
                                       int Q, int total, int lg, int lgc,
                                       const Consts<N>& c) {
    for (int st0 = 1; st0 <= lg; st0 += RADIX_LG) {
        pass_of<N, RADIX_LG>(min(RADIX_LG, lg - st0 + 1), s, P, t, Q, total,
                             lg, lgc, st0, c);
        __syncthreads();
    }
}

__host__ __device__ inline int round32(int v) { return (v + 31) & ~31; }

// One block transforms `rpb` consecutive rows of length n = 2^lg, held in
// the tile as element r n + i, planes P = round32(rpb n) apart; the
// twiddle table follows at n - 1 entries a plane.
template <int N>
__global__ void __launch_bounds__(THREADS, 2)
rows_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
            const uint32_t* __restrict__ mul, uint32_t* __restrict__ out,
            long long rows, long long B, int lg, int rpb, int in_rev,
            int out_rev, int out_t, Consts<N> c) {
    extern __shared__ uint32_t s[];
    const int n = 1 << lg;
    const int P = round32(rpb << lg);
    uint32_t* t = s + N * P;
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
            s[k * P + swz(d)] = __ldg(x + k * plane + e0 + e);
    }
    fill_twiddles<N>(t, n - 1, tw, lg);
    __syncthreads();
    stages<N>(s, P, t, n - 1, total, lg, 0, c);

    if (!out_t) {
        for (int e = threadIdx.x; e < total; e += blockDim.x) {
            const int i = e & (n - 1);
            FpCC<N> v = sload<N>(s, P, swz((e & ~(n - 1)) |
                                           (out_rev ? brev(i, lg) : i)));
            if (mul) v = mont::mul(v, gload<FpCC, N>(mul, plane, e0 + e), c);
            gstore<FpCC, N>(out, plane, e0 + e, v);
        }
        return;
    }
    // transposed store: out[ob, i, b] = y[ob, b, i]; the row index runs
    // fastest so that neighbouring threads write neighbouring words
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int r = e % nrows;
        const int i = e / nrows;
        FpCC<N> v = sload<N>(s, P, swz((r << lg) |
                                       (out_rev ? brev(i, lg) : i)));
        const long long row = row0 + r;
        if (mul)
            v = mont::mul(v, gload<FpCC, N>(mul, plane, (row << lg) + i), c);
        const long long ob = row / B, b = row - ob * B;
        gstore<FpCC, N>(out, plane, (ob * n + i) * B + b, v);
    }
}

// One block transforms C = 2^lgc adjacent columns of one (n1, M) slice,
// held in the tile as element r C + col, planes P = round32(n1 C) apart;
// neighbouring threads take neighbouring columns.
template <int N>
__global__ void __launch_bounds__(THREADS, 2)
cols_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
            uint32_t* __restrict__ out, int lg, long long M, int lgc,
            long long blocks_per_slice, long long plane, Consts<N> c) {
    extern __shared__ uint32_t s[];
    const int n = 1 << lg;
    const int C = 1 << lgc;
    const int T = n << lgc;
    const int P = round32(T);
    uint32_t* t = s + N * P;
    const long long slice = blockIdx.x / blocks_per_slice;
    const long long col0 = (blockIdx.x - slice * blocks_per_slice) * C;
    const long long base = slice * n * M + col0;

    for (int e = threadIdx.x; e < T; e += blockDim.x) {
        const int r = e >> lgc, col = e & (C - 1);
        const int d = (brev(r, lg) << lgc) | col;
#pragma unroll
        for (int k = 0; k < N; k++)
            s[k * P + swz(d)] = __ldg(x + k * plane + base + r * M + col);
    }
    fill_twiddles<N>(t, n - 1, tw, lg);
    __syncthreads();
    stages<N>(s, P, t, n - 1, T, lg, lgc, c);

    for (int e = threadIdx.x; e < T; e += blockDim.x) {
        const int r = e >> lgc, col = e & (C - 1);
        gstore<FpCC, N>(out, plane, base + r * M + col,
                        sload<N>(s, P, swz(e)));
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
    Fp<N> v = gload<Fp, N>(x, total, e);
    v = mont::mul(v, gload<Fp, N>(a, 1LL << (lg1 + lga), ia), c);
    v = mont::mul(v, gload<Fp, N>(b, 1LL << (lg1 + lgb), ib), c);
    gstore<Fp, N>(out, total, e, v);
}

int threads_for(long long elems) {
    long long t = elems / 2;
    if (t > THREADS) t = THREADS;
    if (t < 32) t = 32;
    return (int)t;
}

// the tile of `elems` elements and the twiddle table of a transform of 2^lg
template <int N>
size_t tile_bytes(long long elems, int lg) {
    return (size_t)N * 4 * (round32((int)elems) + (1 << lg) - 1);
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
    const size_t smem = tile_bytes<N>(rpb * n, lg);
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
    const size_t smem = tile_bytes<N>(C * n, lg);
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
// Needs 1 <= lg <= 11, n32 of 2 or 8, and p's top bit clear at n32 8.
int bigmont_ntt_rows(int n32, const void* x, const void* tw, const void* mul,
                     void* out, long long ob, long long b, int lg,
                     int in_rev, int out_rev, int out_t, const void* consts,
                     void* stream) {
    auto C = static_cast<const uint32_t*>(consts);
    if (lg < 1 || lg > LG_TILE || ob < 1 || b < 1 ||
        !mont::spare_bit(n32, C))
        return (int)cudaErrorInvalidValue;
    auto X = static_cast<const uint32_t*>(x);
    auto W = static_cast<const uint32_t*>(tw);
    auto Mu = static_cast<const uint32_t*>(mul);
    auto O = static_cast<uint32_t*>(out);
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
// Needs 1 <= lg <= 11, M a power of two, and p's top bit clear at n32 8.
int bigmont_ntt_cols(int n32, const void* x, const void* tw, void* out,
                     long long batch, int lg, long long M, const void* consts,
                     void* stream) {
    auto C = static_cast<const uint32_t*>(consts);
    if (lg < 1 || lg > LG_TILE || batch < 1 || !pow2(M) ||
        !mont::spare_bit(n32, C))
        return (int)cudaErrorInvalidValue;
    auto X = static_cast<const uint32_t*>(x);
    auto W = static_cast<const uint32_t*>(tw);
    auto O = static_cast<uint32_t*>(out);
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
