// Batch inversion by Montgomery's trick in chunks, for Hopper (sm_90a):
// bigmont_inv_up and bigmont_inv_down, with bigmont.cu's bigmont_pow
// between them inverting one product per block.
//
// They replace what the JAX package composes from the Pallas kernel
// sppark_tpu/ff/bigmont.py:_ew_call_cached under XLA for a batch
// inversion: the product tree of sppark_tpu/ff/base.py:batch_inv_tree
// and the prefix/suffix scans of base.py:batch_inv, and in degree 2 the
// norm form of sppark_tpu/ff/ext.py:88-107 (1 / a = conj(a) / (a0^2 - nr
// a1^2)).  Here that was a Python loop of ~2 lg n bigmont_ew launches on
// strided views, each made contiguous first, plus the fp2 norm's plain
// adds: tens of launches a call, host time far above device time.  Three
// launches do it now, for any n:
//
//   bigmont_inv_up   each thread loads its chunk of C lanes, forms each
//                    lane's factor d (degree 1: the lane itself; degree 2:
//                    its norm, computed here and stored for the down
//                    kernel), takes a zero factor as one, and writes the
//                    chunk's inclusive prefix products; the block reduces
//                    its T thread products by a product tree in shared
//                    memory and writes them and its product;
//   bigmont_pow      x^(p - 2) of the n / (T C) block products;
//   bigmont_inv_down each block rebuilds its tree from the thread
//                    products, walks it down from the block's inverse (a
//                    child's inverse is its parent's times its sibling),
//                    so each thread holds u = 1 / (its chunk's product),
//                    then walks its chunk backward: lane j's inverse is
//                    u pre_(j-1), and u becomes u d_j.  Degree 2 writes
//                    (a0 inv, -a1 inv); a zero lane gets zero.
//
// A non-zero element's inverse is unique, so whatever order the products
// are taken in, the words equal the plain versions' and the JAX package's.
//
// Layout: the port's limb-major words, (deg n32, n) int32, c0's n32 words
// then c1's for degree 2.  Thread t of block b owns lanes b T C + j T + t,
// j < C, so every load and store of a word is coalesced across the warp.
// Scratch, allocated by the caller: pre (n32, n), the norms dn (n32, n)
// in degree 2, tp (n32, nb T) the thread products, blk (n32, nb) the block
// products, nb = ceil(n / (T C)).
//
// What bounds them on the card: the integer multiply rate.  Degree 1 does
// three products a lane (one up, two down) against 48 + 48 bytes up and
// 96 + 48 down at n32 = 12; degree 2 seven (two squarings and a product
// up, two products down and two for the conjugate).  The block's tree
// adds ~4 T products per T C lanes (one pass up, two down), the pow ~490
// products per T C lanes, one thread's chain: at a tree level's block
// count it runs as long as at one lane (~0.6 ms), the floor of a level.
//
// The entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>

#include "mont.cuh"

namespace {

// Measured at the trees' level 1 (sppark_tpu_torch/variants.py, PERF.md):
// T = 256, C = 16 beat 128 x 8 by 10% in degree 1 and 18% in degree 2; a
// longer chunk halves the block trees' share of the products.
constexpr int T = 256;      // threads a block
constexpr int C = 16;       // lanes a thread

template <int N>
using Fp = mont::Fp<N>;

template <int N>
__device__ __forceinline__ Fp<N> load(const uint32_t* __restrict__ p,
                                      long long stride, long long i) {
    Fp<N> r;
#pragma unroll
    for (int w = 0; w < N; w++) r.w[w] = p[w * stride + i];
    return r;
}

template <int N>
__device__ __forceinline__ void store(uint32_t* __restrict__ p,
                                      long long stride, long long i,
                                      const Fp<N>& v) {
#pragma unroll
    for (int w = 0; w < N; w++) p[w * stride + i] = v.w[w];
}

// The block's tree in shared memory, word-major so that neighbouring
// threads touch neighbouring banks: node k in [1, 2T), children 2k and
// 2k + 1, thread t's leaf at T + t, the root at 1.
template <int N>
__device__ __forceinline__ Fp<N> get(const uint32_t* sh, int k) {
    Fp<N> r;
#pragma unroll
    for (int w = 0; w < N; w++) r.w[w] = sh[w * 2 * T + k];
    return r;
}

template <int N>
__device__ __forceinline__ void put(uint32_t* sh, int k, const Fp<N>& v) {
#pragma unroll
    for (int w = 0; w < N; w++) sh[w * 2 * T + k] = v.w[w];
}

// The leaves T + t already written: every internal node, the root last.
template <int N>
__device__ __forceinline__ void build_tree(uint32_t* sh, int t,
                                           const mont::Consts<N>& c) {
    for (int h = T / 2; h >= 1; h /= 2) {
        __syncthreads();
        if (t < h)
            put<N>(sh, h + t, mont::mul(get<N>(sh, 2 * (h + t)),
                                        get<N>(sh, 2 * (h + t) + 1), c));
    }
}

// d = a0^2 - nr a1^2, the norm of a0 + a1 u (ff/ext.py:_inv_by_norm).
template <int N>
__device__ __forceinline__ Fp<N> norm(const Fp<N>& a0, const Fp<N>& a1,
                                      const mont::Consts<N>& c) {
    Fp<N> t0 = mont::sqr(a0, c);
    Fp<N> m = mont::times(mont::sqr(a1, c), c.nr < 0 ? -c.nr : c.nr, c);
    return c.nr < 0 ? mont::add(t0, m, c) : mont::sub(t0, m, c);
}

// The lanes of thread t's chunk that lie below n.
__device__ __forceinline__ int chunk_lanes(long long first, long long n) {
    if (first >= n) return 0;
    long long m = (n - first + T - 1) / T;
    return m < C ? (int)m : C;
}

template <int N, int DEG>
__global__ void __launch_bounds__(T)
inv_up(const uint32_t* __restrict__ x, uint32_t* __restrict__ pre,
       uint32_t* __restrict__ dn, uint32_t* __restrict__ tp,
       uint32_t* __restrict__ blk, long long n, mont::Consts<N> c) {
    __shared__ uint32_t sh[N * 2 * T];
    const int t = threadIdx.x;
    const long long first = (long long)blockIdx.x * T * C + t;
    const Fp<N> one = mont::from_words<N>(c.one);
    Fp<N> acc = one;
    const int m = chunk_lanes(first, n);
#pragma unroll 1
    for (int j = 0; j < m; j++) {
        const long long i = first + (long long)j * T;
        Fp<N> d;
        if constexpr (DEG == 1) {
            d = load<N>(x, n, i);
        } else {
            d = norm(load<N>(x, n, i), load<N>(x + N * n, n, i), c);
            store<N>(dn, n, i, d);
        }
        d = mont::select(mont::is_zero(d), one, d);
        acc = j ? mont::mul(acc, d, c) : d;
        store<N>(pre, n, i, acc);
    }
    store<N>(tp, (long long)gridDim.x * T, (long long)blockIdx.x * T + t,
             acc);
    put<N>(sh, T + t, acc);
    build_tree<N>(sh, t, c);
    if (t == 0) store<N>(blk, gridDim.x, blockIdx.x, get<N>(sh, 1));
}

template <int N, int DEG>
__global__ void __launch_bounds__(T)
inv_down(const uint32_t* __restrict__ x, const uint32_t* __restrict__ pre,
         const uint32_t* __restrict__ dn, const uint32_t* __restrict__ tp,
         const uint32_t* __restrict__ blkinv, uint32_t* __restrict__ out,
         long long n, mont::Consts<N> c) {
    __shared__ uint32_t sh[N * 2 * T];
    const int t = threadIdx.x;
    const long long first = (long long)blockIdx.x * T * C + t;
    const Fp<N> one = mont::from_words<N>(c.one);
    put<N>(sh, T + t, load<N>(tp, (long long)gridDim.x * T,
                              (long long)blockIdx.x * T + t));
    build_tree<N>(sh, t, c);
    // thread 0 wrote the root: it replaces it by the root's inverse
    if (t == 0) put<N>(sh, 1, load<N>(blkinv, gridDim.x, blockIdx.x));
    for (int h = 1; h < T; h *= 2) {
        __syncthreads();
        const int k = 2 * h + t;
        Fp<N> r;
        if (t < 2 * h) r = mont::mul(get<N>(sh, k >> 1), get<N>(sh, k ^ 1), c);
        __syncthreads();
        if (t < 2 * h) put<N>(sh, k, r);
    }
    __syncthreads();
    Fp<N> u = get<N>(sh, T + t);        // 1 / (this thread's chunk product)
#pragma unroll 1
    for (int j = chunk_lanes(first, n) - 1; j >= 0; j--) {
        const long long i = first + (long long)j * T;
        const Fp<N> d = load<N>(DEG == 1 ? x : dn, n, i);
        const bool zero = mont::is_zero(d);
        Fp<N> inv = u;
        if (j) {
            inv = mont::mul(u, load<N>(pre, n, i - T), c);
            u = mont::mul(u, mont::select(zero, one, d), c);
        }
        if constexpr (DEG == 1) {
            store<N>(out, n, i, mont::select(zero, mont::zero<N>(), inv));
        } else {
            // a zero lane has a0 = a1 = 0, so both products are zero
            store<N>(out, n, i, mont::mul(load<N>(x, n, i), inv, c));
            store<N>(out + N * n, n, i,
                     mont::sub(mont::zero<N>(),
                               mont::mul(load<N>(x + N * n, n, i), inv, c),
                               c));
        }
    }
}

unsigned blocks(long long n) { return (unsigned)((n + T * C - 1) / (T * C)); }

template <int N, int DEG>
void launch_up(const uint32_t* x, uint32_t* pre, uint32_t* dn, uint32_t* tp,
               uint32_t* blk, long long n, const uint32_t* consts,
               cudaStream_t s) {
    inv_up<N, DEG><<<blocks(n), T, 0, s>>>(x, pre, dn, tp, blk, n,
                                           mont::make_consts<N>(consts));
}

template <int N, int DEG>
void launch_down(const uint32_t* x, const uint32_t* pre, const uint32_t* dn,
                 const uint32_t* tp, const uint32_t* blkinv, uint32_t* out,
                 long long n, const uint32_t* consts, cudaStream_t s) {
    inv_down<N, DEG><<<blocks(n), T, 0, s>>>(x, pre, dn, tp, blkinv, out, n,
                                             mont::make_consts<N>(consts));
}

// f<N, DEG>(args...) for the runtime n32 and degree; false if neither fits.
#define INV_DISPATCH(f, ...)                                                \
    switch (n32 * 10 + degree) {                                            \
        case 21: f<2, 1>(__VA_ARGS__); break;                               \
        case 22: f<2, 2>(__VA_ARGS__); break;                               \
        case 81: f<8, 1>(__VA_ARGS__); break;                               \
        case 82: f<8, 2>(__VA_ARGS__); break;                               \
        case 121: f<12, 1>(__VA_ARGS__); break;                             \
        case 122: f<12, 2>(__VA_ARGS__); break;                             \
        default: return (int)cudaErrorInvalidValue;                         \
    }

}  // namespace

// x (degree n32, n) -> the scratch above.  threads and chunk must be this
// build's T and C (the caller sizes the scratch by them).  dn is written
// in degree 2 only.  consts: the host array [p, one, a4, m0, nr]
// (ff/kernels.py:field_consts), nr the fp2 nonresidue in degree 2.
extern "C" int bigmont_inv_up(int n32, int degree, int threads, int chunk,
                              const void* x, void* pre, void* dn, void* tp,
                              void* blk, long long n, const void* consts,
                              void* stream) {
    if (threads != T || chunk != C) return (int)cudaErrorInvalidValue;
    auto s = static_cast<cudaStream_t>(stream);
    INV_DISPATCH(launch_up, static_cast<const uint32_t*>(x),
                 static_cast<uint32_t*>(pre), static_cast<uint32_t*>(dn),
                 static_cast<uint32_t*>(tp), static_cast<uint32_t*>(blk), n,
                 static_cast<const uint32_t*>(consts), s)
    return (int)cudaGetLastError();
}

// The scratch of bigmont_inv_up and blkinv (n32, nb), the block products'
// inverses -> out (degree n32, n), the inverses (zero for a zero lane).
extern "C" int bigmont_inv_down(int n32, int degree, int threads, int chunk,
                                const void* x, const void* pre,
                                const void* dn, const void* tp,
                                const void* blkinv, void* out, long long n,
                                const void* consts, void* stream) {
    if (threads != T || chunk != C) return (int)cudaErrorInvalidValue;
    auto s = static_cast<cudaStream_t>(stream);
    INV_DISPATCH(launch_down, static_cast<const uint32_t*>(x),
                 static_cast<const uint32_t*>(pre),
                 static_cast<const uint32_t*>(dn),
                 static_cast<const uint32_t*>(tp),
                 static_cast<const uint32_t*>(blkinv),
                 static_cast<uint32_t*>(out), n,
                 static_cast<const uint32_t*>(consts), s)
    return (int)cudaGetLastError();
}
