// The point kernels' body and launch, shared by ec_xyzz.cu and
// ec_pair.cu (G1) and ec_fp2_*.cu (G2): one point (or pair) per thread, or
// per lane pair of threads (Elem<E>::THREADS), the formulas of xyzz.cuh and
// pair.cuh.  The G1 madd and add run on the carry-chain element
// (mont::FpCC<N>, mont_cc.cuh), the G1 dbl and pair kernels on mont::Fp<N>.
// The G2 madd, add and pair finish run on the lane pair (mont::Fp2Pair<N>:
// thread 2i holds c0 of lane i, thread 2i + 1 holds c1); the G2 dbl and
// pair prep keep one thread a lane (mont::Fp2<N>).
//
// Operands: each input coordinate is a (W, n) view, W = N words for Fp<N>
// and 2 N for the fp2 elements (c0's words, then c1's), given by a pointer
// and two strides in words, `sw` between words and `sl` between lanes, so
// the kernels read limb-major tensors (sw = n, sl = 1), point-major rows of
// the MSM's slab or of the tree's level 0 (sw = 1, sl = 2 W; the even or
// odd rows: sl = 4 W), the even or odd lanes of a tree level (sw = m,
// sl = 2) and broadcast constants (sl = 0) without a copy; the finish's
// flag word is a view of one word.  The madd's affine point may be a table
// read through an index (the slab MSM's gather, fused into the load): lane
// i then reads row idx[i] of the view, 16 bytes at a time where the rows
// are point-major and aligned (sw = 1; a G1 row at n32 = 12 is 96 bytes,
// three full sectors), so the MSM writes and reads back no slab of points.
// The output is one contiguous (rows, n)
// block, stored coalesced: (4 W, n) for the xyzz ops, den then the flags,
// (W + 1, n), for the pair prep, (x, y), (2 W, n), for the pair finish.
//
// The lane-pair finish on a tree's first level, whose four point operands
// are the even and odd point-major rows of level 0 (lane i's x1, y1, x2,
// y2 are 4 W contiguous words), first copies the block's tile of rows into
// shared memory with coalesced 16-byte cp.async copies, each row padded by
// 16 bytes so that a warp's reads spread over the banks; each thread then
// reads its coefficient's words from there.  Read straight from the rows,
// the 16 lanes of a warp hit 16 places 8 N words apart on every word.
//
// Each entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#pragma once

#include <cuda_runtime.h>

#include "mont_cc.cuh"
#include "pair.cuh"
#include "xyzz.cuh"

namespace ec {

constexpr int THREADS = 128;

struct View {
    const uint32_t* p;
    long long sw, sl;
    const int32_t* idx;     // a table's index: lane i reads row idx[i]
    long long rows;         // the table's rows: an index past them traps
    bool vec;               // sw == 1, p and every row 16-byte aligned
};

enum Op { MADD = 0, ADD = 1, DBL = 2, PAIR_PREP = 3, PAIR_FINISH = 4 };

template <int N>
struct Args {
    View in[8];
    uint32_t* out;
    long long n;
    mont::Consts<N> c;
    bool rows;      // the finish's point operands are contiguous rows
};

// N words of an element, from its word w0: lane i's, or for the madd's
// affine point (TABLE) row idx[i] of the table where the view has an index
template <bool TABLE, int N>
__device__ __forceinline__ void load_words(const View& v, long long i,
                                           int w0, uint32_t* r) {
    if constexpr (TABLE) {
        long long row = v.idx ? (long long)__ldg(v.idx + i) : i;
        // as PyTorch's own index kernels do: a bad index stops the kernel
        if (v.idx && (unsigned long long)row >= (unsigned long long)v.rows)
            __trap();
        const uint32_t* at = v.p + row * v.sl + w0 * v.sw;
        if constexpr (N % 4 == 0) {
            if (v.vec) {
#pragma unroll
                for (int q = 0; q < N / 4; q++) {
                    uint4 x = __ldg(reinterpret_cast<const uint4*>(at) + q);
                    r[4 * q] = x.x;
                    r[4 * q + 1] = x.y;
                    r[4 * q + 2] = x.z;
                    r[4 * q + 3] = x.w;
                }
                return;
            }
        }
#pragma unroll
        for (int w = 0; w < N; w++) r[w] = at[w * v.sw];
    } else {
#pragma unroll
        for (int w = 0; w < N; w++) r[w] = v.p[(w0 + w) * v.sw + i * v.sl];
    }
}

template <bool TABLE = false, int N>
__device__ __forceinline__ void load(const View& v, long long i, int w0,
                                     mont::Fp<N>& r) {
    load_words<TABLE, N>(v, i, w0, r.w);
}

template <bool TABLE = false, int N>
__device__ __forceinline__ void load(const View& v, long long i, int w0,
                                     mont::FpCC<N>& r) {
    load_words<TABLE, N>(v, i, w0, r.w);
}

template <bool TABLE = false, int N>
__device__ __forceinline__ void load(const View& v, long long i, int w0,
                                     mont::Fp2<N>& r) {
    load<TABLE>(v, i, w0, r.c0);
    load<TABLE>(v, i, w0 + N, r.c1);
}

// a lane pair: the even thread reads c0's words, the odd thread c1's
template <bool TABLE = false, int N>
__device__ __forceinline__ void load(const View& v, long long i, int w0,
                                     mont::Fp2Pair<N>& r) {
    load<TABLE>(v, i, w0 + (mont::pair_odd() ? N : 0), r.v);
}

template <class E, bool TABLE = false>
__device__ __forceinline__ E load(const View& v, long long i) {
    E r;
    load<TABLE>(v, i, 0, r);
    return r;
}

template <class E>
__device__ __forceinline__ xyzz::Point<E> load_point(const View* v,
                                                     long long i) {
    return xyzz::Point<E>{load<E>(v[0], i), load<E>(v[1], i),
                          load<E>(v[2], i), load<E>(v[3], i)};
}

// word w0 + w of the element at row `row` of the (rows, n) output
template <int N>
__device__ __forceinline__ void store(uint32_t* out, long long n, long long i,
                                      long long row, const mont::Fp<N>& a) {
#pragma unroll
    for (int w = 0; w < N; w++) out[(row + w) * n + i] = a.w[w];
}

template <int N>
__device__ __forceinline__ void store(uint32_t* out, long long n, long long i,
                                      long long row, const mont::FpCC<N>& a) {
#pragma unroll
    for (int w = 0; w < N; w++) out[(row + w) * n + i] = a.w[w];
}

template <int N>
__device__ __forceinline__ void store(uint32_t* out, long long n, long long i,
                                      long long row, const mont::Fp2<N>& a) {
    store(out, n, i, row, a.c0);
    store(out, n, i, row + N, a.c1);
}

template <int N>
__device__ __forceinline__ void store(uint32_t* out, long long n, long long i,
                                      long long row,
                                      const mont::Fp2Pair<N>& a) {
    store(out, n, i, row + (mont::pair_odd() ? N : 0), a.v);
}

// 16 bytes from global to shared memory, asynchronously (cp.async; the
// caller waits with copy_wait)
__device__ __forceinline__ void copy16(uint32_t* dst, const uint32_t* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void copy_wait() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
}

// an element from shared memory: this thread's N words at t, read 16
// bytes at a time where N allows
template <int N>
__device__ __forceinline__ mont::Fp2Pair<N> load_tile(const uint32_t* t) {
    mont::Fp2Pair<N> r;
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int q = 0; q < N / 4; q++) {
            uint4 v = reinterpret_cast<const uint4*>(t)[q];
            r.v.w[4 * q] = v.x;
            r.v.w[4 * q + 1] = v.y;
            r.v.w[4 * q + 2] = v.z;
            r.v.w[4 * q + 3] = v.w;
        }
    } else {
        r.v = mont::from_words<N>(t);
    }
    return r;
}

// the pair finish of lane i from its point operands: inv and the flag
// word from their views, (x, y) to the output
template <class E>
__device__ __forceinline__ void finish(const Args<mont::Elem<E>::BASE>& a,
                                       long long i, const E& x1, const E& y1,
                                       const E& x2, const E& y2) {
    constexpr long long W = mont::Elem<E>::WORDS;
    E ox, oy;
    pair::finish(x1, y1, x2, y2, load<E>(a.in[4], i),
                 a.in[5].p[i * a.in[5].sl], ox, oy, a.c);
    store(a.out, a.n, i, 0, ox);
    store(a.out, a.n, i, W, oy);
}

// The body of every point kernel.
template <class E, int OP>
__device__ __forceinline__ void point_op(
    const Args<mont::Elem<E>::BASE>& a) {
    // lane i: one thread, or the lane pair (2i, 2i + 1), which exits or
    // runs on together
    constexpr int T = mont::Elem<E>::THREADS;
    long long i = ((long long)blockIdx.x * THREADS + threadIdx.x) / T;
    constexpr long long W = mont::Elem<E>::WORDS;
    if constexpr (OP == PAIR_FINISH && T == 2) {
        // the block's LANES rows of 4 W words, each padded by 4 words
        constexpr int N = mont::Elem<E>::BASE, LANES = THREADS / T;
        constexpr int R = 4 * W, S = R + 4;
        __shared__ __align__(16) uint32_t tile[LANES * S];
        if (a.rows) {
            long long i0 = (long long)blockIdx.x * LANES;
            long long lanes = a.n - i0 < LANES ? a.n - i0 : LANES;
            const uint32_t* src = a.in[0].p + i0 * R;
            for (int k = threadIdx.x; k < lanes * (R / 4); k += THREADS)
                copy16(tile + (k / (R / 4)) * S + (k % (R / 4)) * 4,
                       src + 4 * k);
            copy_wait();
            __syncthreads();
            if (i >= a.n) return;
            const uint32_t* t = tile + (threadIdx.x / T) * S +
                                (mont::pair_odd() ? N : 0);
            finish<E>(a, i, load_tile<N>(t), load_tile<N>(t + W),
                      load_tile<N>(t + 2 * W), load_tile<N>(t + 3 * W));
            return;
        }
    }
    if (i >= a.n) return;
    if (OP == PAIR_PREP) {
        E den;
        uint32_t f = pair::prep(load<E>(a.in[0], i), load<E>(a.in[1], i),
                                load<E>(a.in[2], i), load<E>(a.in[3], i),
                                den, a.c);
        store(a.out, a.n, i, 0, den);
        a.out[W * a.n + i] = f;
        return;
    }
    if (OP == PAIR_FINISH) {
        finish<E>(a, i, load<E>(a.in[0], i), load<E>(a.in[1], i),
                  load<E>(a.in[2], i), load<E>(a.in[3], i));
        return;
    }
    xyzz::Point<E> r;
    if (OP == MADD) {
        r = xyzz::madd(load_point<E>(a.in, i), load<E, true>(a.in[4], i),
                       load<E, true>(a.in[5], i), a.c);
    } else if (OP == ADD) {
        r = xyzz::add(load_point<E>(a.in, i), load_point<E>(a.in + 4, i),
                      a.c);
    } else {
        r = xyzz::dbl(load_point<E>(a.in, i), a.c);
    }
    store(a.out, a.n, i, 0 * W, r.x);
    store(a.out, a.n, i, 1 * W, r.y);
    store(a.out, a.n, i, 2 * W, r.zz);
    store(a.out, a.n, i, 3 * W, r.zzz);
}

// __launch_bounds__ gives ptxas no minimum of blocks an SM, so it picks
// each kernel's registers itself.  A minimum of 1, 3 or 4 blocks was timed
// on the H100 (variants.py, PERF.md): none ran faster than ptxas's own
// choice for the lane-pair add and finish or the G1 madd on mont::Fp.
template <class E, int OP>
__global__ void __launch_bounds__(THREADS)
ec_kernel(const __grid_constant__ Args<mont::Elem<E>::BASE> a) {
    point_op<E, OP>(a);
}

template <class E>
constexpr bool carry_chains = false;
template <int N>
constexpr bool carry_chains<mont::FpCC<N>> = true;

namespace min3 {
// The G1 madd and add on the carry-chain element ask for 3 blocks an SM:
// ptxas then fits them in 168 registers with a few spilled words, where
// it picks 178 and 212 (2 blocks an SM), and they ran 7% and 12% faster
// on the H100 (variants.py, PERF.md).
template <class E, int OP>
__global__ void __launch_bounds__(THREADS, 3)
ec_kernel(const __grid_constant__ Args<mont::Elem<E>::BASE> a) {
    point_op<E, OP>(a);
}
}  // namespace min3

template <class E, int OP>
void launch(const long long* views, int n_in, uint32_t* out, long long n,
            const uint32_t* consts, cudaStream_t s) {
    constexpr int N = mont::Elem<E>::BASE;
    Args<N> a;
    for (int k = 0; k < 8; k++) {
        const long long* v = views + 5 * k;
        bool used = k < n_in;
        a.in[k].p = used ? (const uint32_t*)v[0] : nullptr;
        a.in[k].sw = used ? v[1] : 0;
        a.in[k].sl = used ? v[2] : 0;
        a.in[k].idx = used ? (const int32_t*)v[3] : nullptr;
        a.in[k].rows = used ? v[4] : 0;
        a.in[k].vec = used && v[1] == 1 && (v[0] & 15) == 0 &&
                      (v[2] * 4) % 16 == 0;
    }
    a.out = out;
    a.n = n;
    a.c = mont::make_consts<N>(consts);
    // the lane-pair finish stages level 0's rows: x1, y1, x2, y2 of lane i
    // at in[0].p + 4 W i, 16-byte aligned
    constexpr long long W = mont::Elem<E>::WORDS;
    a.rows = OP == PAIR_FINISH && mont::Elem<E>::THREADS == 2 &&
             (views[0] & 15) == 0;
    for (int k = 0; k < 4; k++)
        a.rows = a.rows && views[5 * k] == views[0] + 4 * k * W &&
                 views[5 * k + 1] == 1 && views[5 * k + 2] == 4 * W;
    long long threads = n * mont::Elem<E>::THREADS;
    unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
    if constexpr (carry_chains<E>)
        min3::ec_kernel<E, OP><<<blocks, THREADS, 0, s>>>(a);
    else
        ec_kernel<E, OP><<<blocks, THREADS, 0, s>>>(a);
}

// The launch for base width n32 of element family F (mont::Fp,
// mont::FpCC, mont::Fp2 or mont::Fp2Pair): N = 2, 8 or 12; another width is
// refused.  views: [pointer, sw, sl, index or 0, the index's table rows]
// per input coordinate.
template <template <int> class F, int OP>
int dispatch(int n32, const void* views, int n_in, void* out, long long n,
             const void* consts, void* stream) {
    auto V = static_cast<const long long*>(views);
    auto O = static_cast<uint32_t*>(out);
    auto C = static_cast<const uint32_t*>(consts);
    auto s = static_cast<cudaStream_t>(stream);
    switch (n32) {
        case 2: launch<F<2>, OP>(V, n_in, O, n, C, s); break;
        case 8: launch<F<8>, OP>(V, n_in, O, n, C, s); break;
        case 12: launch<F<12>, OP>(V, n_in, O, n, C, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace ec
