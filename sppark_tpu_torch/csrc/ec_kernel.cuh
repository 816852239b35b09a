// The point kernels' body and launch, shared by ec_xyzz.cu and
// ec_pair.cu (G1, element mont::Fp<N>) and ec_fp2_*.cu (G2, element
// mont::Fp2<N>, or mont::Fp2Pair<N> for the madd): one point (or pair) per
// thread, or per lane pair of threads for Fp2Pair (Elem<E>::THREADS), the
// formulas of xyzz.cuh and pair.cuh.
//
// Operands: each input coordinate is a (W, n) view, W = N words for Fp<N>
// and 2 N for Fp2<N> (c0's words, then c1's), given by a pointer and two
// strides in words, `sw` between words and `sl` between lanes, so the
// kernels read limb-major tensors (sw = n, sl = 1), point-major rows of the
// MSM's slab or of the tree's level 0 (sw = 1, sl = 2 W; the even or odd
// rows: sl = 4 W), the even or odd lanes of a tree level (sw = m, sl = 2)
// and broadcast constants (sl = 0) without a copy; the finish's flag word
// is a view of one word.  The output is one contiguous (rows, n) block,
// stored coalesced: (4 W, n) for the xyzz ops, den then the flags, (W + 1,
// n), for the pair prep, (x, y), (2 W, n), for the pair finish.
//
// Each entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#pragma once

#include <cuda_runtime.h>

#include "pair.cuh"
#include "xyzz.cuh"

namespace ec {

constexpr int THREADS = 128;

struct View {
    const uint32_t* p;
    long long sw, sl;
};

enum Op { MADD = 0, ADD = 1, DBL = 2, PAIR_PREP = 3, PAIR_FINISH = 4 };

template <int N>
struct Args {
    View in[8];
    uint32_t* out;
    long long n;
    mont::Consts<N> c;
};

template <int N>
__device__ __forceinline__ void load(const View& v, long long i, int w0,
                                     mont::Fp<N>& r) {
#pragma unroll
    for (int w = 0; w < N; w++) r.w[w] = v.p[(w0 + w) * v.sw + i * v.sl];
}

template <int N>
__device__ __forceinline__ void load(const View& v, long long i, int w0,
                                     mont::Fp2<N>& r) {
    load(v, i, w0, r.c0);
    load(v, i, w0 + N, r.c1);
}

// a lane pair: the even thread reads c0's words, the odd thread c1's
template <int N>
__device__ __forceinline__ void load(const View& v, long long i, int w0,
                                     mont::Fp2Pair<N>& r) {
    load(v, i, w0 + (mont::pair_odd() ? N : 0), r.v);
}

template <class E>
__device__ __forceinline__ E load(const View& v, long long i) {
    E r;
    load(v, i, 0, r);
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

template <class E, int OP>
__global__ void __launch_bounds__(THREADS)
ec_kernel(const __grid_constant__ Args<mont::Elem<E>::BASE> a) {
    // lane i: one thread, or the lane pair (2i, 2i + 1), which exits or
    // runs on together
    long long i = ((long long)blockIdx.x * THREADS + threadIdx.x) /
                  mont::Elem<E>::THREADS;
    if (i >= a.n) return;
    constexpr long long W = mont::Elem<E>::WORDS;
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
        E ox, oy;
        pair::finish(load<E>(a.in[0], i), load<E>(a.in[1], i),
                     load<E>(a.in[2], i), load<E>(a.in[3], i),
                     load<E>(a.in[4], i), a.in[5].p[i * a.in[5].sl], ox, oy,
                     a.c);
        store(a.out, a.n, i, 0, ox);
        store(a.out, a.n, i, W, oy);
        return;
    }
    xyzz::Point<E> r;
    if (OP == MADD) {
        r = xyzz::madd(load_point<E>(a.in, i), load<E>(a.in[4], i),
                       load<E>(a.in[5], i), a.c);
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

template <class E, int OP>
void launch(const long long* views, int n_in, uint32_t* out, long long n,
            const uint32_t* consts, cudaStream_t s) {
    constexpr int N = mont::Elem<E>::BASE;
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
    long long threads = n * mont::Elem<E>::THREADS;
    unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
    ec_kernel<E, OP><<<blocks, THREADS, 0, s>>>(a);
}

// The launch for base width n32 of element family F (mont::Fp, mont::Fp2
// or mont::Fp2Pair): N = 2, 8 or 12; another width is refused.
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
