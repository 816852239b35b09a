// The point kernels' body and launch, shared by ec_xyzz.cu and
// ec_pair.cu (G1) and ec_fp2_*.cu (G2): one point (or pair) per thread, or
// per lane pair of threads (Elem<E>::THREADS), the formulas of xyzz.cuh and
// pair.cuh.  The G1 madd, add, dbl and pair finish run on the carry-chain
// element (mont::FpCC<N>, mont_cc.cuh), the G1 pair prep on mont::Fp<N>.
// The G2 madd, add, pair prep and pair finish run on the lane pair
// (mont::Fp2Pair<N>: thread 2i holds c0 of lane i, thread 2i + 1 holds
// c1), the G2 dbl on the lane pair over the carry-chain element
// (mont::Fp2PairCC<N>, mont_cc.cuh).
//
// Operands: each input coordinate is a (W, n) view, W = N words for Fp<N>
// and 2 N for the fp2 elements (c0's words, then c1's), given by a pointer
// and two strides in words, `sw` between words and `sl` between lanes, so
// the kernels read limb-major tensors (sw = n, sl = 1), point-major rows
// (sw = 1, sl = 2 W), the even or odd lanes of a tree level (sw = m,
// sl = 2) and broadcast constants (sl = 0) without a copy; the finish's
// flag word is a view of one word.  A point operand may be a table read
// through an index: lane i then reads row idx[i] of the view, 16 bytes at
// a time where the rows are point-major and aligned (sw = 1; a G1 row at
// n32 = 12 is 96 bytes, three full sectors).  The slab MSM's madd reads
// its affine point so, and a tree's first level reads both operands of
// its pair kernels so (the level-0 index, msm/tree.py): the MSM writes
// and reads back no gathered copy of the points.  The output is one
// contiguous (rows, n) block, stored coalesced: (4 W, n) for the xyzz
// ops, den then the flags, (W + 1, n), for the pair prep, (x, y),
// (2 W, n), for the pair finish.
//
// The pair kernels are built twice (TABLE): for a tree's first level,
// whose point operands are rows of the point table through the index, and
// for a later level, whose operands are the lanes of the level below, read
// by plain strided loads (through the table path they took 17% longer).  The
// lane-pair prep and finish on the first level (x1 || y1 at row idx_l[i],
// x2 || y2 at row idx_r[i], 2 W words each) first copy the block's rows
// into a shared-memory tile with 16-byte cp.async copies, neighbouring
// threads on neighbouring chunks of one row, each lane's 4 W words padded
// by 16 bytes so that a warp's reads spread over the banks; each thread
// then reads its coefficient's words from there (`staged`).  Read straight
// from the table, the 16 lanes of a warp touch 32 rows on every load.  The
// G1 pair kernels, one thread a lane, read the table straight, 16 bytes a
// load.  The finish loads both rows, inv and the flag word before its
// first product, so their latencies overlap.
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
    bool tile;      // the lane-pair pair kernels stage their point operands
                    // (two tables through an index) in shared memory
};

// row idx[i] of the table whose view is v: the lane's own row without an
// index; an index past the table's rows stops the kernel, as PyTorch's
// own index kernels do
__device__ __forceinline__ long long table_row(const View& v, long long i) {
    if (!v.idx) return i;
    long long row = __ldg(v.idx + i);
    if ((unsigned long long)row >= (unsigned long long)v.rows) __trap();
    return row;
}

// N words of an element, from its word w0: lane i's, or for a point
// operand that may be a table (TABLE) row idx[i] of the table where the
// view has an index, 16 bytes at a time where the view allows
template <bool TABLE, int N>
__device__ __forceinline__ void load_words(const View& v, long long i,
                                           int w0, uint32_t* r) {
    if constexpr (TABLE) {
        const uint32_t* at = v.p + table_row(v, i) * v.sl + w0 * v.sw;
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

template <bool TABLE = false, int N>
__device__ __forceinline__ void load(const View& v, long long i, int w0,
                                     mont::Fp2CC<N>& r) {
    load<TABLE>(v, i, w0, r.c0);
    load<TABLE>(v, i, w0 + N, r.c1);
}

// a lane pair: the even thread reads c0's words, the odd thread c1's
template <bool TABLE = false, int N>
__device__ __forceinline__ void load(const View& v, long long i, int w0,
                                     mont::Fp2Pair<N>& r) {
    load<TABLE>(v, i, w0 + (mont::pair_odd() ? N : 0), r.v);
}

template <bool TABLE = false, int N>
__device__ __forceinline__ void load(const View& v, long long i, int w0,
                                     mont::Fp2PairCC<N>& r) {
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

template <int N>
__device__ __forceinline__ void store(uint32_t* out, long long n, long long i,
                                      long long row, const mont::Fp2CC<N>& a) {
    store(out, n, i, row, a.c0);
    store(out, n, i, row + N, a.c1);
}

template <int N>
__device__ __forceinline__ void store(uint32_t* out, long long n, long long i,
                                      long long row,
                                      const mont::Fp2PairCC<N>& a) {
    store(out, n, i, row + (mont::pair_odd() ? N : 0), a.v);
}

// 16 bytes from global to shared memory, asynchronously (cp.async; the
// caller waits with copy_wait), cached in L1 too: many lanes of a tree
// level read the table's zero row, which then comes from L1 rather than
// from one L2 slice for every block
__device__ __forceinline__ void copy16(uint32_t* dst, const uint32_t* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void copy_wait() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
}

// the words a thread holds of an element
template <int N>
__device__ __forceinline__ uint32_t* words(mont::Fp<N>& a) { return a.w; }
template <int N>
__device__ __forceinline__ uint32_t* words(mont::FpCC<N>& a) { return a.w; }
template <int N>
__device__ __forceinline__ uint32_t* words(mont::Fp2Pair<N>& a) {
    return a.v.w;
}

// an element from shared memory: this thread's N words at t, read 16
// bytes at a time where N allows
template <class E>
__device__ __forceinline__ E load_tile(const uint32_t* t) {
    constexpr int N = mont::Elem<E>::BASE;
    E r;
    uint32_t* w = words(r);
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int q = 0; q < N / 4; q++) {
            uint4 v = reinterpret_cast<const uint4*>(t)[q];
            w[4 * q] = v.x;
            w[4 * q + 1] = v.y;
            w[4 * q + 2] = v.z;
            w[4 * q + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < N; k++) w[k] = t[k];
    }
    return r;
}

// whether a pair kernel on a tree's first level stages its point operands
// in a shared-memory tile: the lane-pair kernels do
template <class E>
constexpr bool staged = mont::Elem<E>::THREADS == 2;

// The pair kernel of lane i from its point operands: prep stores den and
// the flag word (one thread of a lane pair stores the flag), finish reads
// inv and the flag word from their views and stores (x, y).
template <class E, int OP>
__device__ __forceinline__ void pair_op(const Args<mont::Elem<E>::BASE>& a,
                                        long long i, const E& x1,
                                        const E& y1, const E& x2,
                                        const E& y2) {
    constexpr long long W = mont::Elem<E>::WORDS;
    if constexpr (OP == PAIR_PREP) {
        E den;
        uint32_t f = pair::prep(x1, y1, x2, y2, den, a.c);
        store(a.out, a.n, i, 0, den);
        if (mont::Elem<E>::THREADS == 1 || (threadIdx.x & 1) == 0)
            a.out[W * a.n + i] = f;
    } else {
        uint32_t f = a.in[5].p[i * a.in[5].sl];
        E inv = load<E>(a.in[4], i);
        E ox, oy;
        pair::finish(x1, y1, x2, y2, inv, f, ox, oy, a.c);
        store(a.out, a.n, i, 0, ox);
        store(a.out, a.n, i, W, oy);
    }
}

// The body of every point kernel.  TABLE: the pair kernels' point
// operands are tables read through an index (a tree's first level); the
// madd's affine point always may be.
template <class E, int OP, bool TABLE>
__device__ __forceinline__ void point_op(
    const Args<mont::Elem<E>::BASE>& a) {
    // lane i: one thread, or the lane pair (2i, 2i + 1), which exits or
    // runs on together
    constexpr int T = mont::Elem<E>::THREADS;
    long long i = ((long long)blockIdx.x * THREADS + threadIdx.x) / T;
    constexpr long long W = mont::Elem<E>::WORDS;
    constexpr bool PAIR = OP == PAIR_PREP || OP == PAIR_FINISH;
    if constexpr (PAIR && TABLE && staged<E>) {
        // the block's LANES rows of 4 W words (x1 y1 from the l table, x2
        // y2 from the r table), each padded by 4 words
        constexpr int N = mont::Elem<E>::BASE, LANES = THREADS / T;
        constexpr int C = 2 * W / 4, S = 4 * W + 4;  // 16-byte chunks a row
        __shared__ __align__(16) uint32_t tile[LANES * S];
        if (a.tile) {
            long long i0 = (long long)blockIdx.x * LANES;
            long long lanes = a.n - i0 < LANES ? a.n - i0 : LANES;
            for (int k = threadIdx.x; k < lanes * 2 * C; k += THREADS) {
                int j = k / (2 * C), h = k / C % 2, q = k % C;
                const View& v = a.in[2 * h];
                copy16(tile + j * S + h * 2 * W + 4 * q,
                       v.p + table_row(v, i0 + j) * v.sl + 4 * q);
            }
            copy_wait();
            __syncthreads();
            if (i >= a.n) return;
            const uint32_t* t = tile + (threadIdx.x / T) * S +
                                (T == 2 && mont::pair_odd() ? N : 0);
            pair_op<E, OP>(a, i, load_tile<E>(t), load_tile<E>(t + W),
                           load_tile<E>(t + 2 * W), load_tile<E>(t + 3 * W));
            return;
        }
    }
    if (i >= a.n) return;
    if constexpr (PAIR) {
        pair_op<E, OP>(a, i, load<E, TABLE>(a.in[0], i),
                       load<E, TABLE>(a.in[1], i), load<E, TABLE>(a.in[2], i),
                       load<E, TABLE>(a.in[3], i));
    } else {
        xyzz::Point<E> r;
        if constexpr (OP == MADD) {
            r = xyzz::madd(load_point<E>(a.in, i), load<E, true>(a.in[4], i),
                           load<E, true>(a.in[5], i), a.c);
        } else if constexpr (OP == ADD) {
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
}

// __launch_bounds__ gives ptxas no minimum of blocks an SM, so it picks
// each kernel's registers itself.  A minimum of 1, 3 or 4 blocks was timed
// on the H100 (variants.py, PERF.md): none ran faster than ptxas's own
// choice for the lane-pair add and finish or the G1 madd on mont::Fp.
template <class E, int OP, bool TABLE>
__global__ void __launch_bounds__(THREADS)
ec_kernel(const __grid_constant__ Args<mont::Elem<E>::BASE> a) {
    point_op<E, OP, TABLE>(a);
}

template <class E>
constexpr bool carry_chains = false;
template <int N>
constexpr bool carry_chains<mont::FpCC<N>> = true;

// The minimum of blocks an SM that each G1 kernel on the carry-chain
// element asks for, which caps ptxas at 65536 / (128 MIN) registers a
// thread; 0 would launch ec_kernel, with none.  Chosen per op on the H100
// (variants.py, PERF.md):
//   madd, add, dbl: 3, 168 registers with a few spilled words, where
//     ptxas picks 178 and 212 (2 blocks an SM); the madd and add ran 7%
//     and 12% faster;
//   pair finish: 4, four blocks an SM to wait on a tree level's
//     scattered rows (it holds six elements, where the madd holds ten):
//     120-122 registers, no spill, as at 3; with none ptxas picks 120
//     and it ran 1% slower, at 5 (96 registers) it spilled and ran 5%
//     slower at the G1 tree's level 1.
template <int OP>
constexpr int cc_min_blocks = OP == PAIR_FINISH ? 4 : 3;

namespace min_blocks {
template <class E, int OP, bool TABLE, int MIN>
__global__ void __launch_bounds__(THREADS, MIN)
ec_kernel(const __grid_constant__ Args<mont::Elem<E>::BASE> a) {
    point_op<E, OP, TABLE>(a);
}
}  // namespace min_blocks

template <class E, int OP, bool TABLE>
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
    // the lane-pair pair kernels stage their point operands where each of
    // l and r is a table through one index, in aligned point-major rows
    // with y's words right after x's: lane i's 2 W words at row idx[i]
    constexpr long long W = mont::Elem<E>::WORDS;
    a.tile = TABLE && (OP == PAIR_PREP || OP == PAIR_FINISH) && staged<E>;
    for (int k = 0; k < 4; k += 2)
        a.tile = a.tile && a.in[k].idx && a.in[k].vec &&
                 a.in[k + 1].idx == a.in[k].idx &&
                 a.in[k + 1].p == a.in[k].p + W &&
                 a.in[k + 1].sw == 1 && a.in[k + 1].sl == a.in[k].sl;
    long long threads = n * mont::Elem<E>::THREADS;
    unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
    constexpr int MIN = cc_min_blocks<OP>;
    if constexpr (carry_chains<E> && MIN > 0)
        min_blocks::ec_kernel<E, OP, TABLE, MIN>
            <<<blocks, THREADS, 0, s>>>(a);
    else
        ec_kernel<E, OP, TABLE><<<blocks, THREADS, 0, s>>>(a);
}

// whether a pair kernel's point operands are tables read through an
// index: views 0 (l's x) or 2 (r's x) carry one
inline bool indexed(const void* views) {
    auto v = static_cast<const long long*>(views);
    return v[5 * 0 + 3] || v[5 * 2 + 3];
}

// The launch for base width n32 of element family F (mont::Fp,
// mont::FpCC, mont::Fp2, mont::Fp2CC, mont::Fp2Pair or mont::Fp2PairCC):
// N = 2, 8 or 12; another width is
// refused.  views: [pointer, sw, sl, index or 0, the index's table rows]
// per input coordinate.
template <template <int> class F, int OP, bool TABLE = false>
int dispatch(int n32, const void* views, int n_in, void* out, long long n,
             const void* consts, void* stream) {
    auto V = static_cast<const long long*>(views);
    auto O = static_cast<uint32_t*>(out);
    auto C = static_cast<const uint32_t*>(consts);
    auto s = static_cast<cudaStream_t>(stream);
    switch (n32) {
        case 2: launch<F<2>, OP, TABLE>(V, n_in, O, n, C, s); break;
        case 8: launch<F<8>, OP, TABLE>(V, n_in, O, n, C, s); break;
        case 12: launch<F<12>, OP, TABLE>(V, n_in, O, n, C, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace ec
