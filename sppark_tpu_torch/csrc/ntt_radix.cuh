// The narrow NTT kernels for Hopper (sm_90a), radix 2^k in registers, one
// text over a field policy of one 32-bit or one 64-bit word per element:
// csrc/ntt_mont32.cu instantiates it over mont32.cuh's Mont32 (BabyBear),
// csrc/ntt_gl64.cu over gl64.cuh's Gl64 (Goldilocks).
//
// rows_kernel<F> replaces sppark_tpu/ntt/pallas_kernels.py:_rows_kernel:
//   batched NTTs along the last axis of (OB, B, n), n = 2^lg <= 2^13, with
//   the input bit reversal (in_rev), an output bit reversal (out_rev), a
//   multiply of the result by a same-shape block (mul) and a transposed
//   store to (OB, n, B) (out_t).
// cols_kernel<F> replaces sppark_tpu/ntt/pallas_kernels.py:_cols_kernel:
//   batched NTTs along axis -2 of (B, n1, M), with the four-step middle
//   twiddle matrix (n1, M) multiplied on the store (mul).
//
// A policy F has `word` (4 or 8 bytes); add, sub and mul over words, which
// may return any representative (Goldilocks: lazy, any u64) or a
// canonical one (Mont32); canon, applied once to each stored word after
// the multiplier's product, so the stored words are the TPU kernels'
// words exactly; and the kernels' shape: RADIX_LG, THREADS,
// ROW_MIN_BLOCKS and COL_MIN_BLOCKS (a block's threads and the row and
// column kernels' blocks an SM for __launch_bounds__),
// ROW_TILE_LG and COL_TILE_LG (a block's tile, 2^lg words), RUN_LG (the
// transposed store's runs of rows) and TW_GLOBAL (the last stages whose
// twiddles the last pass reads from the power table in device memory,
// not from the stage-major table in shared memory).
//
// What bounds them on the card: a word read and written once a pass (plus
// the mul block) against a butterfly's product, add and sub; at 2^24 the
// operations weigh more than the bytes, but for the Goldilocks column
// pass, which also reads the 8-byte matrix.  The design keeps the
// instructions around the butterflies few:
//   - radix 2^RADIX_LG: a thread holds 2^k <= 2^RADIX_LG elements of one
//     transform in registers and runs k radix-2 stages on them, one
//     __syncthreads() a pass, not a stage (radix 16 at lg 13: 4 + 3 + 3 +
//     3 stages; lg 11: 4 + 4 + 3);
//   - the first pass reads its group straight from device memory, the
//     input bit reversal folded into the order of its registers: lane t
//     of a transform loads words m 2^(lg-k) + t, coalesced, and register
//     brev(m) holds the element at tile position brev(t) 2^k + brev(m);
//     its twiddles are known at compile time (w^0 = 1 needs no product:
//     nearly all of the n - 1 such butterflies are in this pass) and read
//     as one word a warp;
//   - later passes take twiddles from a stage-major table in shared
//     memory (stage h's w_2h^j at h - 1 + j, filled once a block from the
//     power table), so a warp reads consecutive or equal words; the last
//     TW_GLOBAL stages (at most the last pass's) read the power table
//     itself, stage lg - g at j 2^g (the last stage: consecutive words),
//     cached in L1, which divides the table by 2^TW_GLOBAL;
//   - the tile sits at an XOR swizzle of its index (swz_rows, SwzCols), so
//     the first pass's stores, every later pass, and the output's natural,
//     bit-reversed and transposed reads fall on distinct banks across a
//     warp.  A bank is 4 bytes: 32 words of 4 bytes cover the banks, 16
//     of 8 bytes, so an 8-byte access is two wavefronts at best and each
//     half-warp's 16 lanes must take distinct words mod 16.  A Python
//     model of every warp's accesses found none conflicting where B is a
//     multiple of the store's runs (the main paths' shapes) at lg 4 .. 13
//     for 8-byte words and lg 10 .. 13 for 4-byte ones, nor in the 8-byte
//     column kernel; else the 4-byte row kernel's second pass two ways,
//     the runs at lg <= 3 two or four ways, and the any-B store (B = 5)
//     two to four;
//   - the transposed store computes (ob, b) once a run of rows (shifts
//     where B is a power of two) and, where B allows, writes 2^RUN_LG
//     rows' words of one column as one 32-byte run: a block holds that
//     many rows at small lg, and above, a cluster of 2 or 4 blocks pools
//     its rows through distributed shared memory, so every sector of the
//     output is written whole; the column kernel writes its rows by
//     16-byte stores.
//
// Each launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace radix {

constexpr int LG_MAX = 13;

// lg of the words that cover the 32 four-byte banks
template <class W>
__host__ __device__ constexpr int bank_lg() {
    return sizeof(W) == 4 ? 5 : 4;
}

__device__ __forceinline__ int brev(int i, int bits) {
    return bits ? (int)(__brev((unsigned)i) >> (32 - bits)) : 0;
}

__host__ __device__ constexpr int cbrev(int m, int bits) {
    return bits ? ((m & 1) << (bits - 1)) | cbrev(m >> 1, bits - 1) : 0;
}

// The row tile's slot of element a = r n + pos: a's bits above the low
// bank_lg folded into its low bank_lg by XOR, a permutation within each
// run of 2^bank_lg words.  Any bank_lg consecutive bits above them land
// on distinct slot bits, so lanes that differ in such bits (the bit-
// reversed first-pass stores and output reads, the rows of the
// transposed store) take distinct banks.  4-byte words: bits 5-9 and
// 10-14 into the low five.  (XORing bits 7 and 8 into bit 4 as well,
// against the second pass's two-way conflicts, cost the row pass 10%: the
// slot's instructions weigh more than a conflict.  pass() spreads that
// pass's lanes instead.)  8-byte words: bits 4-7, 8-11 and 12 into the
// low four.
template <class W>
__device__ __forceinline__ int swz_rows(int a) {
    if constexpr (sizeof(W) == 4)
        return a ^ (((a >> 5) ^ (a >> 10)) & 31);
    else
        return a ^ (((a >> 4) ^ (a >> 8) ^ (a >> 12)) & 15);
}

template <class W>
struct SwzRows {
    __device__ __forceinline__ int operator()(int a) const {
        return swz_rows<W>(a);
    }
};

// The column tile's slot of element a = pos C + col (C = 2^lgc < 2^bank_lg
// words): the top w = bank_lg - lgc bits of pos XORed into its low w bits,
// so the 2^bank_lg / C transforms' rows a warp touches land on distinct
// banks.
struct SwzCols {
    int lgc, sh, mask;     // mask 0: no swizzle
    __device__ __forceinline__ int operator()(int a) const {
        return a ^ ((((a >> lgc) >> sh) & mask) << lgc);
    }
};

template <class F>
__device__ __forceinline__ void bfly(const F& f, typename F::word& u,
                                     typename F::word& v,
                                     typename F::word w) {
    const typename F::word t = f.mul(v, w);
    v = f.sub(u, t);
    u = f.add(u, t);
}

// The stage-major table's entries from .. to - 1: stage h's w_2h^j =
// tw[j n / 2h] at h - 1 + j.
template <class W>
__device__ __forceinline__ void fill_twiddles(W* t, const W* __restrict__ tw,
                                              int lg, int from, int to) {
    for (int q = from + threadIdx.x; q < to; q += blockDim.x) {
        const int lh = 31 - __clz(q + 1);           // h = 2^lh
        const int j = q + 1 - (1 << lh);
        t[q] = __ldg(tw + (j << (lg - 1 - lh)));
    }
}

// The first pass, stages 1 .. k, read from device memory.  Group g is
// column col = g mod C and transform r of the block; its lane index tt
// runs over the transform's 2^(lg - k) groups.  Element xpos of (r, col)
// is x[x0 + r n + xpos ld + col]: rows pass x0 = row0 n and ld = 1,
// columns x0 = the block's first word and ld = M (r = 0).
template <class F, int k, class S>
__device__ __forceinline__ void first_pass(
        const F& f, const typename F::word* __restrict__ x, long long x0,
        long long ld, const typename F::word* __restrict__ tw,
        typename F::word* s, S swz, int groups, int lg, int lgc,
        int in_rev) {
    using W = typename F::word;
    const int lt = lg - k;
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
        const int col = g & ((1 << lgc) - 1);
        const int q = g >> lgc;
        const int tt = q & ((1 << lt) - 1);
        const int r = q >> lt;
        const W* xr = x + x0 + ((long long)r << lg) + col;
        W v[1 << k];
        int hi;
        if (in_rev) {
            hi = brev(tt, lt);
#pragma unroll
            for (int m = 0; m < (1 << k); m++)
                v[cbrev(m, k)] = __ldg(xr + (long long)((m << lt) + tt) * ld);
        } else {
            hi = tt;
#pragma unroll
            for (int m = 0; m < (1 << k); m++)
                v[m] = __ldg(xr + (long long)((tt << k) + m) * ld);
        }
#pragma unroll
        for (int sg = 0; sg < k; sg++) {
            const int hs = 1 << sg;
#pragma unroll
            for (int m = 0; m < (1 << k); m += 2 * hs) {      // w^0 = 1
                const W t = v[m + hs];
                v[m + hs] = f.sub(v[m], t);
                v[m] = f.add(v[m], t);
            }
#pragma unroll
            for (int jm = 1; jm < hs; jm++) {
                const W w = __ldg(tw + (jm << (lg - 1 - sg)));
#pragma unroll
                for (int m = jm; m < (1 << k); m += 2 * hs)
                    bfly(f, v[m], v[m + hs], w);
            }
        }
        const int base = ((r << lg) | (hi << k)) << lgc | col;
#pragma unroll
        for (int m = 0; m < (1 << k); m++) s[swz(base + (m << lgc))] = v[m];
    }
}

// A later pass: the k stages from stage sh + 1 (h0 = 2^sh) on the tile.
// A group is the 2^k elements pos = hi 2^(sh + k) + m 2^sh + lo of one
// transform and column; consecutive groups take consecutive col, then lo.
// LAST: the pass ends at stage lg and reads its last min(TW_GLOBAL, k)
// stages' twiddles from the power table tw.
template <class F, int k, bool LAST, class S>
__device__ __forceinline__ void pass(const F& f, typename F::word* s,
                                     const typename F::word* t,
                                     const typename F::word* __restrict__ tw,
                                     S swz, int groups, int lg, int lgc,
                                     int sh) {
    using W = typename F::word;
    constexpr int BL = bank_lg<W>();
    constexpr int G = F::TW_GLOBAL < k ? F::TW_GLOBAL : k;
    const int h0 = 1 << sh;
    // rows with h0 < 2^BL: a warp's lanes past the first h0 take hi bit
    // BL - k, not bit 0, so its groups lie 2^(sh + BL) words apart and
    // swz_rows puts them on distinct banks
    const int j = sh + BL - k;
    const bool spread = lgc == 0 && sh < BL && j < lg - k;
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
        const int col = g & ((1 << lgc) - 1);
        int q = g >> lgc;
        if (spread) {
            const int d = ((q >> sh) ^ (q >> j)) & 1;
            q ^= (d << sh) | (d << j);
        }
        const int lo = q & (h0 - 1);
        const int hi = (q & ((1 << (lg - k)) - 1)) >> sh;
        const int r = q >> (lg - k);
        const int base = (((r << lg) | (hi << (sh + k)) | lo) << lgc) | col;
        const int stride = h0 << lgc;
        W v[1 << k];
#pragma unroll
        for (int m = 0; m < (1 << k); m++) v[m] = s[swz(base + m * stride)];
#pragma unroll
        for (int sg = 0; sg < k; sg++) {
            const int hs = 1 << sg;
#pragma unroll
            for (int jm = 0; jm < hs; jm++) {
                // stage sh + sg + 1: w_2h^j, h = h0 2^sg, j = lo + jm h0;
                // in the last pass tw[j 2^(k - 1 - sg)]
                W w;
                if constexpr (LAST)
                    w = sg >= k - G
                            ? __ldg(tw + ((lo + jm * h0) << (k - 1 - sg)))
                            : t[(h0 << sg) - 1 + lo + jm * h0];
                else
                    w = t[(h0 << sg) - 1 + lo + jm * h0];
#pragma unroll
                for (int m = jm; m < (1 << k); m += 2 * hs)
                    bfly(f, v[m], v[m + hs], w);
            }
        }
#pragma unroll
        for (int m = 0; m < (1 << k); m++) s[swz(base + m * stride)] = v[m];
    }
}

// The passes of k <= K stages (k known at run time), first or later.
template <class F, int K, class S>
__device__ __forceinline__ void first_of(
        int k, const F& f, const typename F::word* __restrict__ x,
        long long x0, long long ld, const typename F::word* __restrict__ tw,
        typename F::word* s, S swz, int transforms, int lg, int lgc,
        int in_rev) {
    if (k < K) {
        if constexpr (K > 1)
            first_of<F, K - 1>(k, f, x, x0, ld, tw, s, swz, transforms, lg,
                               lgc, in_rev);
    } else {
        first_pass<F, K>(f, x, x0, ld, tw, s, swz,
                         (transforms << (lg - K)) << lgc, lg, lgc, in_rev);
    }
}

template <class F, int K, bool LAST, class S>
__device__ __forceinline__ void pass_of(
        int k, const F& f, typename F::word* s, const typename F::word* t,
        const typename F::word* __restrict__ tw, S swz, int transforms,
        int lg, int lgc, int sh) {
    if (k < K) {
        if constexpr (K > 1)
            pass_of<F, K - 1, LAST>(k, f, s, t, tw, swz, transforms, lg, lgc,
                                    sh);
    } else {
        pass<F, K, LAST>(f, s, t, tw, swz, (transforms << (lg - K)) << lgc,
                         lg, lgc, sh);
    }
}

// The stages of the last later pass of a transform of 2^lg (0: none):
// transform() splits the lg - min(K, lg) stages after the first pass into
// passes as evenly as K allows, the last taking the fewest.
template <class F>
__host__ __device__ constexpr int last_pass_stages(int lg) {
    constexpr int K = F::RADIX_LG;
    const int rest = lg - (K < lg ? K : lg);
    return rest ? rest / ((rest + K - 1) / K) : 0;
}

// The stage-major table's words for a transform of 2^lg: stages 1 .. lg,
// less the last pass's last TW_GLOBAL.
template <class F>
__host__ __device__ constexpr int table_words(int lg) {
    if constexpr (F::TW_GLOBAL == 0) {
        return (1 << lg) - 1;
    } else {
        const int kl = last_pass_stages<F>(lg);
        return (1 << (lg - (F::TW_GLOBAL < kl ? F::TW_GLOBAL : kl))) - 1;
    }
}

// Every stage of the block's `transforms` transforms of length 2^lg (each
// C = 2^lgc columns wide): the first pass of min(K, lg) stages from device
// memory, then the rest split as evenly as K allows.  The block is
// synchronised after each pass, the last included.
template <class F, class S>
__device__ __forceinline__ void transform(
        const F& f, const typename F::word* __restrict__ x, long long x0,
        long long ld, const typename F::word* __restrict__ tw,
        typename F::word* s, typename F::word* t, S swz, int transforms,
        int lg, int lgc, int in_rev) {
    constexpr int K = F::RADIX_LG;
    const int k1 = min(K, lg);
    fill_twiddles(t, tw, lg, (1 << k1) - 1, table_words<F>(lg));
    first_of<F, K>(k1, f, x, x0, ld, tw, s, swz, transforms, lg, lgc, in_rev);
    __syncthreads();
    const int rest = lg - k1;
    const int passes = (rest + K - 1) / K;
    int sh = k1;
    for (int p = 0; p < passes; p++) {
        const int k = rest / passes + (p < rest % passes);
        if constexpr (F::TW_GLOBAL > 0) {
            if (p == passes - 1)
                pass_of<F, K, true>(k, f, s, t, tw, swz, transforms, lg, lgc,
                                    sh);
            else
                pass_of<F, K, false>(k, f, s, t, tw, swz, transforms, lg,
                                     lgc, sh);
        } else {
            pass_of<F, K, false>(k, f, s, t, tw, swz, transforms, lg, lgc,
                                 sh);
        }
        __syncthreads();
        sh += k;
    }
}

// 2^lv words to dst (aligned to 2^lv words) by the widest stores that fit,
// at most 16 bytes.
template <int lv, class W>
__device__ __forceinline__ void store_run(W* dst, const W* v) {
    if constexpr (lv == 0) {
        dst[0] = v[0];
    } else if constexpr (sizeof(W) == 8) {
#pragma unroll
        for (int q = 0; q < (1 << lv); q += 2)
            reinterpret_cast<ulonglong2*>(dst)[q >> 1] =
                make_ulonglong2(v[q], v[q + 1]);
    } else if constexpr (lv == 1) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(v[0], v[1]);
    } else {
#pragma unroll
        for (int q = 0; q < (1 << lv); q += 4)
            reinterpret_cast<uint4*>(dst)[q >> 2] =
                make_uint4(v[q], v[q + 1], v[q + 2], v[q + 3]);
    }
}

// (ob, b) of a row, as out's offset ob n B + b; lgb = lg B, or -1.
__device__ __forceinline__ long long row_offset(long long row, long long B,
                                                int lgb, int lg) {
    const long long ob = lgb >= 0 ? row >> lgb : row / B;
    return ((ob << lg) * B) + (row - ob * B);
}

// The transposed store by runs of V = 2^lv rows (B mod V = 0, out aligned):
// lanes along i, each storing V rows' words of one column at once; (ob, b)
// once a run.
template <int lv, class F>
__device__ __forceinline__ void store_runs(
        const F& f, const typename F::word* s,
        const typename F::word* __restrict__ mul, typename F::word* out,
        long long row0, int nrows, long long B, int lgb, int lg, int lgt,
        int out_rev) {
    using W = typename F::word;
    const int li = min(lg, lgt);
    for (int u = threadIdx.x >> li; u < nrows >> lv; u += blockDim.x >> li) {
        const long long row = row0 + (u << lv);
        W* o = out + row_offset(row, B, lgb, lg);
        const W* mr = mul ? mul + (row << lg) : nullptr;
        for (int i = threadIdx.x & ((1 << li) - 1); i < 1 << lg;
             i += 1 << li) {
            const int src = out_rev ? brev(i, lg) : i;
            W v[1 << lv];
#pragma unroll
            for (int j = 0; j < (1 << lv); j++) {
                v[j] = s[swz_rows<W>((((u << lv) + j) << lg) | src)];
                if (mr) v[j] = f.mul(v[j], __ldg(mr + (j << lg) + i));
                v[j] = f.canon(v[j]);
            }
            store_run<lv>(o + (long long)i * B, v);
        }
    }
}

// The transposed store by runs of V = 2^RUN_LG rows across a cluster of
// V / R blocks (R = 2^lgr < V rows each, B mod V = 0, out aligned): block
// q of the cluster stores the q-th part of the columns i for all the
// cluster's rows, reading the other blocks' tiles through distributed
// shared memory, one run a lane; the cluster synchronises before and
// after.
template <class F>
__device__ __forceinline__ void store_cluster(
        const F& f, typename F::word* s,
        const typename F::word* __restrict__ mul, typename F::word* out,
        long long B, int lgb, int lg, int lgr, int out_rev) {
    using W = typename F::word;
    constexpr int RL = F::RUN_LG;
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    const int q = (int)cl.block_rank();
    const int lpart = lg - (RL - lgr);               // n / (V / R) columns
    const long long row = ((long long)blockIdx.x - q) << lgr;
    W* o = out + row_offset(row, B, lgb, lg);
    const W* mr = mul ? mul + (row << lg) : nullptr;
    for (int i = (q << lpart) + threadIdx.x; i < (q + 1) << lpart;
         i += blockDim.x) {
        const int src = out_rev ? brev(i, lg) : i;
        W v[1 << RL];
#pragma unroll
        for (int e = 0; e < (1 << RL); e++) {
            const W* ts = cl.map_shared_rank(s, e >> lgr);
            v[e] = ts[swz_rows<W>(((e & ((1 << lgr) - 1)) << lg) | src)];
            if (mr) v[e] = f.mul(v[e], __ldg(mr + (e << lg) + i));
            v[e] = f.canon(v[e]);
        }
        store_run<RL>(o + (long long)i * B, v);
    }
    cl.sync();
}

// How rows_kernel stores out_t: by the rows (any B), by runs of the
// block's rows, or by runs of 2^RUN_LG rows across a cluster.
enum Runs { RUNS_NONE = 0, RUNS_BLOCK = 1, RUNS_CLUSTER = 2 };

// One block transforms R = 2^lgr consecutive rows of length n = 2^lg, held
// in the tile as element r n + pos; the twiddle table follows the tile.
template <class F>
__global__ void __launch_bounds__(F::THREADS, F::ROW_MIN_BLOCKS)
rows_kernel(F f, const typename F::word* __restrict__ x,
            const typename F::word* __restrict__ tw,
            const typename F::word* __restrict__ mul,
            typename F::word* __restrict__ out, long long rows, long long B,
            int lgb, int lg, int lgr, int in_rev, int out_rev, int out_t,
            int runs) {
    using W = typename F::word;
    extern __shared__ __align__(16) unsigned char smem_rows[];
    W* s = reinterpret_cast<W*>(smem_rows);
    W* t = s + (1 << (lg + lgr));
    const int n = 1 << lg;
    const long long row0 = (long long)blockIdx.x << lgr;
    const int nrows = (int)min((long long)1 << lgr, rows - row0);
    const long long e0 = row0 << lg;
    transform(f, x, e0, 1, tw, s, t, SwzRows<W>{}, nrows, lg, 0, in_rev);

    const int lgt = 31 - __clz(blockDim.x);
    if (!out_t) {
        for (int e = threadIdx.x; e < nrows << lg; e += blockDim.x) {
            const int i = e & (n - 1);
            W v = s[swz_rows<W>((e & ~(n - 1)) |
                                (out_rev ? brev(i, lg) : i))];
            if (mul) v = f.mul(v, __ldg(mul + e0 + e));
            out[e0 + e] = f.canon(v);
        }
        return;
    }
    // transposed store: out[ob, i, b] = y[ob, b, i]
    if (runs == RUNS_CLUSTER) {
        store_cluster(f, s, mul, out, B, lgb, lg, lgr, out_rev);
        return;
    }
    if (runs == RUNS_BLOCK) {
        switch (min(lgr, F::RUN_LG)) {
            case 0: store_runs<0>(f, s, mul, out, row0, nrows, B, lgb, lg,
                                  lgt, out_rev); break;
            case 1: store_runs<1>(f, s, mul, out, row0, nrows, B, lgb, lg,
                                  lgt, out_rev); break;
            case 2: store_runs<2>(f, s, mul, out, row0, nrows, B, lgb, lg,
                                  lgt, out_rev); break;
            default: store_runs<3>(f, s, mul, out, row0, nrows, B, lgb, lg,
                                   lgt, out_rev);
        }
        return;
    }
    // any B: lanes along the rows, (ob, b) once a row
    const int lrs = min(lgr, lgt);
    for (int r = threadIdx.x & ((1 << lrs) - 1); r < nrows; r += 1 << lrs) {
        const long long row = row0 + r;
        W* o = out + row_offset(row, B, lgb, lg);
        for (int i = threadIdx.x >> lrs; i < n; i += blockDim.x >> lrs) {
            W v = s[swz_rows<W>((r << lg) | (out_rev ? brev(i, lg) : i))];
            if (mul) v = f.mul(v, __ldg(mul + (row << lg) + i));
            o[(long long)i * B] = f.canon(v);
        }
    }
}

// One block transforms C = 2^lgc adjacent columns of one (n1, M) slice,
// held in the tile as element pos C + col; the twiddle table follows.
// vec: 16 bytes of columns (4 words of 4 bytes, 2 of 8) or more, and
// 16-byte aligned rows, so a lane moves 16 bytes at once.
template <class F>
__global__ void __launch_bounds__(F::THREADS, F::COL_MIN_BLOCKS)
cols_kernel(F f, const typename F::word* __restrict__ x,
            const typename F::word* __restrict__ tw,
            const typename F::word* __restrict__ mul,
            typename F::word* __restrict__ out, int lg, long long M, int lgc,
            long long blocks_per_slice, int vec) {
    using W = typename F::word;
    extern __shared__ __align__(16) unsigned char smem_cols[];
    W* s = reinterpret_cast<W*>(smem_cols);
    const int total = 1 << (lg + lgc);
    W* t = s + total;
    const long long slice = blockIdx.x / blocks_per_slice;
    const long long col0 = (blockIdx.x - slice * blocks_per_slice) << lgc;
    const long long base = (slice << lg) * M + col0;
    const int w = bank_lg<W>() - lgc;
    const SwzCols swz{lgc, lg - w, (w > 0 && lg > w) ? (1 << w) - 1 : 0};
    transform(f, x, base, M, tw, s, t, swz, 1, lg, lgc, 1);

    if constexpr (sizeof(W) == 8) {
        if (vec) {
            for (int e = threadIdx.x << 1; e < total; e += blockDim.x << 1) {
                const int r = e >> lgc, col = e & ((1 << lgc) - 1);
                const ulonglong2 v =
                    *reinterpret_cast<const ulonglong2*>(s + swz(e));
                W a = v.x, b = v.y;
                const long long o = base + r * M + col;
                if (mul) {
                    const ulonglong2 m = __ldg(
                        reinterpret_cast<const ulonglong2*>(
                            mul + col0 + r * M + col));
                    a = f.mul(a, m.x);
                    b = f.mul(b, m.y);
                }
                *reinterpret_cast<ulonglong2*>(out + o) =
                    make_ulonglong2(f.canon(a), f.canon(b));
            }
            return;
        }
    } else {
        if (vec) {
            for (int e = threadIdx.x << 2; e < total; e += blockDim.x << 2) {
                const int r = e >> lgc, col = e & ((1 << lgc) - 1);
                uint4 v = *reinterpret_cast<const uint4*>(s + swz(e));
                const long long o = base + r * M + col;
                if (mul) {
                    const uint4 m = __ldg(reinterpret_cast<const uint4*>(
                        mul + col0 + r * M + col));
                    v = make_uint4(f.mul(v.x, m.x), f.mul(v.y, m.y),
                                   f.mul(v.z, m.z), f.mul(v.w, m.w));
                }
                *reinterpret_cast<uint4*>(out + o) =
                    make_uint4(f.canon(v.x), f.canon(v.y), f.canon(v.z),
                               f.canon(v.w));
            }
            return;
        }
    }
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int r = e >> lgc, col = e & ((1 << lgc) - 1);
        W v = s[swz(e)];
        if (mul) v = f.mul(v, __ldg(mul + col0 + r * M + col));
        out[base + r * M + col] = f.canon(v);
    }
}

template <class F>
int threads_for(long long groups) {
    long long t = groups;
    if (t > F::THREADS) t = F::THREADS;
    if (t < 32) t = 32;
    return (int)t;
}

inline int imin(int a, int b) { return a < b ? a : b; }

// the tile of 2^lgt words and the twiddle table of a transform of 2^lg
template <class F>
size_t tile_bytes(int lgt, int lg) {
    return (((size_t)1 << lgt) + table_words<F>(lg)) *
           sizeof(typename F::word);
}

inline int lg_of(long long v) {
    int k = 0;
    while ((1LL << k) < v) ++k;
    return k;
}

// x, mul: (OB, B, n) natural order; out: (OB, B, n), or (OB, n, B) when
// out_t.  tw: [w^0 .. w^(n/2-1)].  mul may be null.  Needs 1 <= lg <= 13.
template <class F>
int launch_rows(F f, const void* x, const void* tw, const void* mul,
                void* out, long long ob, long long b, int lg, int in_rev,
                int out_rev, int out_t, void* stream) {
    using W = typename F::word;
    constexpr int RL = F::RUN_LG;
    if (lg < 1 || lg > LG_MAX || ob < 1 || b < 1)
        return (int)cudaErrorInvalidValue;
    const long long rows = ob * b;
    const int lgr = imin(F::ROW_TILE_LG - lg, lg_of(rows));
    const long long grid = (rows + (1LL << lgr) - 1) >> lgr;
    const int lv = imin(lgr, RL);
    const uintptr_t align = (uintptr_t)out;
    const int runs =
        !out_t ? RUNS_NONE
        : lgr < RL && b % (1 << RL) == 0 && align % (sizeof(W) << RL) == 0
            ? RUNS_CLUSTER
        : b % (1LL << lv) == 0 && align % (sizeof(W) << lv) == 0
            ? RUNS_BLOCK : RUNS_NONE;
    const int lgb = (b & (b - 1)) ? -1 : lg_of(b);
    const size_t smem = tile_bytes<F>(lg + lgr, lg);
    cudaError_t err = cudaFuncSetAttribute(
        rows_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)grid);
    cfg.blockDim = dim3(threads_for<F>((1LL << (lg + lgr)) >>
                                       imin(F::RADIX_LG, lg)));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute cluster[1];
    if (runs == RUNS_CLUSTER) {
        // rows mod 2^RL = 0 (b mod 2^RL = 0), so grid is whole clusters
        cluster[0].id = cudaLaunchAttributeClusterDimension;
        cluster[0].val.clusterDim.x = (1 << RL) >> lgr;
        cluster[0].val.clusterDim.y = 1;
        cluster[0].val.clusterDim.z = 1;
        cfg.attrs = cluster;
        cfg.numAttrs = 1;
    }
    err = cudaLaunchKernelEx(&cfg, rows_kernel<F>, f, (const W*)x,
                             (const W*)tw, (const W*)mul, (W*)out, rows, b,
                             lgb, lg, lgr, in_rev, out_rev, out_t, runs);
    if (err != cudaSuccess) return (int)err;
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
    const int lgc = imin(F::COL_TILE_LG - lg, lg_of(M));
    const long long per_slice = M >> lgc;
    // 16 bytes of columns a lane: 2^lgv words
    const int lgv = sizeof(W) == 8 ? 1 : 2;
    const int vec = lgc >= lgv && (uintptr_t)out % 16 == 0 &&
                    (uintptr_t)mul % 16 == 0;
    const size_t smem = tile_bytes<F>(lg + lgc, lg);
    cudaError_t err = cudaFuncSetAttribute(
        cols_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int k1 = imin(F::RADIX_LG, lg);
    cols_kernel<F><<<(unsigned)(batch * per_slice),
                     threads_for<F>((1LL << (lg + lgc)) >> k1), smem,
                     (cudaStream_t)stream>>>(
        f, (const W*)x, (const W*)tw, (const W*)mul, (W*)out, lg, M, lgc,
        per_slice, vec);
    return (int)cudaGetLastError();
}

}  // namespace radix
