// Batch-affine pair add formulas for the kernels of ec_pair.cu (G1: the
// prep on mont::Fp<N>, the finish on mont::FpCC<N>) and ec_fp2_pair.cu
// (G2, on the lane pair's mont::Fp2Pair<N>): the two halves of one level of the segmented-tree
// MSM (msm/tree.py), around a batch inversion that runs across all lanes
// between them.  One pair per thread (or per lane pair of threads), every
// coordinate in registers.
//
// An affine point is (x, y); infinity is x == y == 0 (ec/affine_t.hpp:31).
// prep gives the chord or tangent denominator and a flag word, bit for bit
// what sppark_tpu/ec/pallas_ops.py:_pair_prep_call writes; finish gives
// l + r from them and the inverse of the denominator, the words of
// _pair_finish_call's select chain.  Every op takes and gives canonical
// values, so the same field values are the same words.

#pragma once

#include "mont.cuh"

namespace pair {

using mont::Consts;

// the flag word
enum : uint32_t {
    ACTIVE = 1,   // a chord or tangent lane: neither operand infinite, no
                  // cancellation, no y == 0 doubling
    DBL = 2,      // active and l == r: the tangent
    USE_R = 4,    // l infinite, r not: the sum is r
    USE_L = 8     // r infinite, l not: the sum is l
};

// den = dx (chord), 2 y1 (tangent) or 1 (inactive lanes, so the batch
// inversion sees no zero); returns the flag word.  A lane with l == r and
// y1 == 0 (a point of order 2) goes to infinity: none of the port's
// prime-order curves has one, but the case is kept as the TPU kernel keeps
// it.
template <class E, int N>
MONT_HD uint32_t prep(const E& x1, const E& y1, const E& x2, const E& y2,
                      E& den, const Consts<N>& c) {
    using namespace mont;
    bool inf_l = is_zero(x1) && is_zero(y1);
    bool inf_r = is_zero(x2) && is_zero(y2);
    E dx = sub(x2, x1, c);
    E dy = sub(y2, y1, c);
    bool same_x = is_zero(dx) && !inf_l && !inf_r;
    bool dbl = same_x && is_zero(dy);
    bool toinf = (same_x && !is_zero(dy)) || (dbl && is_zero(y1));
    bool active = !inf_l && !inf_r && !toinf;
    den = !active ? Elem<E>::embed(c.one) : dbl ? add(y1, y1, c) : dx;
    return (active ? ACTIVE : 0) | (dbl && active ? DBL : 0) |
           (inf_l && !inf_r ? USE_R : 0) | (inf_r && !inf_l ? USE_L : 0);
}

// (ox, oy) = l + r, with inv = 1 / den and the flag word from prep.
// Chord: lambda = (y2 - y1) inv; tangent: lambda = (3 x1^2 + a4) inv; then
// x3 = lambda^2 - x1 - x2, y3 = lambda (x1 - x3) - y1.  The four cases are
// exclusive, so a per-lane branch gives the TPU kernel's select chain
// (active -> use r -> use l -> tangent).  The TPU kernel runs the tangent
// leg for a whole block when one of its lanes doubles (pl.when); here a
// warp with a doubling lane runs both legs, one after the other, and one
// without runs the chord alone.  No port curve has a4 != 0 (the term is
// kept, from the launch's constants, as the TPU kernel's K.a4_el keeps
// it).
template <class E, int N>
MONT_HD void finish(const E& x1, const E& y1, const E& x2, const E& y2,
                    const E& inv, uint32_t flags, E& ox, E& oy,
                    const Consts<N>& c) {
    using namespace mont;
    if (!(flags & ACTIVE)) {
        E z = Elem<E>::zero();
        ox = flags & USE_L ? x1 : flags & USE_R ? x2 : z;
        oy = flags & USE_L ? y1 : flags & USE_R ? y2 : z;
        return;
    }
    E lam;
    if (flags & DBL) {
        E x1sq = sqr(x1, c);
        E M = add(add(x1sq, x1sq, c), x1sq, c);
        E a4 = Elem<E>::embed(c.a4);
        if (!is_zero(a4)) M = add(M, a4, c);
        lam = mul(M, inv, c);
    } else {
        lam = mul(sub(y2, y1, c), inv, c);
    }
    // x2 == x1 on a doubling lane
    ox = sub(sub(sqr(lam, c), x1, c), x2, c);
    oy = sub(mul(lam, sub(x1, ox, c), c), y1, c);
}

}  // namespace pair
