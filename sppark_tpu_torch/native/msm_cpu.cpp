// CPU Pippenger MSM host core — the native fallback/reference path.
//
// Role of the reference's host-side MSM (msm/pippenger.hpp:220-350) and the
// blst host field types it leans on (SURVEY.md L1h): a generic Montgomery
// bignum over 64-bit limbs (parameters injected at runtime, so one binary
// serves every curve), xyzz/jacobian point arithmetic, signed-digit window
// decomposition matching the device encoding (msm/pippenger.cuh:63-117),
// and a window-parallel thread pool (thread_pool_t.hpp analogue).
//
// Exposed via a tiny C ABI (RustError-style status struct,
// util/rusterror.h:18) consumed by sppark_tpu/ffi via ctypes.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -o libsppark_cpu.so msm_cpu.cpp -lpthread

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cstdio>
#include <vector>
#include <thread>
#include <atomic>

using u64 = uint64_t;
using u128 = unsigned __int128;

static const size_t MAX_LIMBS = 8;   // up to 512-bit fields

// ---------------------------------------------------------------------------
// runtime-parameterized Montgomery field (role of blst_t/pasta_t host types)
// ---------------------------------------------------------------------------

struct FieldCtx {
    size_t n;                 // limbs
    u64 mod[MAX_LIMBS];       // little-endian modulus
    u64 m0;                   // -mod^-1 mod 2^64
    u64 rr[MAX_LIMBS];        // R^2 mod p (for to_mont)
};

struct Fe {
    u64 v[MAX_LIMBS];
};

static inline bool fe_is_zero(const FieldCtx& F, const Fe& a) {
    u64 acc = 0;
    for (size_t i = 0; i < F.n; i++) acc |= a.v[i];
    return acc == 0;
}

static inline void fe_zero(const FieldCtx& F, Fe& a) {
    std::memset(a.v, 0, sizeof(a.v));
}

static inline int fe_cmp(const FieldCtx& F, const u64* a, const u64* b) {
    for (size_t i = F.n; i-- > 0;) {
        if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
    }
    return 0;
}

static inline void fe_sub_raw(const FieldCtx& F, u64* out, const u64* a,
                              const u64* b) {
    u64 borrow = 0;
    for (size_t i = 0; i < F.n; i++) {
        u64 d = a[i] - b[i];
        u64 b2 = (a[i] < b[i]);
        u64 d2 = d - borrow;
        b2 |= (d < borrow);
        out[i] = d2;
        borrow = b2;
    }
}

static inline void fe_add(const FieldCtx& F, Fe& out, const Fe& a,
                          const Fe& b) {
    u64 carry = 0;
    for (size_t i = 0; i < F.n; i++) {
        u128 s = (u128)a.v[i] + b.v[i] + carry;
        out.v[i] = (u64)s;
        carry = (u64)(s >> 64);
    }
    if (carry || fe_cmp(F, out.v, F.mod) >= 0)
        fe_sub_raw(F, out.v, out.v, F.mod);
}

static inline void fe_sub(const FieldCtx& F, Fe& out, const Fe& a,
                          const Fe& b) {
    if (fe_cmp(F, a.v, b.v) >= 0) {
        fe_sub_raw(F, out.v, a.v, b.v);
    } else {
        u64 tmp[MAX_LIMBS];
        fe_sub_raw(F, tmp, b.v, a.v);
        fe_sub_raw(F, out.v, F.mod, tmp);
    }
}

static inline void fe_neg(const FieldCtx& F, Fe& out, const Fe& a) {
    if (fe_is_zero(F, a)) { out = a; return; }
    fe_sub_raw(F, out.v, F.mod, a.v);
}

// CIOS Montgomery multiplication (the mad_n_redc dataflow of
// ff/mont_t.cuh:381-423, on 64-bit host limbs with u128 carries).
static void fe_mul(const FieldCtx& F, Fe& out, const Fe& a, const Fe& b) {
    u64 t[MAX_LIMBS + 2];
    std::memset(t, 0, sizeof(t));
    const size_t n = F.n;
    for (size_t i = 0; i < n; i++) {
        u64 carry = 0;
        for (size_t j = 0; j < n; j++) {
            u128 s = (u128)a.v[j] * b.v[i] + t[j] + carry;
            t[j] = (u64)s;
            carry = (u64)(s >> 64);
        }
        u128 s = (u128)t[n] + carry;
        t[n] = (u64)s;
        t[n + 1] = (u64)(s >> 64);

        u64 m = t[0] * F.m0;
        carry = 0;
        {
            u128 s0 = (u128)m * F.mod[0] + t[0];
            carry = (u64)(s0 >> 64);
        }
        for (size_t j = 1; j < n; j++) {
            u128 s2 = (u128)m * F.mod[j] + t[j] + carry;
            t[j - 1] = (u64)s2;
            carry = (u64)(s2 >> 64);
        }
        u128 s3 = (u128)t[n] + carry;
        t[n - 1] = (u64)s3;
        t[n] = t[n + 1] + (u64)(s3 >> 64);
        t[n + 1] = 0;
    }
    if (t[n] || fe_cmp(F, t, F.mod) >= 0)
        fe_sub_raw(F, t, t, F.mod);
    std::memcpy(out.v, t, n * sizeof(u64));
    for (size_t i = n; i < MAX_LIMBS; i++) out.v[i] = 0;
}

static inline void fe_sqr(const FieldCtx& F, Fe& out, const Fe& a) {
    fe_mul(F, out, a, a);
}

static void fe_to_mont(const FieldCtx& F, Fe& out, const Fe& a) {
    Fe rr;
    std::memcpy(rr.v, F.rr, sizeof(rr.v));
    fe_mul(F, out, a, rr);
}

static void fe_from_mont(const FieldCtx& F, Fe& out, const Fe& a) {
    Fe one;
    fe_zero(F, one);
    one.v[0] = 1;
    fe_mul(F, out, a, one);
}

// ---------------------------------------------------------------------------
// xyzz / jacobian points (ec/xyzz_t.hpp, ec/jacobian_t.hpp formulas)
// ---------------------------------------------------------------------------

struct Xyzz { Fe x, y, zz, zzz; };     // infinity: zz == 0
struct Jac  { Fe x, y, z; };           // infinity: z == 0

static void xyzz_set_inf(const FieldCtx& F, Xyzz& p) {
    fe_zero(F, p.x); fe_zero(F, p.y); fe_zero(F, p.zz); fe_zero(F, p.zzz);
}

static void xyzz_dbl(const FieldCtx& F, Xyzz& out, const Xyzz& p) {
    if (fe_is_zero(F, p.zz) || fe_is_zero(F, p.y)) { xyzz_set_inf(F, out); return; }
    Fe U, V, W, S, M, X3, Y3, t, x2;
    fe_add(F, U, p.y, p.y);
    fe_sqr(F, V, U);
    fe_mul(F, W, U, V);
    fe_mul(F, S, p.x, V);
    fe_sqr(F, x2, p.x);
    fe_add(F, M, x2, x2); fe_add(F, M, M, x2);
    fe_sqr(F, X3, M);
    fe_add(F, t, S, S);
    fe_sub(F, X3, X3, t);
    fe_sub(F, t, S, X3);
    fe_mul(F, Y3, M, t);
    fe_mul(F, t, W, p.y);
    fe_sub(F, Y3, Y3, t);
    Fe ZZ3, ZZZ3;
    fe_mul(F, ZZ3, V, p.zz);
    fe_mul(F, ZZZ3, W, p.zzz);
    out.x = X3; out.y = Y3; out.zz = ZZ3; out.zzz = ZZZ3;
}

// mixed add of an affine (Montgomery-form) point; sign subtracts
// (ec/xyzz_t.hpp:352-430)
static void xyzz_madd(const FieldCtx& F, Xyzz& acc, const Fe& ax,
                      const Fe& ay_in, bool subtract) {
    if (fe_is_zero(F, ax) && fe_is_zero(F, ay_in)) return;   // infinity
    Fe ay;
    if (subtract) fe_neg(F, ay, ay_in); else ay = ay_in;
    if (fe_is_zero(F, acc.zz)) {
        acc.x = ax; acc.y = ay;
        fe_zero(F, acc.zz); fe_zero(F, acc.zzz);
        // one in Montgomery form == to_mont(1)
        Fe one; fe_zero(F, one); one.v[0] = 1;
        fe_to_mont(F, acc.zz, one);
        acc.zzz = acc.zz;
        return;
    }
    Fe U2, S2, P, R;
    fe_mul(F, U2, ax, acc.zz);
    fe_mul(F, S2, ay, acc.zzz);
    fe_sub(F, P, U2, acc.x);
    fe_sub(F, R, S2, acc.y);
    if (fe_is_zero(F, P)) {
        if (fe_is_zero(F, R)) { Xyzz d; xyzz_dbl(F, d, acc); acc = d; }
        else xyzz_set_inf(F, acc);
        return;
    }
    Fe PP, PPP, Q, X3, Y3, t;
    fe_sqr(F, PP, P);
    fe_mul(F, PPP, P, PP);
    fe_mul(F, Q, acc.x, PP);
    fe_sqr(F, X3, R);
    fe_sub(F, X3, X3, PPP);
    fe_add(F, t, Q, Q);
    fe_sub(F, X3, X3, t);
    fe_sub(F, t, Q, X3);
    fe_mul(F, Y3, R, t);
    fe_mul(F, t, acc.y, PPP);
    fe_sub(F, Y3, Y3, t);
    fe_mul(F, acc.zz, acc.zz, PP);
    fe_mul(F, acc.zzz, acc.zzz, PPP);
    acc.x = X3; acc.y = Y3;
}

static void xyzz_add(const FieldCtx& F, Xyzz& acc, const Xyzz& q) {
    if (fe_is_zero(F, q.zz)) return;
    if (fe_is_zero(F, acc.zz)) { acc = q; return; }
    Fe U1, U2, S1, S2, P, R;
    fe_mul(F, U1, acc.x, q.zz);
    fe_mul(F, U2, q.x, acc.zz);
    fe_mul(F, S1, acc.y, q.zzz);
    fe_mul(F, S2, q.y, acc.zzz);
    fe_sub(F, P, U2, U1);
    fe_sub(F, R, S2, S1);
    if (fe_is_zero(F, P)) {
        if (fe_is_zero(F, R)) { Xyzz d; xyzz_dbl(F, d, acc); acc = d; }
        else xyzz_set_inf(F, acc);
        return;
    }
    Fe PP, PPP, Q, X3, Y3, t;
    fe_sqr(F, PP, P);
    fe_mul(F, PPP, P, PP);
    fe_mul(F, Q, U1, PP);
    fe_sqr(F, X3, R);
    fe_sub(F, X3, X3, PPP);
    fe_add(F, t, Q, Q);
    fe_sub(F, X3, X3, t);
    fe_sub(F, t, Q, X3);
    fe_mul(F, Y3, R, t);
    fe_mul(F, t, S1, PPP);
    fe_sub(F, Y3, Y3, t);
    fe_mul(F, acc.zz, acc.zz, q.zz);
    fe_mul(F, acc.zz, acc.zz, PP);
    fe_mul(F, acc.zzz, acc.zzz, q.zzz);
    fe_mul(F, acc.zzz, acc.zzz, PPP);
    acc.x = X3; acc.y = Y3;
}

// ---------------------------------------------------------------------------
// signed-digit window decomposition (msm/pippenger.cuh:63-117 semantics)
// ---------------------------------------------------------------------------

struct ScalarCtx {
    size_t n;                  // 64-bit limbs
    u64 order[MAX_LIMBS];
    u64 half[MAX_LIMBS];       // order >> 1
};

static bool scalar_gt_half(const ScalarCtx& S, const u64* s) {
    for (size_t i = S.n; i-- > 0;) {
        if (s[i] != S.half[i]) return s[i] > S.half[i];
    }
    return false;
}

static void scalar_fold(const ScalarCtx& S, u64* out, const u64* s,
                        bool* neg) {
    *neg = scalar_gt_half(S, s);
    if (!*neg) { std::memcpy(out, s, S.n * sizeof(u64)); return; }
    u64 borrow = 0;
    for (size_t i = 0; i < S.n; i++) {
        u64 d = S.order[i] - s[i];
        u64 b2 = (S.order[i] < s[i]);
        u64 d2 = d - borrow;
        b2 |= (d < borrow);
        out[i] = d2;
        borrow = b2;
    }
}

static inline u64 get_window(const u64* s, size_t nlimbs, size_t off,
                             size_t wbits) {
    size_t limb = off >> 6, sh = off & 63;
    u64 lo = s[limb] >> sh;
    if (sh && limb + 1 < nlimbs) lo |= s[limb + 1] << (64 - sh);
    return lo & ((1ull << wbits) - 1);
}

// ---------------------------------------------------------------------------
// Pippenger (msm/pippenger.hpp:220-350 shape: per-window buckets + integrate)
// ---------------------------------------------------------------------------

extern "C" {

typedef struct { int code; char* message; } sppark_err;

static sppark_err err_ok() { return sppark_err{0, nullptr}; }
static sppark_err err_fail(const char* msg) {
    return sppark_err{1, strdup(msg)};
}

void sppark_drop_error_message(char* msg) { free(msg); }

// points: n * (2*field_limbs) u64 canonical affine (x, y), infinity = (0,0)
// scalars: n * scalar_limbs u64 canonical
// out: 3 * field_limbs u64 canonical jacobian (x, y, z)
sppark_err sppark_cpu_msm(const u64* field_mod, u64 field_m0,
                          size_t field_limbs, const u64* field_rr,
                          const u64* order, size_t scalar_limbs,
                          size_t scalar_bits, const u64* points,
                          const u64* scalars, size_t npoints, size_t wbits,
                          int nthreads, u64* out) {
    if (field_limbs > MAX_LIMBS || scalar_limbs > MAX_LIMBS)
        return err_fail("limb count exceeds MAX_LIMBS");
    if (npoints == 0) {
        std::memset(out, 0, 3 * field_limbs * sizeof(u64));
        return err_ok();
    }

    FieldCtx F{};
    F.n = field_limbs;
    std::memcpy(F.mod, field_mod, field_limbs * sizeof(u64));
    F.m0 = field_m0;
    std::memcpy(F.rr, field_rr, field_limbs * sizeof(u64));

    ScalarCtx S{};
    S.n = scalar_limbs;
    std::memcpy(S.order, order, scalar_limbs * sizeof(u64));
    u64 carry = 0;
    for (size_t i = scalar_limbs; i-- > 0;) {
        S.half[i] = (S.order[i] >> 1) | (carry << 63);
        carry = S.order[i] & 1;
    }

    if (wbits == 0) {
        size_t m = npoints + npoints / 2;
        size_t lg = 0;
        while ((m >> lg) > 1) lg++;
        wbits = lg > 8 ? lg - 8 : 1;
        if (wbits < 10) wbits = 10;
        if (wbits > 18) wbits = 18;
    }
    const size_t nwins = (scalar_bits + wbits - 1) / wbits;
    const size_t nbuckets = 1ull << (wbits - 1);

    // precompute Montgomery-form points once (shared across windows)
    std::vector<Fe> px(npoints), py(npoints);
    for (size_t i = 0; i < npoints; i++) {
        Fe x{}, y{};
        std::memcpy(x.v, points + i * 2 * field_limbs,
                    field_limbs * sizeof(u64));
        std::memcpy(y.v, points + (i * 2 + 1) * field_limbs,
                    field_limbs * sizeof(u64));
        if (fe_is_zero(F, x) && fe_is_zero(F, y)) {
            fe_zero(F, px[i]); fe_zero(F, py[i]);
        } else {
            fe_to_mont(F, px[i], x);
            fe_to_mont(F, py[i], y);
        }
    }
    // fold scalars once
    std::vector<u64> folded(npoints * scalar_limbs);
    std::vector<uint8_t> gneg(npoints);
    for (size_t i = 0; i < npoints; i++) {
        bool neg;
        scalar_fold(S, folded.data() + i * scalar_limbs,
                    scalars + i * scalar_limbs, &neg);
        gneg[i] = neg;
    }

    // one window per work item (the 2-D tile grid of pippenger.hpp:160-190
    // degenerates to per-window strips at library-test sizes)
    std::vector<Xyzz> win_sum(nwins);
    std::atomic<size_t> ticket{0};
    int T = nthreads > 0 ? nthreads
                         : (int)std::thread::hardware_concurrency();
    if (T < 1) T = 1;

    auto worker = [&]() {
        std::vector<Xyzz> buckets(nbuckets);
        for (;;) {
            size_t w = ticket.fetch_add(1);
            if (w >= nwins) break;
            for (auto& b : buckets) xyzz_set_inf(F, b);
            for (size_t i = 0; i < npoints; i++) {
                const u64* s = folded.data() + i * scalar_limbs;
                // booth-encoded digit for window w with ripple carry from
                // lower windows (recomputed locally: carry = 1 iff lower
                // window digit overflowed; scan from window 0)
                u64 c = 0, mag = 0; bool dneg = false;
                for (size_t v = 0; v <= w; v++) {
                    u64 d = get_window(s, scalar_limbs, v * wbits, wbits) + c;
                    bool last = (v == nwins - 1);
                    dneg = !last && d >= (1ull << (wbits - 1));
                    mag = dneg ? (1ull << wbits) - d : d;
                    c = dneg;
                }
                if (mag == 0) continue;
                bool sign = dneg ^ (bool)gneg[i];
                xyzz_madd(F, buckets[mag - 1], px[i], py[i], sign);
            }
            // integrate: sum_b (b+1) * bucket[b] via acc/res suffix sweep
            Xyzz acc, res;
            xyzz_set_inf(F, acc);
            xyzz_set_inf(F, res);
            for (size_t b = nbuckets; b-- > 0;) {
                xyzz_add(F, acc, buckets[b]);
                xyzz_add(F, res, acc);
            }
            win_sum[w] = res;
        }
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < T; t++) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();

    // window doubling-merge (collect(), pippenger.cuh:667-727), MSB first
    Xyzz total;
    xyzz_set_inf(F, total);
    for (size_t w = nwins; w-- > 0;) {
        for (size_t d = 0; d < wbits; d++) {
            Xyzz t2; xyzz_dbl(F, t2, total); total = t2;
        }
        xyzz_add(F, total, win_sum[w]);
    }

    // convert to canonical jacobian (z = zzz/zz ... emit via x/zz^-? ):
    // output jacobian with Z' = zz*zzz, X' = x*zz^4, Y' = y*zz^6
    // (inversion-free; ec/xyzz_t.hpp:87-90 analogue)
    Fe X, Y, Z;
    if (fe_is_zero(F, total.zz)) {
        fe_zero(F, X); fe_zero(F, Y); fe_zero(F, Z);
    } else {
        Fe zz2, zz4, zz6;
        fe_sqr(F, zz2, total.zz);
        fe_sqr(F, zz4, zz2);
        fe_mul(F, zz6, zz4, zz2);
        fe_mul(F, X, total.x, zz4);
        fe_mul(F, Y, total.y, zz6);
        fe_mul(F, Z, total.zz, total.zzz);
        // back to canonical form
        Fe t2;
        fe_from_mont(F, t2, X); X = t2;
        fe_from_mont(F, t2, Y); Y = t2;
        fe_from_mont(F, t2, Z); Z = t2;
    }
    std::memcpy(out, X.v, field_limbs * sizeof(u64));
    std::memcpy(out + field_limbs, Y.v, field_limbs * sizeof(u64));
    std::memcpy(out + 2 * field_limbs, Z.v, field_limbs * sizeof(u64));
    return err_ok();
}

// probe mirroring cuda_available() (util/cuda_available.cu:10-23)
int sppark_cpu_available(void) { return 1; }

}  // extern "C"
