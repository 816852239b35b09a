"""Smoke run of the PyTorch/CUDA port (sppark_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from sppark_tpu_torch/csrc, then:
  1. prints the toolchain, the card, and the build time;
  2. holds each NTT kernel against its plain PyTorch version on the card,
     on any 64-bit input words (0, p - 1, p, p + 1 and 2^64 - 1 planted
     in the input and the multiplier, and 2^64 - 1 in a whole warp's
     lanes): the rows at every lg 1-13 over 1, 7, 16 and 37 rows and the
     batches (2, 5, n), (3, 16, n) and (3, 64, n) (B = 5 takes the
     transposed store's general path), every option; the columns at
     every lg 1-13 over 1, 2, 4, 8, 64 and 8192 columns, batched and not,
     with and without the middle matrix; and at the shapes the main path
     gives them, the six-step's included: exact equality (integer field
     arithmetic, tolerance zero);
  3. drives the main path, a Goldilocks forward NTT of 2^24 through the
     host-array entry point `ntt.ntt`, with the launch counts set to 0
     just before it and read just after; checks it against the plain path
     on the card, the intt round trip, the big-int oracle at small lg, and
     the four orders x forward/inverse x standard/coset at lg 10 and 16;
  4. drives the coset LDE 2^24 with blowup 4 (the six-step at lg 26) the
     same way; checks it against the plain path on the card, the inverse
     round trip and the oracle at lg 10;
  5. times the NTT, the LDE and each NTT kernel alone at its 2^24 shapes
     with CUDA events, beside the plain versions, the kernels' bounds and
     their registers and spills from the build log;
  6. holds the Montgomery multiply, the fixed-exponent power bigmont_pow
     (e = 0, 1, 2, p - 2, (p + 1) / 4 at 1, 31, 32, 33 and 2^16 lanes) and
     the three xyzz point kernels (on the carry-chain element) against
     their plain versions on test_bm64, Pasta and BLS12-381 (n32 = 2, 8,
     12), exactly, with edge values and planted special lanes (empty
     bucket, point at infinity, doubling,
     cancellation, coordinates p - 1 and p - 2, a warp with no doubling
     lane), and the madd through a gather table and a slot index
     (negated rows, the zero row, repeated rows);
  7. drives the MSM main path, BLS12-381 G1 2^24 through
     `MSMContext.set_points` + `invoke` on device-resident scalar words,
     with the launch counts set to 0 just before and read just after;
     checks it against the exact oracle over the whole input (2^11
     distinct points tiled), the chunked invoke, and at 2^10 `msm_naive`
     (zero, r - 1, doubling and cancelling scalars), Montgomery-form
     scalars and the plain path on the card (4-bit windows: a short
     integrate);
  8. drives Pasta G1 2^20 the same way (oracle, 2^10 checks);
  9. times both MSMs; profiles one 2^24 invoke for its peak memory, busy
     share and phases (the stages' record_function ranges), its device
     time by kernel and the kernels of its gather (the slot index: no
     index_select over the point table); times each MSM kernel alone at
     its main-path shapes (the madd through the table and the slot index),
     beside the plain versions and the bounds, and the dbl also at 2^18
     lanes; prints the dbl's single-thread floor and its registers and
     spills;
 10. holds the wide NTT kernels (bigmont_ntt_rows, bigmont_ntt_cols,
     bigmont_ntt_mid) against their plain versions on test_bm64_fr, BN254
     Fr, BLS12-381 Fr, BLS12-377 Fr and Pallas, every option, with the
     words 0, 1, p - 1 and p - 2 planted in the inputs and the multiplier,
     exactly;
 11. drives the wide main path, a BLS12-381 Fr forward NTT of 2^26 through
     `ntt.base_dev` on device-resident words (bench.py:bench_ntt_wide),
     with the launch counts set to 0 just before and read just after;
     checks the intt round trip, three outputs against sum_i x_i w^(ik)
     evaluated on the card, each of its five kernel launches against the
     plain versions on slices of its own arrays, the plain facade and the
     host-array `ntt.ntt` at 2^20, the big-int oracle at small lg (BLS12-381
     and BN254 Fr) and the 16 configurations at lg 10 and 16;
 12. drives the wide LDE 2^24 x 4 (checks: inverse coset round trip, the
     plain path at 2^16, the oracle at 2^8);
 13. times the wide NTT, the LDE and each wide kernel alone at its 2^26
     shapes, beside the plain versions (on a 2^20-element slice) and the
     bounds, and reads the peak device memory of one NTT;
 14. holds the three fp2 point kernels (ec_fp2_xyzz_madd and _add, on a
     lane pair of threads per point, / dbl, on a lane pair of carry-chain
     threads) against their plain versions
     on test_bm64_g2, BN254, BLS12-381 and BLS12-377 G2 (nonresidues 7,
     -1, -1, -5), exactly, with the planted lanes of phase 6, point-major
     rows, a gather table and a slot index, a warp with no special lane,
     warps of 16 buckets with
     exactly one doubling pair and one pair at infinity (madd), warps of
     16 lanes with exactly one doubling, infinite or cancelling lane
     (add), warps of 16 lanes with exactly one Y == 0 or ZZ == 0 lane or
     none (dbl), and 1, 17 and 65 lanes;
 15. drives the G2 main path, BLS12-381 G2 2^23 (the reference bench's G2
     size) through `MSMContext.set_points` + `invoke`, with the launch
     counts set to 0 just before and read just after: 2^11 base points
     r_j G (one cofactor-cleared G, seeded uniform r_j) tiled, infinity at
     index 3, seeded scalar words; checks it against the exact result
     (sum_j c_j r_j mod r) G over all 2^23 terms, the chunked invoke, and
     at 2^8 `msm_naive` with planted scalars, Montgomery-form scalars and
     the plain path on the card; BN254 and BLS12-377 G2 MSMs and a
     BLS12-377 G1 MSM of 64 points against `msm_naive`;
 16. times the G2 MSM, profiles one invoke (peak memory, busy share,
     phases) and times each fp2 kernel alone at its main-path shapes
     beside its plain version and its bound, the dbl also at 2^18 lanes,
     prints the dbl's device microseconds a launch in the profiled invoke
     and its registers and spills, and the G2 phases' seconds;
 17. holds the four batch-affine pair kernels (ec_pair_prep / _finish,
     ec_fp2_pair_prep / _finish) against their plain versions on
     test_bm64, Pasta, BLS12-381 and the four G2 curves, exactly: planted
     infinities, doubling, cancellation and a y == 0 doubling, a warp with
     no doubling lane, one with one, one of all doubling lanes, on
     limb-major operands and on the operands a tree level reads (a point
     table through an index pair, level 1's; the even/odd lanes of a
     limb-major level); for the lane-pair fp2 prep and finish also warps
     of 16 chords with exactly one tangent, cancelling, copy or zero lane
     and 1, 17 and 65 lanes, on each view;
 17b. holds the batch inversion's kernels (bigmont_inv_up, bigmont_inv_down)
     against their plain versions on the same inputs, in degree 1 on
     test_bm64, Pasta and BLS12-381 Fp and in degree 2 on the BLS12-381,
     BN254 and BLS12-377 G2 fields (nonresidues -1, -1, -5), at 1, 31,
     4095, 4097 and 2^16 + 3 lanes (T C = 4096 lanes a block) with zero,
     (0, c1) and (c0, 0) lanes,
     and the three-launch pipeline (up, bigmont_pow, down) against
     mont_batch_inv_plain, exactly; then a * a^-1 == 1 against the big-int
     oracle on 4096 lanes of BLS12-381 Fp and Fp2;
 18. drives the segmented-tree MSM (mode="tree") through `MSMContext`:
     BLS12-381 G1 2^24 on phase 7's input, equal to its exact result, with
     the launch counts set to 0 just before and read just after, the
     chunked invoke, and at 2^10 `msm_naive` with planted and all-equal
     scalars, Montgomery-form scalars and the plain path on the card; then
     BLS12-381 G2 2^23 on phase 15's input, equal to its exact result;
     each tree launched bigmont_inv_up, bigmont_pow and bigmont_inv_down
     once per level and once for to_affine;
 19. times both tree MSMs, profiles each invoke (peak memory, busy share,
     phases, kernels, the kernels of its gather: the level-0 index, no
     index_select over the point table; per invoke the launches and device
     ms of bigmont_ew, the batch inversion's kernels and the elementwise
     kernels, and msm.tree_levels' device and host ms) and times each pair
     kernel alone at its level-1 shape, through the point table and window
     group 0's level-0 index (and the G1 finish's registers and spills,
     and each tree's dbl's device microseconds a launch); the batch
     inversion at level 1 on the main path's denominators (each kernel
     alone, the plain versions on a 2^20 lane slice held against the
     kernels there, the pipeline by events,
     and the pipeline and the product tree it replaced by the wall clock);
     and bigmont_pow at one lane (x^(p - 2), every inversion's
     shape), beside its plain version and its bound, and prints
     bigmont_pow's chain and its single-thread floor, and the same
     inversion timed as the chain of bigmont_ew launches it replaced;
 20. holds the mont32 NTT kernels (mont32_ntt_rows, mont32_ntt_cols)
     against their plain versions on BabyBear with both generators, every
     option, canonical words with 0, 1 and p - 1 planted, at every lg (rows
     1-13, columns 1-11: each split of the radix-16 passes), row counts
     that are not a multiple of a block's rows (7), out_t with OB > 1 and B
     = 5 (the store's general path) or 16 (runs of rows, at lg 12-13 across
     a cluster), 2, 8 and 8192 columns, batched and not, and at the shapes
     the narrow main paths give them (the four-step at 2^20 and 2^24, the
     six-step at 2^26), exactly;
 21. drives BASELINE config 1, a BabyBear forward and inverse NTT of 2^20
     through the host-array entry points `ntt.ntt` / `ntt.intt`, for both
     generators, with the launch counts set to 0 just before and read just
     after; checks the plain path on the card, the round trip, the
     big-int oracle at lg 1, 12 and 14 and the 16 configurations at lg 10
     and 16;
 22. drives a BabyBear forward NTT of 2^24 through `ntt.base_dev` (the
     four-step): the round trip and three outputs against sum_i x_i
     w^(ik) evaluated on the card;
 23. drives the BabyBear coset LDE 2^24 x 4 (`lde_dev`, the six-step at
     lg 26): the plain path on the card, the inverse coset round trip and
     the oracle at 2^10 x 2;
 24. drives the batched trace LDE, a (64, 2^20) batch of BabyBear columns
     x 4 (`lde_dev` on a 2-D tensor, 1 GiB out): two columns against the
     single-column LDE and the plain path;
 25. times config 1's pair, the NTT 2^24 (dependent chain), the LDE and
     the trace LDE with their parts, and each mont32 kernel alone at its 2^24
     shapes beside its plain version, its bound and its registers and
     spills, and prints the narrow phases' seconds;
 26. drives the MSM mode "xyzz" (MSMRoundStages: one madd launch a
     round through the table index) on phase 7's BLS12-381 G1 2^24 input
     and phase 15's G2 2^23 input, each with the launch counts set to 0
     just before and read just after, equal to its exact result, G1 also
     chunked; at 2^10 (G2 2^8) msm_naive with planted scalars (0, r - 1,
     r // 2 + 1, doubling and cancelling terms), Montgomery-form scalars,
     and for G1 the plain path on the card at 8-bit windows on the first
     2^6 of those points; prints the
     rounds and the madd launches, and times and profiles each invoke
     (wall, device busy, phases, kernels, no index_select in its gather);
 27. drives the mode "affine" (five launches a round: the pair prep, the
     batch inversion's three, the pair finish, reading the point through
     the table index) the same way on BLS12-381 G1 and G2 2^20, equal to
     the exact results of the tiled inputs; both modes with all-equal
     scalars at 2^12 (rounds = n) against msm_naive; and batch_addition
     on the BLS12-381 G1 2^20 input with a seeded bitmap and refmap
     against the oracle sum of the tiled base, the empty selection, its
     launches and time;
 28. drives the polynomial ops (sppark_tpu_torch.polynomial) at 2^24 over
     Goldilocks, BabyBear and BLS12-381 Fr (prefix_sum, prefix_product,
     div_by_x_minus_z in both layouts) and evaluate of a 2^20-coefficient
     polynomial at 8 points, each op's bigmont_ew launches counted around
     it: at 2^16 word for word against the plain path on the card; at full
     size the scans' recurrences at every position, 1,024 sampled
     positions and the first 4,096 against Python ints, the remainder ==
     evaluate(p, z), q(t) (t - z) + r == p(t) at a random t, evaluate ==
     p_lo(x) + x^(n/2) p_hi(x) and, on a 2^12 slice, Horner over ints;
     times each op;
 29. on an NCCL process group of one (parallel.init_distributed: the
     collectives run, nothing is skipped at a world size of 1), BASELINE
     config 5's one-card half: ntt_sharded and ntt_matrix_sharded,
     forward and inverse, Goldilocks 2^24 and BN254 Fr 2^26, launch counts
     around them, equal word for word to ntt.base_dev of the same input;
     times them beside the single-device NTT;
 30. on the same group the sharded MSM, BN254 G1 2^26 (config 5's MSM;
     2^11 points tiled, msm_input), launch counts around it, equal to the
     exact result and to MSMContext(mode="xyzz"); its wall time and peak
     memory; then destroys the group;
 31. scalar_mul and the jacobian ops on BLS12-381 G1 and G2 over 2^12
     lanes (16 points tiled, one at infinity) against the oracle on every
     lane, their launches counted; xyzz_madd with `sign` per lane and
     through a table and its index against the plain madd with sign; the
     host ffi.native.cpu_msm (built from the checkout) on BN254 2^16
     against the port's MSM; prints the phases' seconds;
 32. runs the port's two examples through their `main` on the card,
     the launch counts set to 0 before each and read after:
     examples/ntt_example.py on Goldilocks and BabyBear 2^24 (host arrays:
     NTT, iNTT, the coset pair, LDE x4), its round trips exact, through
     the row and column kernels; examples/msm_example.py on BN254 and
     BLS12-381 G1 2^20 (2^11 oracle points tiled, infinity at index 3),
     equal to the host ffi.native.cpu_msm and on the curve, through the
     madd, add, dbl, the batch inversion and bigmont_ew; prints each run's
     wall time; fails past 90 s;
 33. prints one JSON line of the numbers, one of the kernels (each
     entry's launches counting phases 28-32's paths too), the run's
     seconds, the card's name and power limit, and last {"ok": true,
     "device": {...}}.
Bounds: the larger of the bytes moved over 3.35 TB/s and the 32-bit
integer operations over the card's INT32 rate (SMs x 64 lanes x the
maximum SM clock, read from nvidia-smi); a radix-2 transform of length n
counts an add and a sub for each of its (n/2) lg n butterflies and a
product for each butterfly whose twiddle is not w^0 = 1, all but n - 1 of
them (transform_ops): a wide product 4 n32^2, a wide add and sub 2 n32
each, a mont32 product 9 and its add and sub 6, counted from
csrc/ntt_mont32.cu, a Goldilocks product 12 and its add and sub 8; an fp2
product 3 products and its additions, an fp2 squaring 2 squarings, a
product and its additions (fp2_ops); bigmont_pow the squarings and products
of its windowed chain (pow_chain); the batch inversion's kernels the
products, squarings and additions of their schedule (inv_counts).
Any failed check raises, so the run exits non-zero and prints no last line.
It exits non-zero at once without a CUDA device or without the package.
"""

import bisect
import json
import random
import re
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM device memory rate (NVIDIA data sheet); the 32-bit integer rate
# is read from the card (int32_rate)
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer operations counted per Goldilocks product (one 64x64 ->
# 128-bit product as four 32x32 products and its reduction) and per
# butterfly's add and sub; a floor, not a count of issued instructions
OPS_PER_MUL = 12
OPS_ADD_SUB = 8
WORD = 8

FIELD = "goldilocks"
LG = 24
LG_BLOWUP = 2
GL64_ROW_LGS = tuple(range(1, 14))      # phase 2's row lengths,
GL64_ROW_COUNTS = (1, 7, 16, 37)        # row counts,
GL64_ROW_BATCHES = ((2, 5), (3, 16), (3, 64))   # (OB, B) batches,
GL64_COL_LGS = tuple(range(1, 14))      # column lengths
GL64_COL_COUNTS = (1, 2, 4, 8, 64, 8192)    # and column counts
M64 = (1 << 64) - 1

MSM_CURVE, MSM_LG = "bls12_381", 24      # BASELINE config 4
PASTA_CURVE, PASTA_LG = "pallas", 20     # BASELINE config 3
LG_BASE = 11        # distinct points, tiled (the reference bench protocol)
LG_SMALL = 10       # the msm_naive and plain-path checks
PLAIN_WBITS = 4     # the plain path's windows: few buckets, a short integrate
ROUND_PLAIN_WBITS = 8   # the round modes' plain path: few rounds
ROUND_PLAIN_LG = 6      # on the first 2^6 of the small check's points
EC_CURVES = ("test_bm64", "pallas", "bls12_381")
POW_LANES = (1, 31, 32, 33, 1 << 16)    # bigmont_pow's checks: prefixes
DBL_WIDE_LANES = 1 << 18    # the G1 dbl timed at a wide shape too
M32 = 0xFFFFFFFF


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")
    print(f"ok  {what}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def int32_rate():
    """32-bit integer operations per second: SMs x 64 INT32 lanes x the
    maximum SM clock (nvidia-smi clocks.max.sm, MHz)."""
    import torch
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 64 * mhz * 1e6


def bound(nbytes, ops, rate):
    """(bound ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def max_abs_err(a, b):
    """Largest |a - b| over the words as unsigned integers (0 = equal)."""
    import torch
    from sppark_tpu_torch.ff import gl64

    diff = torch.ne(a, b)
    if not bool(diff.any()):
        return 0
    wa, wb = gl64.to_ints(a[diff]), gl64.to_ints(b[diff])
    return max(abs(x - y) for x, y in zip(wa, wb))


def median_ms(fn, reps, warmup=1):
    from sppark_tpu_torch.runtime import time_ms
    return statistics.median(time_ms(fn, reps=reps, warmup=warmup))


# -- MSM phases (6-9) -----------------------------------------------------------

def word_err(a, b):
    """Largest |a - b| over u32 words of two coordinate tuples (0 =
    equal); any shape mismatch counts as 2^32."""
    import torch
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            return 1 << 32
        d = (x.to(torch.int64) & M32) - (y.to(torch.int64) & M32)
        if d.numel():
            err = max(err, int(d.abs().max()))
    return err


def rand_canon(F, n, rng, dev):
    """(n32, n) random canonical words, the edge values 0, 1, p - 1 and
    R mod p in the first lanes."""
    import torch
    from sppark_tpu_torch.ff.kernels import int_words
    w = rng.integers(0, 1 << 32, size=(F.n32, n), dtype=np.uint64)
    w = w.astype(np.uint32)
    w[-1] %= np.uint32(F.p >> (32 * (F.n32 - 1)))
    for k, v in enumerate([0, 1, F.p - 1, F.params.R % F.p][:n]):
        w[:, k] = int_words(v, F.n32)
    return torch.from_numpy(w.view(np.int32)).to(dev)


def scalar_words(ints, n_words, dev):
    import torch
    w = np.array([[(s >> (32 * i)) & M32 for s in ints]
                  for i in range(n_words)], dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(dev)


def ec_cases(curve, n, dev, seed):
    """Point-kernel inputs over n lanes (n >= 64): xyzz buckets p with
    ZZ != 1, affine points a, xyzz points q with ZZ != 1.  Lanes 0..31 (one
    warp) are generic: no doubling lane.  The specials sit in the second
    warp: lane 33 doubles (a, q == p), 34 cancels (a, q == -p), 35 has a
    and q at infinity, 36 an empty bucket p, 37 both, 38 Y == 0 (a
    doubling to infinity); the last two lanes double and cancel again."""
    import torch
    from sppark_tpu_torch.ec.core import get_curve_ops
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.oracle.ec import get_oracle
    from sppark_tpu_torch.params import get_curve

    cp = get_curve(curve)
    o = get_oracle(cp)
    ops = get_curve_ops(curve, FK.PLAIN)
    F = ops.F
    rng = random.Random(seed)
    pool = [o.random_point(rng) for _ in range(16)]
    twice = [o.jacobian_to_affine(o.jacobian_dbl(o.to_jacobian(P)))
             for P in pool]
    j = [rng.randrange(16) for _ in range(n)]
    aff = [pool[(j[i] + 1 + rng.randrange(15)) % 16] for i in range(n)]
    for lane in (33, n - 2):
        aff[lane] = twice[j[lane]]
    for lane in (34, n - 1):
        aff[lane] = o.affine_neg(twice[j[lane]])
    aff[35] = aff[37] = o.infinity_affine()
    # p: 2 P_j by the plain doubling, so ZZ != 1
    p = ops.xyzz_dbl(ops.affine_to_xyzz(ops.affine_from_ints(
        [pool[k] for k in j], dev)))
    p = tuple(c.clone() for c in p)
    for c in p:
        c[:, 36:38] = 0
    p[1][:, 38] = 0
    a = ops.affine_from_ints(aff, dev)
    # q: a rescaled by a random nonzero lambda: (x l^2, y l^3, l^2, l^3)
    if cp.fp2 is None:
        lam = [rng.randrange(1, F.p) for _ in range(n)]
    else:
        lam = [(rng.randrange(F.p), rng.randrange(1, F.p)) for _ in range(n)]
    lam = F.from_int_list(lam, device=dev)
    l2 = F.sqr(lam)
    l3 = F.mul(l2, lam)
    q = ops._sel(ops.affine_is_inf(a), ops.xyzz_infinity((n,), dev),
                 (F.mul(a[0], l2), F.mul(a[1], l3), l2, l3))
    return p, a, q


def edge_lanes(curve, p, a, q):
    """p, a, q of ec_cases with lanes 40..43 at coordinates p - 1 and
    p - 2 (the carry chains' edge; test_bm64's p has no spare bit): 40 all
    p - 1, 41 all p - 2, 42 and 43 the bucket at one, the points at the
    other."""
    import torch
    from sppark_tpu_torch.ff.kernels import int_words
    from sppark_tpu_torch.params import get_curve

    cp = get_curve(curve)
    fp = cp.field

    def col(v):
        w = np.array(int_words(v, fp.n_ref_limbs) * cp.degree,
                     dtype=np.uint32)
        return torch.from_numpy(w.view(np.int32)).to(p[0].device)

    m1, m2 = col(fp.modulus - 1), col(fp.modulus - 2)
    p, a, q = ([c.clone() for c in t] for t in (p, a, q))
    for lane, bucket, other in ((40, m1, m1), (41, m2, m2), (42, m1, m2),
                                (43, m2, m1)):
        for c in p:
            c[:, lane] = bucket
        for c in a + q:
            c[:, lane] = other
    return tuple(p), tuple(a), tuple(q)


def table_case(curve, a, n, seed):
    """The gather table of the affine points a (slab.point_rows) as two
    (W, rows) coordinates, and n slot indices into it: points, negated
    points, the zero row, repeated rows."""
    import torch
    from sppark_tpu_torch.ec.core import get_curve_ops
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.msm import slab

    rows = slab.point_rows(get_curve_ops(curve, FK.PLAIN).F, *a)
    w = a[0].shape[0]
    m = rows.shape[0]
    idx = np.random.default_rng(seed).integers(0, m, size=n)
    idx[:6] = [0, m // 2, m - 1, m - 1, 5, 5]
    return (rows[:, :w].T, rows[:, w:].T), torch.from_numpy(
        idx.astype(np.int32)).to(rows.device)


def msm_input(curve, lg, dev, base=None):
    """The reference bench protocol (bench.py:287-301, 322-328): 2^11
    distinct random points (or the given `base`) tiled to 2^lg with
    infinity at index 3, seeded numpy scalar words with the top word
    reduced below the order's."""
    import torch
    from sppark_tpu_torch.ec import get_curve_ops
    from sppark_tpu_torch.oracle.ec import get_oracle
    from sppark_tpu_torch.params import get_curve

    cp = get_curve(curve)
    n, nbase = 1 << lg, 1 << LG_BASE
    if base is None:
        rng = random.Random(42)
        base = [get_oracle(cp).random_point(rng) for _ in range(nbase)]
    bx, by = get_curve_ops(curve).affine_from_ints(base, dev)
    px, py = bx.repeat(1, n // nbase), by.repeat(1, n // nbase)
    px[:, 3] = 0
    py[:, 3] = 0
    n_words = (cp.scalar.bits + 31) // 32
    words = np.random.default_rng(42).integers(
        0, 1 << 32, size=(n_words, n), dtype=np.uint64).astype(np.uint32)
    words[-1] %= np.uint32(max(cp.scalar.modulus >> (32 * (n_words - 1)),
                               1))
    return base, (px, py), words, torch.from_numpy(words.view(np.int32)).to(
        dev)


def class_sums(nbase, words, order):
    """The scalar of each distinct point of a tiled input: point i is
    base[i mod nbase] (index 3 at infinity), so MSM = sum_j c_j B_j with
    c_j = sum_{i = j mod nbase, i != 3} s_i mod r.  The sums run in numpy
    over u64 words (2^13 terms of < 2^32 each cannot overflow)."""
    n_words, n = words.shape
    sums = words.reshape(n_words, n // nbase, nbase).sum(axis=1,
                                                         dtype=np.uint64)
    cls = [sum(int(sums[w, j]) << (32 * w) for w in range(n_words))
           for j in range(nbase)]
    cls[3] -= sum(int(words[w, 3]) << (32 * w) for w in range(n_words))
    return [c % order for c in cls]


def tiled_oracle(curve, base, words):
    """The exact MSM of a tiled input, by msm_naive over the class sums."""
    from sppark_tpu_torch.oracle.msm import msm_naive
    from sppark_tpu_torch.params import get_curve

    cp = get_curve(curve)
    return msm_naive(cp, base, class_sums(len(base), words,
                                          cp.scalar.modulus))


def reset_all():
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ff import kernels as FK
    EK.reset_launches()
    FK.reset_launches()


def read_all(curve, mode="auto"):
    """The launch counts of the kernels a curve's MSM runs in `mode`: its
    degree's point kernels of the slab and mode "xyzz" (madd, add, dbl) or
    of the tree and mode "affine" (pair prep and finish, add, dbl), and
    the field kernels."""
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ff import kernels as FK
    ops = EK.TREE_OPS if mode in ("tree", "affine") else EK.SLAB_OPS
    counts = {**EK.launches, **EK.fp2_launches}
    names = [EK.kernel_name(op, curve) for op in ops]
    return {**{k: counts[k] for k in names}, **FK.launches}


#: msm_naive of msm_main's small checks, by (curve, lg_small, the first
#: base point): the modes of one curve share them
NAIVE = {}


def msm_main(curve, lg, dev, full, base=None, exact=None, lg_small=LG_SMALL,
             mode="auto"):
    """Phases 7/8/15/18/26/27: the MSM of 2^lg in `mode` through the
    entry points, launch counts around it, and its checks: `exact(words)`
    is the exact result (default: tiled_oracle over the drawn points), the
    small checks run at 2^lg_small (the tree's also with all-equal
    scalars).  Returns (ctx, words on the device, launches, the exact
    result, the base points)."""
    import torch
    from sppark_tpu_torch.ec import get_curve_ops
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.msm import MSMContext, MSMSlabStages, MSMTreeStages
    from sppark_tpu_torch.msm import MSMRoundStages, pippenger, slab
    from sppark_tpu_torch.oracle.ec import get_oracle
    from sppark_tpu_torch.oracle.msm import msm_naive
    from sppark_tpu_torch.params import get_curve

    cp = get_curve(curve)
    n = 1 << lg
    t0 = time.perf_counter()
    base, pts, words, wd = msm_input(curve, lg, dev, base)
    print(f"{curve} 2^{lg}: input made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    ctx = MSMContext(curve, n, mode=mode)
    ctx.set_points(pts)
    tree = mode == "tree"
    rounds = mode in ("xyzz", "affine")
    if rounds:
        st = ctx.stages
        print(f"{curve} 2^{lg} mode {mode}: wbits {ctx.wbits}, nwins "
              f"{ctx.nwins}, {st.nwins * st.nbuckets} bucket lanes, the "
              f"top window spread over {st.k_spread} replicas of "
              f"{st.top_span} buckets, rounds {st.schedule(wd)[-1]}",
              flush=True)
    elif tree:
        m0, lmax, wg = ctx.stages.plan(ctx.stages.schedule(wd)[-1])
        print(f"{curve} 2^{lg} tree: wbits {ctx.wbits}, nwins {ctx.nwins}, "
              f"m0 {m0} slots per window, lmax {lmax} levels, {wg} "
              f"window(s) per group, {-(-ctx.nwins // wg)} group(s), level "
              f"0 {m0 * wg * 8 * ctx.ops.F.words / 2**30:.3f} GiB per "
              f"group", flush=True)
    else:
        cap, n_rows, wg = ctx.stages.plan(n)
        print(f"{curve} 2^{lg}: wbits {ctx.wbits}, nwins {ctx.nwins}, "
              f"slab cap {cap} x {n_rows} rows per window, {wg} window(s) "
              f"per group, {ctx.nwins // wg} group(s)", flush=True)
    torch.cuda.synchronize()
    reset_all()
    got = ctx.invoke(wd)
    torch.cuda.synchronize()
    launches = read_all(curve, mode)
    print(f"main path MSM {curve} 2^{lg} ({mode}) launches: {launches}",
          flush=True)
    check(all(v > 0 for v in launches.values()),
          f"MSM {curve} 2^{lg} ({mode}) went through "
          + ("pair prep, pair finish" if tree or mode == "affine"
             else "madd")
          + ", add, dbl and the Montgomery multiply")
    t0 = time.perf_counter()
    want = exact(words) if exact else tiled_oracle(curve, base, words)
    check(got == want, f"MSM {curve} 2^{lg} ({mode}) == exact oracle over "
                       f"all 2^{lg} terms ({time.perf_counter() - t0:.1f} "
                       f"s)")
    if full:
        ctx_c = MSMContext(curve, n, chunk=n >> 2, mode=mode)
        ctx_c.set_points(pts)
        check(ctx_c.invoke(wd) == want,
              f"MSM {curve} 2^{lg} ({mode}) chunked by 2^{lg - 2} == the "
              f"same point")
        del ctx_c
    # small: msm_naive with planted scalars and points, Montgomery scalars
    o = get_oracle(cp)
    r = cp.scalar.modulus
    m = 1 << lg_small
    spts = list(base[:m])
    spts[3] = o.infinity_affine()
    spts[5] = spts[4]                       # doubles in its bucket
    spts[7] = o.affine_neg(spts[6])         # cancels in its bucket
    rng = random.Random(3)
    sc = [rng.randrange(r) for _ in range(m)]
    sc[:9] = [0, r - 1, 7, 11, 2, 2, 3, 3, r // 2 + 1]
    key = (curve, lg_small, base[0].x, base[0].y)
    if key not in NAIVE:
        NAIVE[key] = msm_naive(cp, spts, sc)
    want_s = NAIVE[key]
    ctx_s = MSMContext(curve, m, mode=mode)
    check(ctx_s.invoke(sc, points=spts) == want_s,
          f"MSM {curve} 2^{lg_small} ({mode}) == msm_naive (0, r-1, "
          f"r // 2 + 1, doubling and cancelling terms)")
    mont = scalar_words([cp.scalar.to_mont(s) for s in sc], ctx_s.n_words,
                        dev)
    check(ctx_s.invoke(mont, points=spts, mont=True) == want_s,
          f"MSM {curve} 2^{lg_small} ({mode}) with Montgomery-form scalars")
    if tree:
        k = sc[-1]
        check(ctx_s.invoke([k] * m, points=spts) == msm_naive(cp, spts,
                                                              [k] * m),
              f"MSM {curve} 2^{lg_small} ({mode}) with all-equal scalars "
              f"== msm_naive (one bucket per window holds every point)")
    if full:
        # the round modes' plain path on the first 2^ROUND_PLAIN_LG points
        # at 8-bit windows: a few rounds (each affine round inverts on the
        # plain path), a short integrate
        wbits = ROUND_PLAIN_WBITS if rounds else PLAIN_WBITS
        m_p = 1 << ROUND_PLAIN_LG if rounds else m
        want_p = msm_naive(cp, spts[:m_p], sc[:m_p]) if rounds else want_s
        nwins = (cp.scalar.bits + wbits - 1) // wbits
        stages = (pippenger._STAGES[mode] if rounds else
                  MSMTreeStages if tree else MSMSlabStages)
        st = stages(curve, wbits, nwins, ctx_s.n_words, kern=EK.PLAIN)
        F = get_curve_ops(curve, FK.PLAIN).F
        rows = slab.point_rows(F, *get_curve_ops(curve).affine_from_ints(
            spts[:m_p], dev))
        t0 = time.perf_counter()
        wx, wy = st(scalar_words(sc[:m_p], ctx_s.n_words, dev), rows)
        plain = pippenger.collect(cp, wbits, nwins, wx, wy)
        check(plain == want_p, f"MSM {curve} 2^{m_p.bit_length() - 1} "
                               f"({mode}) on the plain path on the card, "
                               f"{wbits}-bit windows, == msm_naive "
                               f"({time.perf_counter() - t0:.1f} s)")
    return ctx, wd, launches, want, base


def wall_ms(fn, reps):
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def host_us_per_call(fn, reps=2000):
    """Host microseconds per call over `reps` back-to-back calls, after a
    warm-up: the time to issue, where the device keeps up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def kernel_ms(fn, reps):
    """Device time per call over `reps` back-to-back calls between two CUDA
    events, after one warm-up call: launch overhead hides behind the
    device work where a call takes longer to run than to issue."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def prod_ops(n32):
    """32-bit integer operations of one Montgomery product: 2 n32^2
    32x32->64 products, each counted as 2 IMADs."""
    return 4 * n32 * n32


def sqr_ops(n32):
    """32-bit integer operations of one Montgomery squaring (mont.cuh:
    the n32 (n32 - 1) / 2 off-diagonal products once, the n32 diagonal
    ones, then the n32^2 of the reduction), 2 IMADs each."""
    return 3 * n32 * n32 + n32


MSM_RANGES = ("msm.schedule", "msm.gather", "msm.madd_rounds", "msm.fold",
              "msm.tree_levels", "msm.extract", "msm.affine_rounds",
              "msm.integrate", "msm.to_affine")
#: the point kernels by their template's op number (csrc/ec_kernel.cuh)
EC_OPS = ("xyzz_madd", "xyzz_add", "xyzz_dbl", "pair_prep", "pair_finish")
#: the point kernels' elements (csrc/mont.cuh, csrc/mont_cc.cuh), longest
#: name first
EC_ELEMS = "Fp2PairCC|Fp2Pair|Fp2CC|FpCC|Fp2|Fp"


def point_kernel(mangled):
    """A point kernel's name from its mangled name, as kernel_group reads
    a profile's: "ec_kernel<FpCC<12>,pair_finish,table>" (",table": the
    build that reads a tree's first level through the index); None for
    another kernel."""
    m = re.search(r"ec_kernelIN4mont\d+(" + EC_ELEMS + r")ILi(\d+)EEELi"
                  r"(\d)ELb([01])E", mangled)
    if not m:
        return None
    elem, n, op, table = m.groups()
    return (f"ec_kernel<{elem}<{n}>,{EC_OPS[int(op)]}"
            + (",table>" if table == "1" else ">"))


def kernel_group(name):
    """A device event's name, the point and field kernels by their op."""
    m = re.search(r"ec_kernel<mont::(" + EC_ELEMS + r")<\d+>, ?(\d)[,>]",
                  name)
    if m:
        return ("ec_" if m.group(1) in ("Fp", "FpCC") else "ec_fp2_") + \
            EC_OPS[int(m.group(2))]
    for kernel in ("ew_kernel", "pow_kernel", "inv_up", "inv_down"):
        if f"{kernel}<" in name:
            return "bigmont_" + kernel.replace("_kernel", "")
    return name[:60]


def profile_breakdown(prof):
    """From one profiled invoke: (device busy ms, {range: (device ms, host
    ms)} over the stages' record_function ranges, {kernel: (device ms,
    launches)}, {range: the kernels launched in it}).  A device event
    belongs to the range whose host interval
    holds the runtime call that launched it (matched by CUPTI correlation
    id): the kernels launched through ctypes carry no link to the torch op
    around them.  The device-side copies of the ranges are not work."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    spans, launched_at, device = [], {}, []
    for e in events:
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append(e)
        elif e.name() in MSM_RANGES:
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                          e.name()))
        elif e.name().startswith("cu"):        # CUDA runtime / driver call
            launched_at[e.correlation_id()] = e.start_ns()
    phases = {k: [0.0, 0.0] for k in MSM_RANGES}
    launched = {k: set() for k in MSM_RANGES}
    for lo, hi, name in spans:
        phases[name][1] += (hi - lo) / 1e6
    spans.sort()
    starts = [lo for lo, _, _ in spans]
    by_kernel = {}
    busy = 0.0
    for e in device:
        ms = e.duration_ns() / 1e6
        busy += ms
        k = kernel_group(e.name())
        t, c = by_kernel.get(k, (0.0, 0))
        by_kernel[k] = (t + ms, c + 1)
        at = launched_at.get(e.correlation_id())
        # the ranges do not nest: the last one to start before `at`
        j = bisect.bisect_right(starts, at) - 1 if at is not None else -1
        if j >= 0 and at < spans[j][1]:
            phases[spans[j][2]][0] += ms
            launched[spans[j][2]].add(k)
    return busy, {k: tuple(v) for k, v in phases.items()}, by_kernel, \
        launched


def point_kernel_cases(curve, ctx, wd, M, S, A):
    """The three point kernels of `curve` at its main path's shapes, on the
    main path's data: madd on group 0's accumulators after two rounds and
    round 2's points, read from the gather table through the slot index
    (its bytes: the accumulators, the point row and the index word a
    lane), add on those accumulators and their right neighbours, dbl on
    the window sums.  M, S, A: the 32-bit operations of one product,
    squaring and addition of the coordinate field; only lanes that take
    the fast leg are counted.  Returns (cases for time_kernels: name,
    lanes, kernel, plain version, bytes, operations; the window sums)."""
    import torch
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.msm import slab
    from sppark_tpu_torch.params import get_curve

    cp = get_curve(curve)
    st = ctx.stages
    cap, _, wg = st.plan(wd.shape[1])
    sv, row_src, row_len = st.schedule(wd)[:3]
    win = st.window_sums(wd, ctx.rows)
    g = slice(0, wg)
    idx = slab.slot_index(sv[g], row_src[g], row_len[g], cap)
    acc = slab.madd_rounds(curve, ctx.rows, idx, 2)
    W = acc[0].shape[0]
    table = (ctx.rows[:, :W].T, ctx.rows[:, W:].T)
    i2 = idx[2].clone()
    del idx
    a2 = tuple(c.index_select(1, i2) for c in table)
    partner = tuple(torch.roll(c, -1, dims=-1) for c in acc)
    lanes = acc[0].shape[1]
    live = lambda c: (c != 0).any(dim=0)                 # noqa: E731
    madd_full = int((live(acc[2]) & (live(a2[0]) | live(a2[1]))).sum())
    add_full = int((live(acc[2]) & live(partner[2])).sum())
    dbl_full = int((live(win[1]) & live(win[2])).sum())
    # dbl-2008-s-1 needs a4 ZZ^2 only where a4 != 0
    dbl_a4 = M + S + A if cp.a4 else 0
    pre = "ec_xyzz_" if cp.fp2 is None else "ec_fp2_xyzz_"
    cases = [
        (pre + "madd", lanes, lambda: EK.xyzz_madd(curve, acc, table, i2),
         lambda: EK.xyzz_madd_plain(curve, acc, table, i2),
         (10 * W + 1) * 4 * lanes, madd_full * (8 * M + 2 * S + 7 * A)),
        (pre + "add", lanes, lambda: EK.xyzz_add(curve, acc, partner),
         lambda: EK.xyzz_add_plain(curve, acc, partner),
         12 * 4 * W * lanes, add_full * (12 * M + 2 * S + 7 * A)),
        (pre + "dbl", st.nwins, lambda: EK.xyzz_dbl(curve, win),
         lambda: EK.xyzz_dbl_plain(curve, win),
         8 * 4 * W * st.nwins, dbl_full * (6 * M + 3 * S + 7 * A + dbl_a4)),
    ]
    return cases, win


def time_kernels(cases, same, rate, card):
    """Each case's kernel against its plain version, then both timed with
    CUDA events and the kernel set beside its bound.  Returns {name: (ms,
    plain ms, bound ms, bound by)}."""
    timing = {}
    for name, nl, kfn, pfn, nbytes, ops in cases:
        key = name.split()[0]
        same(key, kfn(), pfn(), f"{name} at the main-path shape ({nl} "
                                f"lanes)")
        ms = kernel_ms(kfn, reps=20)
        pms = kernel_ms(pfn, reps=1)
        b, by = bound(nbytes, ops, rate)
        timing[name] = (ms, pms, b, by)
        print(f"time {name} at {nl} lanes: {ms:.4f} ms (plain {pms:.4f} ms, "
              f"bound {b:.4f} ms by {by}, {b / ms:.3f} of bound)  [{card}]",
              flush=True)
    return timing


def msm_times(ctx, wd, curve, lg, card):
    """The MSM's time (median of 3 invokes, wall clock), then one invoke
    under torch.profiler (CUPTI): peak device memory, the device's busy
    share, the stages' phases and the device time by kernel, printed.
    Returns (ms, peak GiB, resident GiB, busy ms, profiled wall ms,
    phases, by kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sppark_tpu_torch.msm import MSMRoundStages, MSMTreeStages

    n = 1 << lg
    t_msm = wall_ms(lambda: ctx.invoke(wd), reps=3)
    print(f"time MSM {curve} 2^{lg}: {t_msm:.4f} ms (median of 3, wall "
          f"clock), {n / (t_msm * 1e-3):.4e} points/s  [{card}]", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ctx.invoke(wd)
        torch.cuda.synchronize()
        t_prof = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy, phases, by_kernel, launched = profile_breakdown(prof)
    print(f"MSM {curve} 2^{lg}: peak device memory {peak:.3f} GiB, of "
          f"which {resident:.3f} GiB was allocated before the invoke (the "
          f"gather table, the scalars, earlier phases' caches); "
          + (f"device busy {busy:.4f} ms of {t_prof:.4f} ms wall under the "
             f"profiler, idle share {1 - busy / t_prof:.4f}" if busy > 0
             else "device busy time not measured (no device events)")
          + f"  [{card}]", flush=True)
    stats = ctx.stages.schedule(wd)[-1]
    if isinstance(ctx.stages, MSMRoundStages):
        shape = (f"rounds {stats} (mode {ctx.stages.mode}, the top window "
                 f"in {ctx.stages.k_spread} replicas)")
    elif isinstance(ctx.stages, MSMTreeStages):
        m0, lmax, wg = ctx.stages.plan(stats)
        shape = f"m0 {m0}, lmax {lmax}, {wg} window(s) per group"
    else:
        rounds, max_rows = (int(v) for v in stats.tolist())
        shape = (f"rounds {rounds}, fold levels "
                 f"{max(0, (max_rows - 1).bit_length())}")
    print(f"MSM {curve} 2^{lg} phases under the profiler (device ms of the "
          f"kernels launched in each / host ms in it): " + ", ".join(
              f"{k} {d:.4f} / {h:.4f}" for k, (d, h) in phases.items())
          + f"; the ranges hold {sum(d for d, _ in phases.values()):.4f} "
          f"of the {busy:.4f} busy ms; {shape}  [{card}]", flush=True)
    print(f"MSM {curve} 2^{lg} device ms by kernel (launches): "
          + ", ".join(f"{k} {ms:.4f} ({c})" for k, (ms, c) in sorted(
              by_kernel.items(), key=lambda kv: -kv[1][0])[:12])
          + f"  [{card}]", flush=True)
    # the slab's, the tree's and the round modes' gather build an index:
    # no index_select over the point table, whose rows the madd and the
    # pair kernels read through the index
    gather = sorted(launched["msm.gather"])
    print(f"MSM {curve} 2^{lg} kernels in msm.gather: {gather}", flush=True)
    if busy > 0:
        check(bool(gather) and not any("indexSelect" in k for k in gather),
              f"MSM {curve} 2^{lg}: msm.gather launched no index_select")
    return t_msm, peak, resident, busy, t_prof, phases, by_kernel


def msm_phases(dev, card, rate, logs):
    """Phases 6-9; `logs`: {source: nvcc log} of the sources built in this
    run.  Returns (the kernels' entries of the summary line, the
    main path's base points and exact result, for the tree in phase 18,
    the main path's launches, bigmont_pow's largest error in phase 6)."""
    import torch
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.ff.bigmont import get_field_ops
    from sppark_tpu_torch.params import get_curve

    errs = {k: 0 for k in ("bigmont_ew", "bigmont_pow", "ec_xyzz_madd",
                           "ec_xyzz_add", "ec_xyzz_dbl")}

    def same(name, got, want, what):
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        e = word_err(got, want)
        errs[name] = max(errs[name], e)
        check(e == 0, f"{name} == plain: {what}")

    # -- 6. kernels vs plain ----------------------------------------------------
    rng = np.random.default_rng(7)
    for curve in EC_CURVES:
        fp = get_curve(curve).field
        F = get_field_ops(fp)
        for n in (1, 1000, 1 << 16):
            x, y = rand_canon(F, n, rng, dev), rand_canon(F, n, rng, dev)
            y = y.flip(1).contiguous()      # edge values meet edge values
            same("bigmont_ew", FK.mont_mul(x, y, fp),
                 FK.mont_mul_plain(x, y, fp), f"{curve} mul {n} lanes")
            same("bigmont_ew", FK.mont_sqr(x, fp), FK.mont_sqr_plain(x, fp),
                 f"{curve} sqr {n} lanes")
        # the fixed-exponent chain on prefixes of one input, edge values
        # planted: each exponent's plain chain runs once, at the widest
        x = rand_canon(F, POW_LANES[-1], rng, dev)
        p = F.p
        for what, e in (("0", 0), ("1", 1), ("2", 2), ("p - 2", p - 2),
                        ("(p + 1) / 4", (p + 1) // 4)):
            want = FK.mont_pow_plain(x, e, fp)
            for n in POW_LANES:
                same("bigmont_pow", FK.mont_pow(x[:, :n], e, fp),
                     want[:, :n], f"{curve} x^e, e = {what}, {n} lanes")
        p, a, q = ec_cases(curve, 1000, dev, seed=11)
        same("ec_xyzz_madd", EK.xyzz_madd(curve, p, a),
             EK.xyzz_madd_plain(curve, p, a), f"{curve} madd, planted lanes")
        same("ec_xyzz_add", EK.xyzz_add(curve, p, q),
             EK.xyzz_add_plain(curve, p, q), f"{curve} add, planted lanes")
        same("ec_xyzz_dbl", EK.xyzz_dbl(curve, p),
             EK.xyzz_dbl_plain(curve, p), f"{curve} dbl, planted lanes")
        # coordinates p - 1 and p - 2, for the carry chains
        pe, ae, qe = edge_lanes(curve, p, a, q)
        same("ec_xyzz_madd", EK.xyzz_madd(curve, pe, ae),
             EK.xyzz_madd_plain(curve, pe, ae),
             f"{curve} madd, coordinates p - 1 and p - 2")
        same("ec_xyzz_add", EK.xyzz_add(curve, pe, qe),
             EK.xyzz_add_plain(curve, pe, qe),
             f"{curve} add, coordinates p - 1 and p - 2")
        # through a table and its slot index: the slab's gather fused
        table, idx = table_case(curve, a, 1000, seed=12)
        same("ec_xyzz_madd", EK.xyzz_madd(curve, p, table, idx),
             EK.xyzz_madd_plain(curve, p, table, idx),
             f"{curve} madd through a table and a slot index (negated "
             f"rows, the zero row, repeated rows)")
        # no doubling lane anywhere (the gated leg never runs)
        k = 32
        same("ec_xyzz_madd",
             EK.xyzz_madd(curve, tuple(c[:, :k] for c in p),
                          tuple(c[:, :k] for c in a)),
             EK.xyzz_madd_plain(curve, tuple(c[:, :k] for c in p),
                                tuple(c[:, :k] for c in a)),
             f"{curve} madd, one warp with no special lane")

    # -- 7. main path: BLS12-381 G1 2^24 -----------------------------------------
    ctx, wd, launches, want, base = msm_main(MSM_CURVE, MSM_LG, dev,
                                             full=True)
    # -- 8. Pasta G1 2^20 ------------------------------------------------------
    pctx, pwd, plaunches, _, _ = msm_main(PASTA_CURVE, PASTA_LG, dev,
                                          full=False)

    # -- 9. times ------------------------------------------------------------------
    t_msm, peak, resident, busy, t_prof, phases, by_kernel = msm_times(
        ctx, wd, MSM_CURVE, MSM_LG, card)
    t_pasta = wall_ms(lambda: pctx.invoke(pwd), reps=3)
    print(f"time MSM {PASTA_CURVE} 2^{PASTA_LG}: {t_pasta:.4f} ms (median "
          f"of 3, wall clock), {(1 << PASTA_LG) / (t_pasta * 1e-3):.4e} "
          f"points/s  [{card}]", flush=True)
    del pctx, pwd

    # each kernel alone at its main-path shapes, on the main path's data;
    # mul on the batch inversion's lanes and at 2^20 lanes
    cp = get_curve(MSM_CURVE)
    fp = cp.field
    N = fp.n_ref_limbs
    cases, win = point_kernel_cases(MSM_CURVE, ctx, wd, prod_ops(N),
                                    sqr_ops(N), 2 * N)
    F = get_field_ops(fp)
    inv_lanes = torch.cat([win[2], win[3]], dim=-1)
    big = rand_canon(F, 1 << 20, rng, dev)
    # the dbl at a wide shape, every lane on the fast leg (random
    # coordinates: ZZ and Y are not 0), against its operations bound
    dbl_ops = 6 * prod_ops(N) + 3 * sqr_ops(N) + 7 * 2 * N
    wide = tuple(rand_canon(F, DBL_WIDE_LANES, rng, dev) for _ in range(4))
    cases += [
        (f"ec_xyzz_dbl 2^{DBL_WIDE_LANES.bit_length() - 1}", DBL_WIDE_LANES,
         lambda: EK.xyzz_dbl(MSM_CURVE, wide),
         lambda: EK.xyzz_dbl_plain(MSM_CURVE, wide),
         8 * 4 * N * DBL_WIDE_LANES, DBL_WIDE_LANES * dbl_ops)]
    cases += [
        ("bigmont_ew", inv_lanes.shape[1],
         lambda: FK.mont_mul(inv_lanes, inv_lanes, fp),
         lambda: FK.mont_mul_plain(inv_lanes, inv_lanes, fp),
         3 * 4 * N * inv_lanes.shape[1], inv_lanes.shape[1] * prod_ops(N)),
        ("bigmont_ew 2^20", 1 << 20, lambda: FK.mont_mul(big, big, fp),
         lambda: FK.mont_mul_plain(big, big, fp),
         3 * 4 * N << 20, prod_ops(N) << 20),
    ]
    timing = time_kernels(cases, same, rate, card)
    del wide
    # one lane's doubling is one thread's chain: at the integrate's few
    # lanes no more than one instruction a cycle at the SM clock
    clock = rate / (torch.cuda.get_device_properties(0).multi_processor_count
                    * 64)
    dbl_floor = dbl_ops / clock * 1e3
    regs = ptxas_summary(logs.get("ec_xyzz", ""), point_kernel)
    print(f"ec_xyzz_dbl over {fp.name}: one lane's 6M + 3S + 7A, {dbl_ops} "
          f"operations; single-thread floor {dbl_floor:.7f} ms at one "
          f"instruction per cycle and {clock / 1e9:.3f} GHz; ec_kernel<FpCC<"
          f"{N}>,xyzz_dbl>: " + regs.get(f"ec_kernel<FpCC<{N}>,xyzz_dbl>",
                                         "registers: not rebuilt in this run")
          + f"  [{card}]", flush=True)
    print(json.dumps({"msm_ms": {f"{MSM_CURVE} 2^{MSM_LG}": t_msm,
                                 f"{PASTA_CURVE} 2^{PASTA_LG}": t_pasta},
                      "msm_phases_device_host_ms": phases,
                      "msm_kernels_ms_launches": by_kernel,
                      "msm_peak_gib": peak, "msm_resident_gib": resident,
                      "msm_device_busy_ms": busy,
                      "msm_profiled_wall_ms": t_prof,
                      "msm_launches": launches,
                      "pasta_launches": plaunches,
                      "dbl_single_thread_floor_ms": dbl_floor,
                      "card": card}))

    src = "sppark_tpu_torch/csrc/"
    replaces = {"bigmont_ew": ("bigmont.cu", "sppark_tpu/ff/bigmont.py:383"),
                "ec_xyzz_madd": ("ec_xyzz.cu",
                                 "sppark_tpu/ec/pallas_ops.py:387"),
                "ec_xyzz_add": ("ec_xyzz.cu",
                                "sppark_tpu/ec/pallas_ops.py:224"),
                "ec_xyzz_dbl": ("ec_xyzz.cu",
                                "sppark_tpu/ec/pallas_ops.py:336")}
    entries = []
    for name, (f, rep) in replaces.items():
        ms, pms, b, by = timing[name]
        entries.append({"name": name, "route": "cuda", "source": src + f,
                        "replaces": rep, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": ms, "plain_ms": pms,
                        "bound_ms": b, "bound_by": by, "library_ms": None})
    return entries, (base, want), launches, errs["bigmont_pow"]


# -- wide-field NTT phases (10-13) --------------------------------------------------

WIDE_FIELD, WIDE_LG = "bls12_381_fr", 26     # bench.py:bench_ntt_wide
WIDE_LDE_LG, WIDE_BLOWUP = 24, 2
#: n32 = 2 (one carry chain) and 8 (the split chains: p < 2^255)
WIDE_KERNEL_FIELDS = ("test_bm64_fr", "bn254_fr", "bls12_381_fr",
                      "bls12_377_fr", "pallas")
WIDE_ROW_LGS = (1, 6, 11)        # phase 10's row lengths,
WIDE_COL_LGS = (1, 8, 11)        # column lengths
WIDE_COL_COUNTS = (8, 1024)      # and column counts
MAIN_SLICE_COLS = 1 << 11  # columns of the main path's checked slices
LG_PLAIN_WIDE = 20      # the whole facade on the plain kernels, on the card
WIDE_ORDER_LGS = (10, 16)  # the 16 configurations: one pass, four-step
LG_LDE_PLAIN = 16       # the LDE against the plain path
PLAIN_SLICE = 1 << 20   # elements of the main-path slice the plain versions
                        # are timed on


def wide_words(field, lg, rng, dev):
    """(n32, 2^lg) random canonical Montgomery words drawn as the wire
    words of bench.py:bench_ntt_wide (top word reduced below p's)."""
    from sppark_tpu_torch.ff.bigmont import get_field_ops
    from sppark_tpu_torch.params import get_field
    fp = get_field(field)
    n32 = fp.n_ref_limbs
    w = rng.integers(0, 1 << 32, size=(1 << lg, n32),
                     dtype=np.uint64).astype(np.uint32)
    w[:, -1] %= np.uint32(fp.modulus >> (32 * (n32 - 1)))
    return get_field_ops(field).from_wire_np(w, dev)


def transform_ops(lg, count, prod, add_sub):
    """Integer operations of `count` radix-2 transforms of length
    n = 2^lg: `add_sub` (an add and a sub) for each of the (n/2) lg
    butterflies and `prod` (a product) for each whose twiddle is not
    w^0 = 1, which is all but n - 1 of them."""
    n = 1 << lg
    return count * ((n // 2) * lg * add_sub
                    + ((n // 2) * lg - (n - 1)) * prod)


def eval_at(F, x, z, dev):
    """sum_i x_i z^i (canonical int) on the card, independent of the NTT
    code: the powers of z by doubling with field products, one product per
    term, then a tree of field adds."""
    import torch
    p = F.p
    pw = F.ones((1,), dev).contiguous()
    step = z
    while pw.shape[-1] < x.shape[-1]:
        pw = torch.cat([pw, F.mul(pw, F.const(step, (1,), dev))], -1)
        step = step * step % p
    t = F.mul(x, pw)
    del pw
    while t.shape[-1] > 1:
        h = t.shape[-1] // 2
        t = F.add(t[..., :h], t[..., h:])
    return F.to_int_list(t)[0]


def wide_phases(dev, card, rate):
    """Phases 10-13.  Returns (the kernels' entries of the summary line,
    the phases' numbers)."""
    import torch
    from sppark_tpu_torch import ntt
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.ff.bigmont import get_field_ops
    from sppark_tpu_torch.ntt import fused, kernels as K
    from sppark_tpu_torch.ntt.parameters import get_parameters
    from sppark_tpu_torch.oracle import ntt as oracle
    from sppark_tpu_torch.params import get_field

    errs = dict.fromkeys(K.wide_launches, 0)

    def agree(name, pairs, what):
        """Every (kernel, plain) pair equal, word for word; one line."""
        torch.cuda.synchronize()
        for k, (got, want) in enumerate(pairs):
            e = word_err((got,), (want,))
            errs[name] = max(errs[name], e)
            if e:
                raise RuntimeError(f"check failed: {name} == plain: {what} "
                                   f"(case {k}, max word error {e})")
        print(f"ok  {name} == plain: {what} ({len(pairs)} cases)",
              flush=True)

    rng = np.random.default_rng(11)

    def rand(field, *shape):
        """rand_canon's words (0, 1, p - 1, R mod p first), with 0, 1,
        p - 1 and p - 2 in the last four elements too."""
        from sppark_tpu_torch.ff.kernels import int_words
        F = get_field_ops(field)
        n = int(np.prod(shape))
        w = rand_canon(F, n, rng, dev)
        for k, v in enumerate((0, 1, F.p - 1, F.p - 2)[:n]):
            w[:, n - 1 - k] = torch.tensor(
                int_words(v, F.n32), dtype=torch.int64).to(w)
        return w.reshape((-1,) + shape)

    # -- 10. kernels vs plain: every option, five fields, edge words ----------
    for field in WIDE_KERNEL_FIELDS:
        pm = get_parameters(field, dev)
        for lg in WIDE_ROW_LGS:
            tw = pm.power_table(lg, False)
            pairs = []
            for shape in ((1, 1 << lg), (16, 1 << lg), (3, 5, 1 << lg)):
                x, mul = rand(field, *shape), rand(field, *shape)
                for in_rev in (False, True):
                    for out_rev in (False, True):
                        for out_t in (False, True):
                            for m in ((None,) if out_rev else (None, mul)):
                                a = (x, tw, lg, m, in_rev, out_rev, out_t)
                                pairs.append((K.wide_rows(field, *a),
                                              K.wide_rows_plain(field, *a)))
            agree("bigmont_ntt_rows", pairs, f"{field} lg {lg}, every "
                  f"option, outer batch")
        for lg1 in WIDE_COL_LGS:
            tw = pm.power_table(lg1, True)
            pairs, mids = [], []
            for m_cols in WIDE_COL_COUNTS:
                for batch in ((), (3,)):
                    x = rand(field, *batch, 1 << lg1, m_cols)
                    pairs.append((K.wide_cols(field, x, tw, lg1),
                                  K.wide_cols_plain(field, x, tw, lg1)))
                    # A one block wide, and A many blocks wide
                    for block in (m_cols, 4):
                        a = rand(field, 1 << lg1, m_cols // block)
                        b = rand(field, 1 << lg1, block)
                        mids.append((K.wide_mid(field, x, a, b),
                                     K.wide_mid_plain(field, x, a, b)))
            agree("bigmont_ntt_cols", pairs, f"{field} lg1 {lg1}, batch")
            agree("bigmont_ntt_mid", mids, f"{field} n1 2^{lg1}, A of 1 "
                  f"and of M/4 blocks, batch")

    # -- 11. main path: BLS12-381 Fr forward NTT 2^26 ---------------------------
    F = get_field_ops(WIDE_FIELD)
    fp = get_field(WIDE_FIELD)
    n32 = fp.n_ref_limbs
    n = 1 << WIDE_LG
    main_rng = np.random.default_rng(5)
    x = wide_words(WIDE_FIELD, WIDE_LG, main_rng, dev)
    fwd = fused.fused_tables(WIDE_FIELD, WIDE_LG, False, dev)
    torch.cuda.synchronize()
    K.reset_launches()
    FK.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    y = ntt.base_dev(WIDE_FIELD, x, WIDE_LG)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(K.wide_launches)
    print(f"main path NTT {WIDE_FIELD} 2^{WIDE_LG} launches: {launches}, "
          f"bigmont_ew {FK.launches['bigmont_ew']} (tables cached); peak "
          f"device memory {peak:.3f} GiB, of which {resident:.3f} GiB was "
          f"allocated before the call (the 2 GiB input, tables, caches): "
          f"the call adds {peak - resident:.3f} GiB  [{card}]", flush=True)
    check(all(v > 0 for v in launches.values()),
          f"NTT {WIDE_FIELD} 2^{WIDE_LG} went through the three wide "
          f"kernels")
    back = ntt.base_dev(WIDE_FIELD, y, WIDE_LG,
                        direction=ntt.Direction.inverse)
    check(torch.equal(back, x), f"intt(ntt(x)) == x at 2^{WIDE_LG}")
    del back
    w = fp.root_of_unity(WIDE_LG)
    for k in (int(v) for v in main_rng.integers(0, n, size=3)):
        got = F.to_int_list(y[:, k:k + 1])[0]
        check(got == eval_at(F, x, pow(w, k, fp.modulus), dev),
              f"NTT 2^{WIDE_LG} output {k} == sum_i x_i w^(ik) on the card")

    # the main path's kernels at its own shapes, on its own arrays: each
    # kernel on the whole array, its plain version on the first and last
    # column blocks (or row batches), which are independent of the rest
    lg1 = fused.split_lg1(WIDE_LG, WIDE_FIELD)
    lg2 = WIDE_LG - lg1
    lg21 = fused.split_lg1(lg2, WIDE_FIELD)
    lg22 = lg2 - lg21
    tw1, (A1, B1), tw21, (A2, B2), tw22 = fwd
    a = x.reshape(n32, 1 << lg1, 1 << lg2)
    c1 = K.wide_cols(WIDE_FIELD, a, tw1, lg1)
    m1 = K.wide_mid(WIDE_FIELD, c1, A1, B1)
    w11, blk = MAIN_SLICE_COLS, B1.shape[-1]
    ends = (slice(0, w11), slice((1 << lg2) - w11, 1 << lg2))
    agree("bigmont_ntt_cols", [
        (c1[..., s], K.wide_cols_plain(WIDE_FIELD, a[..., s].contiguous(),
                                       tw1, lg1)) for s in ends],
        f"main path 2^{WIDE_LG}, {tuple(a.shape)} lg {lg1}, first and "
        f"last {w11} columns")
    agree("bigmont_ntt_mid", [
        (m1[..., s], K.wide_mid_plain(
            WIDE_FIELD, c1[..., s].contiguous(),
            A1[..., s.start // blk:s.stop // blk].contiguous(), B1))
        for s in ends],
        f"main path 2^{WIDE_LG}, {tuple(c1.shape)} block {blk}, first and "
        f"last {w11} columns")
    del c1
    c = m1.reshape(n32, 1 << lg1, 1 << lg21, 1 << lg22)
    c2 = K.wide_cols(WIDE_FIELD, c, tw21, lg21)
    m2 = K.wide_mid(WIDE_FIELD, c2, A2, B2)
    r = K.wide_rows(WIDE_FIELD, m2, tw22, lg22, out_t=True)
    ends = (slice(0, 2), slice((1 << lg1) - 2, 1 << lg1))
    agree("bigmont_ntt_cols", [
        (c2[:, s], K.wide_cols_plain(WIDE_FIELD, c[:, s].contiguous(), tw21,
                                     lg21)) for s in ends],
        f"main path inner {tuple(c.shape)} lg {lg21}, first and last 2 "
        f"batches")
    agree("bigmont_ntt_mid", [
        (m2[:, s], K.wide_mid_plain(WIDE_FIELD, c2[:, s].contiguous(), A2,
                                    B2)) for s in ends],
        f"main path inner {tuple(c2.shape)} block {B2.shape[-1]}, first and "
        f"last 2 batches")
    agree("bigmont_ntt_rows", [
        (r[:, s], K.wide_rows_plain(WIDE_FIELD, m2[:, s].contiguous(), tw22,
                                    lg22, out_t=True)) for s in ends],
        f"main path inner {tuple(m2.shape)} lg {lg22} out_t, first and "
        f"last 2 batches")
    check(torch.equal(r.reshape(n32, 1 << lg1, 1 << lg2).transpose(-1, -2)
                      .reshape(n32, n), y),
          f"the five main-path launches, composed, == NTT 2^{WIDE_LG}")
    del c, c2, m2, r

    # the facade on the plain kernels at 2^20; the host-array entry point
    x20 = wide_words(WIDE_FIELD, LG_PLAIN_WIDE, main_rng, dev)
    t0 = time.perf_counter()
    y20 = fused.facade(WIDE_FIELD, x20, LG_PLAIN_WIDE, kern=K.PLAIN)
    torch.cuda.synchronize()
    check(torch.equal(ntt.base_dev(WIDE_FIELD, x20, LG_PLAIN_WIDE), y20),
          f"NTT 2^{LG_PLAIN_WIDE} == the plain path on the card "
          f"({time.perf_counter() - t0:.1f} s)")
    wire = ntt.ntt(WIDE_FIELD, F.to_wire_np(x20), LG_PLAIN_WIDE)
    check(torch.equal(F.from_wire_np(wire, dev), y20),
          f"host-array ntt.ntt 2^{LG_PLAIN_WIDE} (wire {wire.shape} u32) == "
          f"the plain path")
    del x20, y20, wire
    for field in ("bls12_381_fr", "bn254_fr"):
        G, gp = get_field_ops(field), get_field(field)
        ints_rng = random.Random(12)
        for lg in (1, 10, 12):
            ints = [ints_rng.randrange(gp.modulus) for _ in range(1 << lg)]
            got = ntt.base_dev(field, G.from_int_list(ints, device=dev), lg)
            check(G.to_int_list(got) == oracle.ntt_natural(gp, ints),
                  f"{field} NTT 2^{lg} == big-int oracle")
            back = ntt.base_dev(field, got, lg,
                                direction=ntt.Direction.inverse)
            check(G.to_int_list(back) == ints, f"{field} intt round trip "
                                               f"2^{lg}")
    for lg in WIDE_ORDER_LGS:
        xs = wide_words(WIDE_FIELD, lg, main_rng, dev)
        for order in ntt.InputOutputOrder:
            for inverse in (False, True):
                for coset in (False, True):
                    got = ntt.base_dev(WIDE_FIELD, xs, lg, order,
                                       ntt.Direction(int(inverse)),
                                       ntt.Type(int(coset)))
                    want = fused.facade(WIDE_FIELD, xs, lg, order.value,
                                        inverse, coset, kern=K.PLAIN)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want),
                          f"{WIDE_FIELD} 2^{lg} {order.value} "
                          f"inverse={inverse} coset={coset} == plain path")

    # -- 12. LDE 2^24 x 4 ---------------------------------------------------------
    lg, lg_ext = WIDE_LDE_LG, WIDE_LDE_LG + WIDE_BLOWUP
    x24 = wide_words(WIDE_FIELD, lg, main_rng, dev)
    torch.cuda.synchronize()
    K.reset_launches()
    ext = ntt.lde_dev(WIDE_FIELD, x24, lg, WIDE_BLOWUP)
    torch.cuda.synchronize()
    lde_launches = dict(K.wide_launches)
    print(f"main path LDE {WIDE_FIELD} 2^{lg} x{1 << WIDE_BLOWUP} launches: "
          f"{lde_launches}", flush=True)
    check(all(v > 0 for v in lde_launches.values()),
          f"LDE 2^{lg} x{1 << WIDE_BLOWUP} went through the three wide "
          f"kernels")
    inv = ntt.base_dev(WIDE_FIELD, ext, lg_ext,
                       direction=ntt.Direction.inverse,
                       ntt_type=ntt.Type.coset)
    check(bool((inv[:, 1 << lg:] == 0).all()),
          f"LDE: coefficients above 2^{lg} are 0")
    check(torch.equal(ntt.base_dev(WIDE_FIELD, inv[:, :1 << lg].contiguous(),
                                   lg), x24),
          "LDE: inverse coset transform gives back x")
    del inv, ext
    xp = wide_words(WIDE_FIELD, LG_LDE_PLAIN, main_rng, dev)
    check(torch.equal(ntt.lde_dev(WIDE_FIELD, xp, LG_LDE_PLAIN, WIDE_BLOWUP),
                      fused.lde(WIDE_FIELD, xp, LG_LDE_PLAIN, WIDE_BLOWUP,
                                kern=K.PLAIN)),
          f"LDE 2^{LG_LDE_PLAIN} x{1 << WIDE_BLOWUP} == plain path on the "
          f"card")
    ints = [random.Random(13).randrange(fp.modulus) for _ in range(1 << 8)]
    got = ntt.lde_dev(WIDE_FIELD, F.from_int_list(ints, device=dev), 8, 1)
    check(F.to_int_list(got) == oracle.lde(fp, ints, 1),
          "LDE 2^8 x2 == big-int oracle")

    # -- 13. times -----------------------------------------------------------------
    t_ntt = median_ms(lambda: ntt.base_dev(WIDE_FIELD, x, WIDE_LG), reps=5)
    bfly = (n // 2) * WIDE_LG
    P, AS, M2 = prod_ops(n32), 4 * n32, 2 * prod_ops(n32)
    ntt_bound, ntt_by = bound(
        2 * 4 * n32 * n, transform_ops(WIDE_LG, 1, P, AS), rate)
    print(f"time NTT {WIDE_FIELD} 2^{WIDE_LG} forward: {t_ntt:.4f} ms "
          f"(median of 5, CUDA events), {bfly / (t_ntt * 1e-3):.4e} "
          f"butterflies/s, bound {ntt_bound:.4f} ms by {ntt_by} "
          f"(one radix-2 transform, no products by 1), "
          f"{ntt_bound / t_ntt:.3f} of bound  [{card}]", flush=True)
    t_lde = median_ms(lambda: ntt.lde_dev(WIDE_FIELD, x24, lg, WIDE_BLOWUP),
                      reps=5)
    bfly_lde = (1 << (lg - 1)) * lg + (1 << (lg_ext - 1)) * lg_ext
    print(f"time LDE {WIDE_FIELD} 2^{lg} x{1 << WIDE_BLOWUP}: {t_lde:.4f} ms "
          f"(median of 5), {bfly_lde / (t_lde * 1e-3):.4e} butterflies/s  "
          f"[{card}]", flush=True)
    shift = get_parameters(WIDE_FIELD, dev).coset_powers(lg_ext, False)
    coeffs = ntt.base_dev(WIDE_FIELD, x24, lg,
                          direction=ntt.Direction.inverse)
    pad = torch.zeros((n32, (1 << lg_ext) - (1 << lg)), dtype=torch.int32,
                      device=dev)
    parts = {
        f"inverse NTT 2^{lg}": median_ms(lambda: ntt.base_dev(
            WIDE_FIELD, x24, lg, direction=ntt.Direction.inverse), reps=5),
        "pad + coset shift (bigmont_ew)": median_ms(
            lambda: F.mul(torch.cat([coeffs, pad], -1), shift), reps=5),
        f"forward NTT 2^{lg_ext} (the main path's time)": t_ntt,
    }
    print("time LDE parts: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in parts.items()) + f"  [{card}]",
        flush=True)
    del coeffs, pad, x24

    # each kernel alone at the forward 2^26 shapes (cols and mid: the top
    # level's; rows: the inner level's transposed pass), the plain versions
    # on a 2^20-element slice of the same arrays
    c1 = K.wide_cols(WIDE_FIELD, a, tw1, lg1)
    m2 = m1.reshape(n32, 1 << lg1, 1 << lg21, 1 << lg22)
    cols_slice = a[..., :PLAIN_SLICE >> lg1].contiguous()
    mid_slice = c1[..., :PLAIN_SLICE >> lg1].contiguous()
    rows_slice = m2[:, :PLAIN_SLICE >> lg2].contiguous()
    a_slice = A1[..., :(PLAIN_SLICE >> lg1) // blk].contiguous()
    word = 4 * n32
    cases = [
        ("bigmont_ntt_cols", tuple(a.shape),
         lambda: K.wide_cols(WIDE_FIELD, a, tw1, lg1),
         lambda: K.wide_cols_plain(WIDE_FIELD, cols_slice, tw1, lg1),
         word * (2 * n + tw1.shape[-1]),
         transform_ops(lg1, n >> lg1, P, AS)),
        ("bigmont_ntt_mid", tuple(c1.shape),
         lambda: K.wide_mid(WIDE_FIELD, c1, A1, B1),
         lambda: K.wide_mid_plain(WIDE_FIELD, mid_slice, a_slice, B1),
         word * (2 * n + A1[0].numel() + B1[0].numel()), n * M2),
        ("bigmont_ntt_rows", tuple(m2.shape),
         lambda: K.wide_rows(WIDE_FIELD, m2, tw22, lg22, out_t=True),
         lambda: K.wide_rows_plain(WIDE_FIELD, rows_slice, tw22, lg22,
                                   out_t=True),
         word * (2 * n + tw22.shape[-1]),
         transform_ops(lg22, n >> lg22, P, AS)),
    ]
    timing = {}
    for name, shape, kfn, pfn, nbytes, ops in cases:
        ms = median_ms(kfn, reps=5)
        pms = median_ms(pfn, reps=1, warmup=0)
        b, by = bound(nbytes, ops, rate)
        timing[name] = (ms, pms, b, by)
        print(f"time {name} at {shape}: {ms:.4f} ms (median of 5; plain "
              f"{pms:.4f} ms on a {PLAIN_SLICE}-element slice), bound "
              f"{b:.4f} ms by {by}, {b / ms:.3f} of bound  [{card}]",
              flush=True)
    del a, c1, m1, m2, x, y

    numbers = {"wide_ntt_ms": t_ntt, "wide_ntt_bound_ms": ntt_bound,
               "wide_lde_ms": t_lde, "wide_lde_parts_ms": parts,
               "wide_ntt_peak_gib": peak, "wide_ntt_resident_gib": resident,
               "wide_ntt_launches": launches,
               "wide_lde_launches": lde_launches}
    replaces = {"bigmont_ntt_rows": "sppark_tpu/ntt/pallas_kernels.py:206",
                "bigmont_ntt_cols": "sppark_tpu/ntt/pallas_kernels.py:319",
                "bigmont_ntt_mid": "sppark_tpu/ntt/pallas_kernels.py:389"}
    entries = []
    for name, rep in replaces.items():
        ms, pms, b, by = timing[name]
        entries.append({"name": name, "route": "cuda",
                        "source": "sppark_tpu_torch/csrc/ntt_wide.cu",
                        "replaces": rep,
                        "launches": launches[name] + lde_launches[name],
                        "max_abs_err": errs[name], "ms": ms, "plain_ms": pms,
                        "bound_ms": b, "bound_by": by, "library_ms": None})
    return entries, numbers


# -- G2 MSM phases (14-16) ----------------------------------------------------------

G2_CURVE, G2_LG = "bls12_381_g2", 23   # the reference bench's G2 default
G2_KERNEL_CURVES = ("test_bm64_g2", "bn254_g2", "bls12_381_g2",
                    "bls12_377_g2")    # nonresidues 7, -1, -1, -5
# 64-point MSMs against msm_naive: two G2 curves and the BLS12-377 G1
G2_SMALL_CURVES = ("bn254_g2", "bls12_377_g2", "bls12_377")
LG_SMALL_G2 = 8     # msm_naive, Montgomery scalars and the plain path
G2_TABLE_BITS = 8   # the fixed-base table that draws the base points


def fp2_ops(n32, nr):
    """32-bit integer operations of one fp2 product, squaring and addition
    over n32-word coefficients, in prod_ops / sqr_ops terms: a product is 3
    base products and 4 additions plus those of t0 + nr t1 (one for
    |nr| = 1; for larger |nr| the doublings and additions of |nr| t1, then
    one), a squaring 2 squarings, a product and 1 addition plus those of
    nr, an addition 2 base additions."""
    add, k = 2 * n32, abs(nr)
    nr_adds = 1 if k == 1 else 1 + bin(k).count("1") + k.bit_length() - 1
    return (3 * prod_ops(n32) + (4 + nr_adds) * add,
            2 * sqr_ops(n32) + prod_ops(n32) + (1 + nr_adds) * add, 2 * add)


def pair_warps():
    """Lane selections from ec_cases' lanes for the lane-pair fp2 madd: one
    warp of 16 buckets with exactly one doubling pair (lane 33) and one
    pair at infinity (the affine point, lane 35, or the bucket, lane 36),
    then 1, 17 and 65 lanes, whose threads end inside a block."""
    out = []
    for what, inf in (("the affine point", 35), ("the bucket", 36)):
        lanes = list(range(16))
        lanes[5], lanes[9] = 33, inf
        out.append((f"a warp with one doubling pair and {what} at "
                    f"infinity", lanes))
    for n in (1, 17, 65):
        out.append((f"{n} lanes", list(range(n))))
    return out


def one_special_warps(specials):
    """Lane selections for the lane-pair add and pair kernels: for each
    (what, lane), a warp of 16 lanes, the generic lanes 0..15 with that
    one lane in slot 5; then 1, 17 and 65 lanes."""
    out = [(f"a warp with {what}", [*range(5), lane, *range(6, 16)])
           for what, lane in specials]
    return out + [(f"{n} lanes", list(range(n))) for n in (1, 17, 65)]


def g2_base(curve, nbase, seed):
    """(G, [r_j], [r_j G]): nbase uniform points of the prime-order
    subgroup, drawn as r_j G from one cofactor-cleared point G with seeded
    uniform r_j, through a fixed-base table of d 2^(8 i) G (one addition
    per 8 bits of r_j, where a scalar multiplication would double 255
    times)."""
    from sppark_tpu_torch.oracle.ec import get_oracle
    from sppark_tpu_torch.params import get_curve

    cp = get_curve(curve)
    o = get_oracle(cp)
    r = cp.scalar.modulus
    rng = random.Random(seed)
    G = o.random_point(rng)
    ks = [rng.randrange(1, r) for _ in range(nbase)]
    bits = G2_TABLE_BITS
    table, step = [], o.to_jacobian(G)
    for _ in range((r.bit_length() + bits - 1) // bits):
        row = [None, step]
        for _ in range(2, 1 << bits):
            row.append(o.jacobian_add(row[-1], step))
        table.append(row)
        step = o.jacobian_add(row[-1], step)
    pts = []
    for k in ks:
        acc = o.infinity_jacobian()
        for i, row in enumerate(table):
            d = (k >> (bits * i)) & ((1 << bits) - 1)
            if d:
                acc = o.jacobian_add(acc, row[d])
        pts.append(o.jacobian_to_affine(acc))
    for j in (0, nbase - 1):
        check(pts[j] == o.jacobian_to_affine(o.scalar_mul(G, ks[j])),
              f"{curve} base point {j} == r_j G by double-and-add")
    return G, ks, pts


def g2_phases(dev, card, rate, logs):
    """Phases 14-16; `logs`: {source: nvcc log} of the sources built in
    this run.  Returns (the fp2 kernels' entries of the summary line, the
    phases' numbers, the main path's base points, exact result and exact
    function of its words, for the tree in phase 18 and the round modes
    in phases 26-27)."""
    import torch
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.msm import MSMContext
    from sppark_tpu_torch.oracle.ec import get_oracle
    from sppark_tpu_torch.oracle.msm import msm_naive
    from sppark_tpu_torch.params import get_curve

    names = tuple(EK.kernel_name(op, G2_CURVE) for op in EK.SLAB_OPS)
    errs = dict.fromkeys(names, 0)
    seconds = {}

    def same(name, got, want, what):
        torch.cuda.synchronize()
        e = word_err(got, want)
        errs[name] = max(errs[name], e)
        check(e == 0, f"{name} == plain: {what}")

    # -- 14. fp2 kernels vs plain, four curves, planted lanes ----------------
    t0 = time.perf_counter()
    for curve in G2_KERNEL_CURVES:
        p, a, q = ec_cases(curve, 1000, dev, seed=11)
        same("ec_fp2_xyzz_madd", EK.xyzz_madd(curve, p, a),
             EK.xyzz_madd_plain(curve, p, a), f"{curve} madd, planted lanes")
        same("ec_fp2_xyzz_add", EK.xyzz_add(curve, p, q),
             EK.xyzz_add_plain(curve, p, q), f"{curve} add, planted lanes")
        same("ec_fp2_xyzz_dbl", EK.xyzz_dbl(curve, p),
             EK.xyzz_dbl_plain(curve, p), f"{curve} dbl, planted lanes")
        # the affine points as point-major rows, and through a table and
        # its slot index, as the slab gives them
        rows = torch.cat([a[0], a[1]]).T.contiguous()
        w = a[0].shape[0]
        same("ec_fp2_xyzz_madd",
             EK.xyzz_madd(curve, p, (rows[:, :w].T, rows[:, w:].T)),
             EK.xyzz_madd_plain(curve, p, a),
             f"{curve} madd on point-major rows")
        table, idx = table_case(curve, a, 1000, seed=12)
        same("ec_fp2_xyzz_madd", EK.xyzz_madd(curve, p, table, idx),
             EK.xyzz_madd_plain(curve, p, table, idx),
             f"{curve} madd through a table and a slot index (negated "
             f"rows, the zero row, repeated rows)")
        k = 32      # one warp with no special lane
        same("ec_fp2_xyzz_madd",
             EK.xyzz_madd(curve, tuple(c[:, :k] for c in p),
                          tuple(c[:, :k] for c in a)),
             EK.xyzz_madd_plain(curve, tuple(c[:, :k] for c in p),
                                tuple(c[:, :k] for c in a)),
             f"{curve} madd, one warp with no special lane")
        # the madd runs a bucket on a lane pair, 16 buckets a warp: warps
        # in which exactly one pair doubles and one pair is at infinity,
        # and lane counts off the block's edge
        for what, lanes in pair_warps():
            pw, aw = (tuple(c[:, lanes] for c in t) for t in (p, a))
            same("ec_fp2_xyzz_madd", EK.xyzz_madd(curve, pw, aw),
                 EK.xyzz_madd_plain(curve, pw, aw), f"{curve} madd, {what}")
        # so does the add: warps with exactly one special lane
        for what, lanes in one_special_warps(
                (("one doubling lane", 33), ("q at infinity", 35),
                 ("p at infinity", 36), ("one cancelling lane", 34))):
            pw, qw = (tuple(c[:, lanes] for c in t) for t in (p, q))
            same("ec_fp2_xyzz_add", EK.xyzz_add(curve, pw, qw),
                 EK.xyzz_add_plain(curve, pw, qw), f"{curve} add, {what}")
        # and the dbl, on carry chains: warps with exactly one Y == 0 lane,
        # one ZZ == 0 lane, or none
        for what, lanes in one_special_warps(
                (("one Y == 0 lane", 38), ("one ZZ == 0 lane", 36),
                 ("no special lane", 5))):
            pw = tuple(c[:, lanes] for c in p)
            same("ec_fp2_xyzz_dbl", EK.xyzz_dbl(curve, pw),
                 EK.xyzz_dbl_plain(curve, pw), f"{curve} dbl, {what}")
    seconds["14 kernels vs plain"] = time.perf_counter() - t0

    # -- 15. main path: BLS12-381 G2 2^23 --------------------------------------
    t0 = time.perf_counter()
    cp = get_curve(G2_CURVE)
    o = get_oracle(cp)
    r = cp.scalar.modulus
    G, ks, base = g2_base(G2_CURVE, 1 << LG_BASE, seed=42)
    seconds["15 base points"] = time.perf_counter() - t0
    print(f"{G2_CURVE}: {len(base)} base points r_j G in "
          f"{seconds['15 base points']:.1f} s", flush=True)

    def exact(words):
        """sum_i s_i P_i = (sum_j c_j r_j mod r) G: one multiplication."""
        k = sum(c * kj for c, kj in zip(class_sums(len(base), words, r), ks))
        return o.jacobian_to_affine(o.scalar_mul(G, k % r))

    t0 = time.perf_counter()
    ctx, wd, launches, want, _ = msm_main(G2_CURVE, G2_LG, dev, full=True,
                                          base=base,
                                 exact=exact, lg_small=LG_SMALL_G2)
    seconds["15 main path and checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for curve in G2_SMALL_CURVES:
        scp = get_curve(curve)
        so = get_oracle(scp)
        rng = random.Random(8)
        pool = [so.random_point(rng) for _ in range(8)]
        pts = [pool[i % 8] for i in range(64)]
        pts[3] = so.infinity_affine()
        sr = scp.scalar.modulus
        sc = [rng.randrange(sr) for _ in range(64)]
        sc[0], sc[1], sc[4], sc[12] = 0, sr - 1, 9, 9    # 4, 12: doubling
        check(MSMContext(curve, 64).invoke(sc, points=pts)
              == msm_naive(scp, pts, sc),
              f"MSM {curve} 64 == msm_naive (0, r-1, doubling terms)")
    seconds["15 " + ", ".join(G2_SMALL_CURVES)] = time.perf_counter() - t0

    # -- 16. times ----------------------------------------------------------------
    t0 = time.perf_counter()
    t_msm, peak, resident, busy, t_prof, phases, by_kernel = msm_times(
        ctx, wd, G2_CURVE, G2_LG, card)
    N = cp.field.n_ref_limbs
    M, S, A = fp2_ops(N, cp.fp2.nr_small)
    cases, _ = point_kernel_cases(G2_CURVE, ctx, wd, M, S, A)
    # the dbl at a wide shape, every lane on the fast leg (random
    # coordinates), against its operations bound
    from sppark_tpu_torch.ff.bigmont import get_field_ops
    F = get_field_ops(cp.field)
    g = np.random.default_rng(16)
    wide = tuple(torch.cat([rand_canon(F, DBL_WIDE_LANES, g, dev)
                            for _ in range(2)]) for _ in range(4))
    dbl_ops = 6 * M + 3 * S + 7 * A
    cases += [
        (f"ec_fp2_xyzz_dbl 2^{DBL_WIDE_LANES.bit_length() - 1}",
         DBL_WIDE_LANES, lambda: EK.xyzz_dbl(G2_CURVE, wide),
         lambda: EK.xyzz_dbl_plain(G2_CURVE, wide),
         8 * 4 * 2 * N * DBL_WIDE_LANES, DBL_WIDE_LANES * dbl_ops)]
    timing = time_kernels(cases, same, rate, card)
    del wide
    dbl = by_kernel.get("ec_fp2_xyzz_dbl", (0.0, 0))
    regs = ptxas_summary(logs.get("ec_fp2_dbl", ""), point_kernel)
    print(f"ec_fp2_xyzz_dbl in the G2 slab {G2_CURVE} 2^{G2_LG}: "
          f"{dbl[0] / max(dbl[1], 1) * 1e3:.2f} device us a launch ("
          f"{dbl[1]} launches, the profiled invoke); one lane's 6M + 3S + "
          f"7A in fp2, {dbl_ops} operations; ec_kernel<Fp2PairCC<{N}>,"
          f"xyzz_dbl>: " + regs.get(f"ec_kernel<Fp2PairCC<{N}>,xyzz_dbl>",
                                    "registers: not rebuilt in this run")
          + f"  [{card}]", flush=True)
    seconds["16 times"] = time.perf_counter() - t0
    print(f"G2 phases' seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()), flush=True)
    numbers = {"g2_msm_ms": t_msm, "g2_phases_device_host_ms": phases,
               "g2_kernels_ms_launches": by_kernel, "g2_peak_gib": peak,
               "g2_resident_gib": resident,
               "g2_device_busy_ms": busy, "g2_profiled_wall_ms": t_prof,
               "g2_launches": launches, "g2_phase_seconds": seconds,
               "g2_dbl_wide_ms": timing[cases[-1][0]][0]}
    line = {"ec_fp2_xyzz_madd": 387, "ec_fp2_xyzz_add": 224,
            "ec_fp2_xyzz_dbl": 336}
    entries = []
    for name in names:
        ms, pms, b, by = timing[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"sppark_tpu_torch/csrc/{EK.SOURCES[name]}.cu",
            "replaces": f"sppark_tpu/ec/pallas_ops.py:{line[name]} "
                        f"(degree 2)",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": pms, "bound_ms": b, "bound_by": by,
            "library_ms": None})
    return entries, numbers, (base, want, exact)


# -- tree MSM phases (17-19) --------------------------------------------------------

PAIR_CURVES = EC_CURVES + G2_KERNEL_CURVES
TREE_G2_LG = G2_LG      # the G2 tree on phase 15's whole input


def pair_cases(curve, n, dev, seed):
    """Affine l, r over n >= 96 lanes.  Lanes 0..31 (one warp) are generic
    pairs, no doubling; in the second warp lane 33 doubles, 34 cancels, 35
    has l at infinity, 36 r, 37 both, 38 doubles a y == 0 pair (not on the
    curve: the case that goes to infinity); lanes 64..95 all double."""
    from sppark_tpu_torch.ec.core import get_curve_ops
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.oracle.ec import get_oracle
    from sppark_tpu_torch.params import get_curve

    o = get_oracle(get_curve(curve))
    rng = random.Random(seed)
    pool = [o.random_point(rng) for _ in range(16)]
    j = [rng.randrange(16) for _ in range(n)]
    L = [pool[k] for k in j]
    R = [pool[(k + 1 + rng.randrange(15)) % 16] for k in j]
    R[33] = L[33]
    R[34] = o.affine_neg(L[34])
    L[35] = L[37] = R[36] = R[37] = o.infinity_affine()
    R[64:96] = L[64:96]
    ops = get_curve_ops(curve, FK.PLAIN)
    l, r = ops.affine_from_ints(L, dev), ops.affine_from_ints(R, dev)
    l[1][:, 38] = r[1][:, 38] = 0
    r[0][:, 38] = l[0][:, 38]
    return l, r


def pair_views(l, r):
    """The same pairs as a tree level reads them: from a point table (l's
    lanes, r's lanes, the zero row) through an index pair (level 1 and the
    level-0 index), and the even and odd lanes of limb-major coordinates
    (a later level).  Returns [(what, l view, r view, idx or None)]."""
    import torch
    W, n = l[0].shape
    rows = torch.cat([torch.cat(l).T, torch.cat(r).T, torch.zeros(
        (1, 2 * W), dtype=torch.int32, device=l[0].device)]).contiguous()
    table = (rows[:, :W].T, rows[:, W:].T)
    i = torch.arange(n, dtype=torch.int32, device=l[0].device)
    X = torch.stack([l[0], r[0]], -1).reshape(W, 2 * n)
    Y = torch.stack([l[1], r[1]], -1).reshape(W, 2 * n)
    return [("table and index", table, table, (i, i + n)),
            ("limb-major lanes", (X[:, 0::2], Y[:, 0::2]),
             (X[:, 1::2], Y[:, 1::2]), None)]


def pair_level1(curve, ctx, wd, M, S, A):
    """The two pair kernels at their level-1 shape on the main path's data:
    window group 0's level-0 index (tree.level0_index), its even and odd
    slots, into the point table.  M, S, A: the 32-bit operations of one
    product, squaring and addition of the coordinate field.  prep counts 3
    additions per lane; finish 2 M + S + 5 A per chord lane and 2 M + 2 S +
    6 A per tangent lane, nothing on the lanes that only copy or zero; the
    bytes count each table row the level reads once (the padding's zero
    row, read by a third of the lanes, once) and the two index words a
    lane.  Returns (the level's denominators, the cases for
    time_kernels)."""
    import torch
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.msm import tree

    st = ctx.stages
    sched = st.schedule(wd)
    m0, _, wg = st.plan(sched[-1])
    g = slice(0, wg)
    idx = tree.level0_index(*(a[g] for a in sched[:5]), m0)
    del sched
    ix = (idx[0], idx[1])
    W = ctx.rows.shape[1] // 2
    table = (ctx.rows[:, :W].T, ctx.rows[:, W:].T)
    lanes = idx.shape[1]
    rows = torch.unique(idx).numel()        # the table rows the level reads
    den, flags = EK.affine_pair_prep(curve, table, table, ix)
    inv = tree.batch_inv_flat(st.ops.F, den)
    chord = int(((flags & EK.ACTIVE) != 0).sum()) - int(
        ((flags & EK.DBL) != 0).sum())
    tangent = int(((flags & EK.DBL) != 0).sum())
    print(f"{curve} tree level 1 of group 0: {lanes} lanes, {chord} chord, "
          f"{tangent} tangent, {lanes - chord - tangent} copy or zero; "
          f"{rows} distinct table rows read", flush=True)
    pre = EK.kernel_name("pair_", curve)
    return den, [
        (pre + "prep", lanes,
         lambda: EK.affine_pair_prep(curve, table, table, ix),
         lambda: EK.affine_pair_prep_plain(curve, table, table, ix),
         rows * 2 * 4 * W + (4 * W + 4 + 8) * lanes, 3 * A * lanes),
        (pre + "finish", lanes,
         lambda: EK.affine_pair_finish(curve, table, table, inv, flags, ix),
         lambda: EK.affine_pair_finish_plain(curve, table, table, inv, flags,
                                             ix),
         rows * 2 * 4 * W + (3 * 4 * W + 4 + 8) * lanes,
         chord * (2 * M + S + 5 * A) + tangent * (2 * M + 2 * S + 6 * A)),
    ]


INV_G2_CURVES = ("bls12_381_g2", "bn254_g2", "bls12_377_g2")  # nr -1, -1, -5
INV_LANES = (1, 31, 4095, 4097, (1 << 16) + 3)  # T C = 4096 lanes a block
INV_ORACLE_LANES = 4096
INV_SLICE = 1 << 20     # the plain versions' slice of a level: 256 blocks


def inv_inputs(F, n, rng, dev, degree):
    """(degree n32, n) canonical words with zero lanes at 0, 7 and n - 1,
    and in degree 2 a (0, c1) lane at 3 and a (c0, 0) lane at 5."""
    import torch
    x = torch.cat([rand_canon(F, n, rng, dev) for _ in range(degree)])
    x[:, [0, 7, n - 1]] = 0
    if degree == 2:
        x[:F.n32, 3] = 0
        x[F.n32:, 5] = 0
    return x


def batch_inv_checks(dev, same):
    """Phase 17b: bigmont_inv_up and bigmont_inv_down against their plain
    versions, each on the same inputs, at INV_LANES (the up kernel's four
    arrays; the down kernel on the plain up arrays and bigmont_pow's block
    inverses), and the three-launch pipeline against mont_batch_inv_plain,
    in degree 1 on EC_CURVES' fields and degree 2 on three G2 curves; then a *
    a^-1 == 1 (0 for 0) against the big-int oracle on 4096 lanes of
    BLS12-381 Fp and Fp2."""
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.ff.bigmont import get_field_ops
    from sppark_tpu_torch.ff.ext import get_fp2_ops
    from sppark_tpu_torch.oracle.field import Fp2, Fr
    from sppark_tpu_torch.params import get_curve, get_field

    rng = np.random.default_rng(17)
    cases = [(get_field_ops(get_curve(c).field), get_curve(c).field, 1, 0)
             for c in EC_CURVES]
    for c in INV_G2_CURVES:
        F2 = get_fp2_ops(get_curve(c).fp2)
        cases.append((F2.base, F2.base.params, 2, F2.nr))
    for B, fp, deg, nr in cases:
        what = f"{fp.name}" + (f"^2 (nr {nr})" if deg == 2 else "")
        x = inv_inputs(B, INV_LANES[-1], rng, dev, deg)
        want = FK.mont_batch_inv_plain(x, fp, deg, nr)
        for n in INV_LANES:
            xn = x[:, :n].contiguous()
            up = FK.inv_up_plain(xn, fp, deg, nr)
            for got, ref, arr in zip(FK.inv_up(xn, fp, deg, nr), up,
                                     ("pre", "dn", "tp", "blk")):
                if ref is not None:
                    same("bigmont_inv_up", got, ref, f"{what}, {n} lanes, "
                                                     f"{arr}")
            blkinv = FK.mont_pow(up[3], fp.modulus - 2, fp)
            same("bigmont_inv_down",
                 FK.inv_down(xn, *up[:3], blkinv, fp, deg, nr),
                 FK.inv_down_plain(xn, *up[:3], blkinv, fp, deg),
                 f"{what}, {n} lanes")
            same("bigmont_inv_down", FK.mont_batch_inv(xn, fp, deg, nr),
                 want[:, :n], f"{what}, {n} lanes: up, pow, down == "
                              f"mont_batch_inv_plain")
    n = INV_ORACLE_LANES
    fp = get_field("bls12_381_fp")
    F = get_field_ops(fp)
    x = inv_inputs(F, n, rng, dev, 1)
    o = Fr(fp)
    ok = all(o.mul(a, b) == (1 if a else 0) for a, b in zip(
        F.to_int_list(x), F.to_int_list(FK.mont_batch_inv(x, fp))))
    check(ok, f"bls12_381_fp: a * a^-1 == 1 (0 for 0) on {n} lanes, "
              f"against the oracle")
    F2 = get_fp2_ops(get_curve("bls12_381_g2").fp2)
    x = inv_inputs(F2.base, n, rng, dev, 2)
    o2 = Fp2(F2.params)
    ok = all(o2.mul(a, b) == ((0, 0) if o2.is_zero(a) else (1, 0))
             for a, b in zip(F2.to_int_list(x), F2.to_int_list(
                 FK.mont_batch_inv(x, F2.base.params, 2, F2.nr))))
    check(ok, f"bls12_381_g2 Fp2: a * a^-1 == 1 (0 for 0) on {n} lanes, "
              f"against the oracle")


def inv_counts(n, degree, nr):
    """(up, down) work of the batch inversion over n non-zero lanes, as
    (products, squarings, additions) of the base field: the walk's
    products skip each chunk's first lane, the block's tree takes T - 1
    products up and 3 (T - 1) down (rebuilt, then swept); degree 2 adds
    the norm (2 squarings, the additions of nr) and the conjugate (2
    products, 1 subtraction)."""
    from sppark_tpu_torch.ff import kernels as FK
    T, C = FK.INV_THREADS, FK.INV_CHUNK
    nb = -(-n // (T * C))
    active = sum(min(T, n - b * T * C) for b in range(nb))
    up = [n - active + nb * (T - 1), 0, 0]
    down = [2 * (n - active) + 3 * nb * (T - 1), 0, 0]
    if degree == 2:
        k = abs(nr)
        up[1] += 2 * n
        up[2] += n * (1 + (0 if k == 1 else bin(k).count("1")
                           + k.bit_length() - 1))
        down[0] += 2 * n
        down[2] += n
    return nb, up, down


def inv_level1(curve, F, den, same, rate, card):
    """The batch inversion at a tree's level 1 on the main path's
    denominators: the three-launch pipeline (what tree.batch_inv_flat
    runs on the card) and each of its kernels alone by CUDA events, the
    plain versions on the first INV_SLICE lanes (held against the
    kernels' arrays there), each kernel's bound, and both the pipeline and
    the product tree it replaced (ff/inversion.py:batch_inv_tree through
    bigmont_ew, padded to a power of two) by the wall clock.  Returns
    ({kernel: (ms, plain ms, bound ms, bound by)}, numbers)."""
    import torch
    from sppark_tpu_torch.ff import inversion
    from sppark_tpu_torch.ff import kernels as FK

    degree = F.words // F.n32
    B = F.base if degree == 2 else F
    fp, nr = B.params, getattr(F, "nr", 0)
    N, T = fp.n_ref_limbs, FK.INV_THREADS
    flat = den.reshape(den.shape[0], -1).contiguous()
    n = flat.shape[1]
    up = FK.inv_up(flat, fp, degree, nr)
    blkinv = FK.mont_pow(up[3], fp.modulus - 2, fp)
    out = FK.inv_down(flat, *up[:3], blkinv, fp, degree, nr)
    k, kb = INV_SLICE, INV_SLICE // (T * FK.INV_CHUNK)
    xs = flat[:, :k]
    up_s = FK.inv_up_plain(xs, fp, degree, nr)
    for got, ref, arr in zip(up, up_s, ("pre", "dn", "tp", "blk")):
        if ref is not None:
            sl = {"tp": kb * T, "blk": kb}.get(arr, k)
            same("bigmont_inv_up", got[:, :sl], ref,
                 f"{curve} level 1 ({n} lanes), {arr} of the first {k}")
    same("bigmont_inv_down", out[:, :k],
         FK.inv_down_plain(xs, *up_s[:3], blkinv[:, :kb], fp, degree),
         f"{curve} level 1 ({n} lanes), the first {k}")
    nb, cu, cd = inv_counts(n, degree, nr)
    ops = [c[0] * prod_ops(N) + c[1] * sqr_ops(N) + c[2] * 2 * N
           for c in (cu, cd)]
    w = 4 * N       # bytes of one base-field element
    up_bytes = n * w * (degree + 1 + (degree == 2)) + nb * (T + 1) * w
    down_bytes = n * w * (2 * degree + 1 + (degree == 2)) + nb * (T + 1) * w
    timing = {}
    for name, fn, pfn, nbytes, op in (
            ("bigmont_inv_up", lambda: FK.inv_up(flat, fp, degree, nr),
             lambda: FK.inv_up_plain(xs, fp, degree, nr), up_bytes, ops[0]),
            ("bigmont_inv_down",
             lambda: FK.inv_down(flat, *up[:3], blkinv, fp, degree, nr),
             lambda: FK.inv_down_plain(xs, *up_s[:3], blkinv[:, :kb], fp,
                                       degree), down_bytes, ops[1])):
        ms, pms = kernel_ms(fn, reps=10), kernel_ms(pfn, reps=1)
        b, by = bound(nbytes, op, rate)
        timing[name] = (ms, pms, b, by)
        print(f"time {name} (degree {degree}) at {curve} level 1, {n} "
              f"lanes: {ms:.4f} ms (plain {pms:.4f} ms on {k} lanes, bound "
              f"{b:.4f} ms by {by}, {b / ms:.3f} of bound)  [{card}]",
              flush=True)
    e = fp.modulus - 2
    nsqr, nmul = pow_chain(e, POW_WINDOW)
    pow_ms = kernel_ms(lambda: FK.mont_pow(up[3], e, fp), reps=10)
    pipe_ms = kernel_ms(lambda: FK.mont_batch_inv(flat, fp, degree, nr),
                        reps=10)
    bound_ms = sum(timing[k][2] for k in timing) + bound(
        2 * w * nb, nb * (nsqr * sqr_ops(N) + nmul * prod_ops(N)), rate)[0]
    p2 = 1 << (n - 1).bit_length()
    padded = torch.cat([den.reshape(den.shape[0], n),
                        F.ones((p2 - n,), den.device)], 1)
    if degree == 1:
        old = lambda: inversion.batch_inv_tree(F.mul, F.inv, padded)  # noqa
    else:
        old = lambda: F._inv_by_norm(padded, lambda t: inversion.  # noqa
                                     batch_inv_tree(B.mul, B.inv, t))
    same("bigmont_inv_down", F.batch_inv(den).reshape(den.shape[0], n),
         old()[:, :n], f"{curve} level 1: the pipeline == the product tree "
                       f"it replaced")
    walls = {"pipeline wall": wall_ms(lambda: F.batch_inv(den), 5),
             "product tree wall (replaced)": wall_ms(old, 5)}
    del padded
    print(f"time batch inversion (degree {degree}) at {curve} level 1, "
          f"{n} lanes, {nb} blocks: up + pow + down {pipe_ms:.4f} ms by "
          f"events (bound {bound_ms:.4f} ms), bigmont_pow over the {nb} "
          f"block products {pow_ms:.4f} ms; median of 5 synchronised: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in walls.items())
          + f"  [{card}]", flush=True)
    return timing, {"lanes": n, "blocks": nb, "pipeline_ms": pipe_ms,
                    "pipeline_bound_ms": bound_ms, "pow_ms": pow_ms,
                    **{k.replace(" ", "_"): v for k, v in walls.items()},
                    **{f"{k}_ms": v[0] for k, v in timing.items()}}


POW_WINDOW = 4      # the exponent digit of csrc/bigmont.cu's bigmont_pow


def pow_chain(e, win):
    """(squarings, products) of bigmont_pow's chain for exponent e by
    fixed windows of `win` bits: the table of x^2 .. x^(2^win - 1) (none
    for win = 1), then win squarings per digit below the top one and a
    product per non-zero digit."""
    top = (e.bit_length() - 1) // win
    digits = [(e >> (win * d)) & ((1 << win) - 1) for d in range(top)]
    table = (1 << win) - 2 if win > 1 else 0
    return win * top, table + sum(1 for d in digits if d)


def tree_phases(dev, card, rate, g1, g2, pow_err, logs):
    """Phases 17-19 on the G1 and G2 main paths' (base points, exact
    result); `pow_err` is bigmont_pow's largest error in phase 6; `logs`:
    {source: nvcc log} of the sources built in this run.  Returns
    (the pair kernels' and bigmont_pow's entries of the summary line, the
    phases' numbers, the tree paths' launches)."""
    import torch
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ec.core import get_curve_ops
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.ff.bigmont import get_field_ops
    from sppark_tpu_torch.msm.tree import batch_inv_flat
    from sppark_tpu_torch.params import get_curve

    names = [EK.kernel_name(op, c) for c in (MSM_CURVE, G2_CURVE)
             for op in ("pair_prep", "pair_finish")]
    errs = dict.fromkeys(names + ["bigmont_inv_up", "bigmont_inv_down"], 0)
    errs["bigmont_pow"] = pow_err
    seconds = {}

    def same(name, got, want, what):
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        e = word_err(got, want)
        errs[name] = max(errs[name], e)
        check(e == 0, f"{name} == plain: {what}")

    # -- 17. the pair kernels vs plain: seven curves, planted lanes, views --
    t0 = time.perf_counter()
    for curve in PAIR_CURVES:
        l, r = pair_cases(curve, 128, dev, seed=13)
        prep, finish = (EK.kernel_name(op, curve)
                        for op in ("pair_prep", "pair_finish"))
        den, flags = EK.affine_pair_prep_plain(curve, l, r)
        check(sorted(set(flags.tolist())) == [0, 1, 3, 4, 8],
              f"{curve} pair cases: every flag word planted")
        inv = batch_inv_flat(get_curve_ops(curve, FK.PLAIN).F, den)
        want = EK.affine_pair_finish_plain(curve, l, r, inv, flags)
        for what, lv, rv, ix in [("limb-major", l, r, None)] + pair_views(
                l, r):
            for k, warp in ((slice(0, 32), "a warp with no doubling lane"),
                            (slice(32, 64), "a warp with one doubling "
                                            "lane and the specials"),
                            (slice(64, 96), "a warp of doubling lanes"),
                            (slice(0, 128), "all lanes")):
                if ix is None:
                    lk = tuple(c[:, k] for c in lv)
                    rk = tuple(c[:, k] for c in rv)
                    ik = None
                else:
                    lk, rk, ik = lv, rv, (ix[0][k], ix[1][k])
                same(prep, EK.affine_pair_prep(curve, lk, rk, ik),
                     (den[:, k], flags[k]), f"{curve} {what}, {warp}")
                same(finish,
                     EK.affine_pair_finish(curve, lk, rk, inv[:, k],
                                           flags[k], ik),
                     tuple(c[:, k] for c in want), f"{curve} {what}, {warp}")
        if get_curve(curve).degree == 1:
            continue
        # the fp2 prep and finish run a pair on a lane pair, 16 lanes a
        # warp: chords with exactly one doubling, cancelling, copy or zero
        # lane, on every view
        for warp, lanes in one_special_warps(
                (("one tangent lane", 33), ("one cancelling lane", 34),
                 ("one USE_R lane", 35), ("one USE_L lane", 36),
                 ("one lane of two infinities", 37))):
            lw, rw = (tuple(c[:, lanes] for c in t) for t in (l, r))
            args = (inv[:, lanes], flags[lanes])
            dk = EK.affine_pair_prep_plain(curve, lw, rw)
            wk = EK.affine_pair_finish_plain(curve, lw, rw, *args)
            for what, lv, rv, ix in [("limb-major", lw, rw, None)] + \
                    pair_views(lw, rw):
                same(prep, EK.affine_pair_prep(curve, lv, rv, ix), dk,
                     f"{curve} {what}, {warp}")
                same(finish, EK.affine_pair_finish(curve, lv, rv, *args, ix),
                     wk, f"{curve} {what}, {warp}")
    seconds["17 pair kernels vs plain"] = time.perf_counter() - t0

    # -- 17b. the batch inversion kernels vs plain, both degrees -------------
    t0 = time.perf_counter()
    batch_inv_checks(dev, same)
    seconds["17b batch inversion vs plain"] = time.perf_counter() - t0

    # -- 18. the tree MSM: G1 2^24, then G2 --------------------------------
    t0 = time.perf_counter()
    base, want = g1
    ctx, wd, launches, _, _ = msm_main(
        MSM_CURVE, MSM_LG, dev, full=True, base=base,
        exact=lambda words: want, mode="tree")
    seconds["18 G1 tree and checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    base2, want2 = g2[:2]
    ctx2, wd2, launches2, _, _ = msm_main(
        G2_CURVE, TREE_G2_LG, dev, full=False, base=base2,
        exact=lambda words: want2, lg_small=LG_SMALL_G2, mode="tree")
    seconds["18 G2 tree and checks"] = time.perf_counter() - t0
    for curve, lg, counts in ((MSM_CURVE, MSM_LG, launches),
                              (G2_CURVE, TREE_G2_LG, launches2)):
        levels = counts[EK.kernel_name("pair_prep", curve)]
        check(counts["bigmont_pow"] == counts["bigmont_inv_up"]
              == counts["bigmont_inv_down"] == levels + 1,
              f"tree {curve} 2^{lg}: bigmont_inv_up, bigmont_pow and "
              f"bigmont_inv_down launched once per level ({levels}) and "
              f"once for to_affine; bigmont_ew {counts['bigmont_ew']} "
              f"times")

    # -- 19. times ------------------------------------------------------------
    t0 = time.perf_counter()
    numbers = {}
    timing = {}
    for curve, lg, c, w, key in ((MSM_CURVE, MSM_LG, ctx, wd, "tree_g1"),
                                 (G2_CURVE, TREE_G2_LG, ctx2, wd2,
                                  "tree_g2")):
        t_msm, peak, resident, busy, t_prof, phases, by_kernel = msm_times(
            c, w, curve, lg, card)
        numbers.update({f"{key}_msm_ms": t_msm, f"{key}_peak_gib": peak,
                        f"{key}_resident_gib": resident,
                        f"{key}_device_busy_ms": busy,
                        f"{key}_profiled_wall_ms": t_prof,
                        f"{key}_phases_device_host_ms": phases,
                        f"{key}_kernels_ms_launches": by_kernel})
        per = {k: by_kernel.get(k, (0.0, 0)) for k in (
            "bigmont_ew", "bigmont_inv_up", "bigmont_pow",
            "bigmont_inv_down", EK.kernel_name("pair_finish", curve),
            EK.kernel_name("xyzz_dbl", curve))}
        per["elementwise"] = tuple(map(sum, zip((0.0, 0), *(
            v for k, v in by_kernel.items() if "elementwise" in k))))
        lv_dev, lv_host = phases["msm.tree_levels"]
        print(f"per tree invoke, {curve} 2^{lg} (launches, device ms): "
              + ", ".join(f"{k} {c_} ({d:.4f} ms)" for k, (d, c_) in
                          per.items())
              + f"; msm.tree_levels {lv_dev:.4f} device / {lv_host:.4f} "
              f"host ms; idle share {1 - busy / t_prof:.4f} under the "
              f"profiler  [{card}]", flush=True)
        numbers[f"{key}_per_invoke_ms_launches"] = per
        cp = get_curve(curve)
        N = cp.field.n_ref_limbs
        dbl = EK.kernel_name("xyzz_dbl", curve)
        print(f"{dbl} in the tree {curve} 2^{lg}: "
              f"{per[dbl][0] / max(per[dbl][1], 1) * 1e3:.2f} device us a "
              f"launch ({per[dbl][1]} launches, the profiled invoke)  "
              f"[{card}]", flush=True)
        ops = (fp2_ops(N, cp.fp2.nr_small) if cp.fp2 else
               (prod_ops(N), sqr_ops(N), 2 * N))
        den, cases = pair_level1(curve, c, w, *ops)
        timing.update(time_kernels(cases, same, rate, card))
        del cases
        if cp.fp2 is None:
            regs = ptxas_summary(logs.get("ec_pair", ""), point_kernel)
            print(f"ec_pair_finish at N = {N}: " + "; ".join(
                f"{what} {regs.get(k, 'not rebuilt in this run')}"
                for what, k in (
                    ("level 1 (through the index)",
                     f"ec_kernel<FpCC<{N}>,pair_finish,table>"),
                    ("later levels (in place)",
                     f"ec_kernel<FpCC<{N}>,pair_finish>")))
                  + f"  [{card}]", flush=True)
        inv_t, inv_nums = inv_level1(curve, c.stages.ops.F, den, same, rate,
                                     card)
        numbers[f"{key}_batch_inv_level1"] = inv_nums
        if key == "tree_g1":
            timing.update(inv_t)
        del den
        torch.cuda.empty_cache()
    del ctx, ctx2
    # bigmont_pow at the shape of every inversion of the MSM paths: one
    # lane (each tree level's root, to_affine's total), x^(p - 2) over the
    # base field of both curves
    fp = get_curve(MSM_CURVE).field
    N, p = fp.n_ref_limbs, fp.modulus
    x = get_field_ops(fp).from_int_list([random.Random(19).randrange(1, p)],
                                        device=dev)
    win = POW_WINDOW
    nsqr, nmul = pow_chain(p - 2, win)
    ops = nsqr * sqr_ops(N) + nmul * prod_ops(N)
    timing.update(time_kernels(
        [("bigmont_pow", 1, lambda: FK.mont_pow(x, p - 2, fp),
          lambda: FK.mont_pow_plain(x, p - 2, fp), 2 * 4 * N, ops)],
        same, rate, card))
    # one thread cannot issue faster than its warp: one instruction per
    # cycle at the SM clock, over the chain's counted operations
    clock = rate / (torch.cuda.get_device_properties(0).multi_processor_count
                    * 64)
    floor_ms = ops / clock * 1e3
    print(f"bigmont_pow x^(p - 2) over {fp.name}: {win}-bit windows, "
          f"{nsqr} squarings + {nmul} products ({pow_chain(p - 2, 1)[0]} + "
          f"{pow_chain(p - 2, 1)[1]} bit by bit), {ops} operations; "
          f"single-thread floor {floor_ms:.4f} ms at one instruction per "
          f"cycle and {clock / 1e9:.3f} GHz  [{card}]", flush=True)

    # the same inversion as it ran before bigmont_pow: one bigmont_ew
    # launch per square and per product, through the wrapper, MSB first
    def ew_chain():
        acc = x
        for bit in bin(p - 2)[3:]:
            acc = FK.mont_sqr(acc, fp)
            if bit == "1":
                acc = FK.mont_mul(acc, x, fp)
        return acc

    same("bigmont_pow", FK.mont_pow(x, p - 2, fp), ew_chain(),
         "x^(p - 2) at one lane against the chain of bigmont_ew launches")
    chain_ms = {
        "bigmont_pow wall": wall_ms(lambda: FK.mont_pow(x, p - 2, fp), 5),
        "bigmont_ew chain wall": wall_ms(ew_chain, 5),
        "bigmont_ew chain events": kernel_ms(ew_chain, 5)}
    nbits = (p - 2).bit_length()
    print(f"time x^(p - 2) over {fp.name} at one lane, one call of "
          f"bigmont_pow against the chain of {nbits - 1} + "
          f"{bin(p - 2).count('1') - 1} bigmont_ew launches it replaced "
          "(wall: median of 5, synchronised; events: CUDA events over 5 "
          "back-to-back chains): " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in chain_ms.items())
          + f"  [{card}]", flush=True)
    # the host time of one bigmont_ew call at one lane: the wrapper
    # (argument checks, allocation, device guard, ctypes), then the bare
    # ctypes launch on pointers made once
    out = torch.empty_like(x)
    lib, consts = FK._lib(), FK.field_consts(fp).ctypes.data
    stream = torch.cuda.current_stream().cuda_stream
    host_us = {
        "wrapper": host_us_per_call(lambda: FK.mont_mul(x, x, fp)),
        "bare launch": host_us_per_call(lambda: lib.bigmont_ew(
            N, 0, x.data_ptr(), x.data_ptr(), out.data_ptr(), 1, consts,
            stream))}
    print("host us per bigmont_ew call at one lane (mean of 2000): "
          + ", ".join(f"{k} {v:.2f}" for k, v in host_us.items())
          + f"  [{card}]", flush=True)
    seconds["19 times"] = time.perf_counter() - t0
    print("tree phases' seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()), flush=True)
    numbers.update({"tree_g1_launches": launches,
                    "tree_g2_launches": launches2,
                    "tree_phase_seconds": seconds,
                    "pow_single_thread_floor_ms": floor_ms,
                    "pow_vs_ew_chain_ms": chain_ms,
                    "bigmont_ew_host_us_per_call": host_us})
    line = {"pair_prep": 477, "pair_finish": 523}
    entries = []
    for name in names:
        ms, pms, b, by = timing[name]
        op = name[name.index("pair_"):]
        counts = launches if name in launches else launches2
        entries.append({
            "name": name, "route": "cuda",
            "source": f"sppark_tpu_torch/csrc/{EK.SOURCES[name]}.cu",
            "replaces": f"sppark_tpu/ec/pallas_ops.py:{line[op]}"
                        + (" (degree 2)" if "fp2" in name else ""),
            "launches": counts[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": pms, "bound_ms": b, "bound_by": by,
            "library_ms": None})
    ms, pms, b, by = timing["bigmont_pow"]
    entries.append({
        "name": "bigmont_pow", "route": "cuda",
        "source": "sppark_tpu_torch/csrc/bigmont.cu",
        "replaces": "sppark_tpu/ff/bigmont.py:383 (the lax.scan chain of "
                    "sppark_tpu/ff/base.py:154)",
        "launches": launches["bigmont_pow"] + launches2["bigmont_pow"],
        "max_abs_err": errs["bigmont_pow"], "ms": ms, "plain_ms": pms,
        "bound_ms": b, "bound_by": by, "library_ms": None})
    # timed at the G1 tree's level 1 (degree 1); degree 2 is printed
    for name in ("bigmont_inv_up", "bigmont_inv_down"):
        ms, pms, b, by = timing[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": "sppark_tpu_torch/csrc/batch_inv.cu",
            "replaces": "sppark_tpu/ff/bigmont.py:383 (its products in "
                        "sppark_tpu/ff/base.py:201 batch_inv and :232 "
                        "batch_inv_tree, sppark_tpu/ff/ext.py:95-107)",
            "launches": launches[name] + launches2[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": pms,
            "bound_ms": b, "bound_by": by, "library_ms": None})
    return entries, numbers, {**launches, **launches2}


# -- narrow-field NTT phases (20-25) ------------------------------------------------

NARROW_FIELD = "baby_bear"          # BASELINE config 1
NARROW_FIELDS = ("baby_bear", "baby_bear_risc0")
NARROW_CONFIG_LG = 20               # config 1: forward + inverse 2^20
NARROW_LG, NARROW_BLOWUP = 24, 2    # the NTT 2^24 and the LDE 2^24 x 4
TRACE_COLS, TRACE_LG = 64, 20       # a STARK prover's trace LDE, x 4
NARROW_ROW_LGS = tuple(range(1, 14))    # phase 20's row lengths,
NARROW_COL_LGS = tuple(range(1, 12))    # column lengths
NARROW_COL_COUNTS = (2, 8, 8192)        # and column counts
NARROW_ORDER_LGS = (10, 16)         # the 16 configurations: one pass, four-step
NARROW_ORACLE_LGS = (1, 12, 14)     # the big-int oracle
# 32-bit integer operations counted from csrc/mont32.cuh: a signed
# Montgomery product (the low and high products of a and b, the low
# product lo * pinv, the high product of m and p, a subtract, an add and a
# min: 7) and a butterfly's add and sub (three each)
OPS_PER_MUL_MONT32 = 7
OPS_ADD_SUB_MONT32 = 6
WORD32 = 4


def narrow_words(field, rng, dev, *shape, planted=True):
    """Canonical u32 Montgomery words of a 31-bit field as int32; with
    `planted`, 0, 1 and p - 1 in the first lanes and p - 1 in a whole
    warp's lanes (32-63)."""
    import torch
    from sppark_tpu_torch.params import get_field
    fp = get_field(field)
    w = rng.integers(0, fp.modulus, size=shape, dtype=np.int64)
    if planted:
        flat = w.reshape(-1)
        flat[:3] = [0, fp.one_mont, fp.modulus - 1][:flat.size]
        flat[32:64] = fp.modulus - 1
    return torch.from_numpy(w.astype(np.int32)).to(dev)


def ptxas_summary(log, name_of=None):
    """{kernel name: "R registers, S / L bytes spill stores / loads"} from
    an nvcc -Xptxas -v build log.  name_of(mangled name) names a kernel,
    None to leave it out; default: the NTT passes' rows_kernel and
    cols_kernel."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            if name_of:
                entry = name_of(m.group(1))
            else:
                k = re.search(r"(rows_kernel|cols_kernel)", m.group(1))
                entry = k.group(1) if k else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if entry and m:
            out[entry] = (f"{m.group(1)} / {m.group(2)} bytes spill stores "
                          f"/ loads")
        m = re.search(r"Used (\d+) registers", line)
        if entry and m:
            out[entry] = f"{m.group(1)} registers, " + out.get(entry, "")
    return out


def narrow_phases(dev, card, rate, build_log=""):
    """Phases 20-25 (build_log: the ntt_mont32 build's, for the kernels'
    registers).  Returns (the mont32 kernels' entries of the summary line,
    the phases' numbers)."""
    import torch
    from sppark_tpu_torch import ntt
    from sppark_tpu_torch.ff.mont32 import get_mont32_ops
    from sppark_tpu_torch.ntt import fused, kernels as K
    from sppark_tpu_torch.ntt.parameters import get_parameters
    from sppark_tpu_torch.oracle import ntt as oracle
    from sppark_tpu_torch.params import get_field

    errs = dict.fromkeys(K.narrow_launches, 0)
    seconds = {}

    def agree(name, pairs, what):
        """Every (kernel, plain) pair equal, word for word; one line."""
        torch.cuda.synchronize()
        for k, (got, want) in enumerate(pairs):
            e = word_err((got,), (want,))
            errs[name] = max(errs[name], e)
            if e:
                raise RuntimeError(f"check failed: {name} == plain: {what} "
                                   f"(case {k}, max word error {e})")
        print(f"ok  {name} == plain: {what} ({len(pairs)} cases)",
              flush=True)

    def launched(what):
        counts = dict(K.narrow_launches)
        print(f"main path {what} launches: {counts}", flush=True)
        check(all(v > 0 for v in counts.values()),
              f"{what} went through both mont32 kernels")
        return counts

    rng = np.random.default_rng(7)

    # -- 20. kernels vs plain: every option, both generators, edge words ------
    t0 = time.perf_counter()
    for field in NARROW_FIELDS:
        pm = get_parameters(field, dev)
        for lg in NARROW_ROW_LGS:
            tw = pm.power_table(lg, False)
            pairs = []
            for shape in ((1, 1 << lg), (7, 1 << lg), (16, 1 << lg),
                          (3, 5, 1 << lg), (3, 16, 1 << lg)):
                x = narrow_words(field, rng, dev, *shape)
                mul = narrow_words(field, rng, dev, *shape)
                for in_rev in (False, True):
                    for out_rev in (False, True):
                        for out_t in (False, True):
                            for m in ((None,) if out_rev else (None, mul)):
                                a = (x, tw, lg, m, in_rev, out_rev, out_t)
                                pairs.append((K.mont32_rows(field, *a),
                                              K.mont32_rows_plain(field, *a)))
            agree("mont32_ntt_rows", pairs, f"{field} lg {lg}, (1, n), "
                  f"(7, n), (16, n), (3, 5, n), (3, 16, n), every option")
        for lg1 in NARROW_COL_LGS:
            tw = pm.power_table(lg1, True)
            pairs = []
            for m_cols in NARROW_COL_COUNTS:
                mid = narrow_words(field, rng, dev, 1 << lg1, m_cols)
                for batch in ((), (3,)):
                    x = narrow_words(field, rng, dev, *batch, 1 << lg1,
                                     m_cols)
                    for m in (None, mid):
                        pairs.append((K.mont32_cols(field, x, tw, lg1, m),
                                      K.mont32_cols_plain(field, x, tw, lg1,
                                                          m)))
            agree("mont32_ntt_cols", pairs, f"{field} lg1 {lg1}, M in "
                  f"{NARROW_COL_COUNTS}, batch, middle matrix")
    # the shapes the main paths give the kernels: the four-step at 2^20
    # and 2^24, forward and inverse tables, and the six-step at 2^26
    for lg, inverse in ((NARROW_CONFIG_LG, False), (NARROW_CONFIG_LG, True),
                        (NARROW_LG, False), (NARROW_LG, True),
                        (NARROW_LG + NARROW_BLOWUP, False)):
        tables = fused.fused_tables(NARROW_FIELD, lg, inverse, dev)
        lg1 = fused.split_lg1(lg, NARROW_FIELD)
        lg2 = lg - lg1
        x = narrow_words(NARROW_FIELD, rng, dev, 1 << lg1, 1 << lg2)
        agree("mont32_ntt_cols", [
            (K.mont32_cols(NARROW_FIELD, x, tables[0], lg1, tables[1]),
             K.mont32_cols_plain(NARROW_FIELD, x, tables[0], lg1,
                                 tables[1]))],
            f"main-path cols lg {lg} inverse={inverse} {tuple(x.shape)}")
        if lg2 <= fused.LG_TILE:
            agree("mont32_ntt_rows", [
                (K.mont32_rows(NARROW_FIELD, x, tables[2], lg2, out_t=True),
                 K.mont32_rows_plain(NARROW_FIELD, x, tables[2], lg2,
                                     out_t=True))],
                f"main-path rows lg {lg} inverse={inverse} out_t")
            continue
        lg21 = fused.split_lg1(lg2, NARROW_FIELD)
        xb = narrow_words(NARROW_FIELD, rng, dev, 1 << lg1, 1 << lg21,
                          1 << (lg2 - lg21))
        agree("mont32_ntt_cols", [
            (K.mont32_cols(NARROW_FIELD, xb, tables[2], lg21, tables[3]),
             K.mont32_cols_plain(NARROW_FIELD, xb, tables[2], lg21,
                                 tables[3]))],
            f"main-path six-step cols lg {lg} batch {tuple(xb.shape)}")
        agree("mont32_ntt_rows", [
            (K.mont32_rows(NARROW_FIELD, xb, tables[4], lg2 - lg21,
                           out_t=True),
             K.mont32_rows_plain(NARROW_FIELD, xb, tables[4], lg2 - lg21,
                                 out_t=True))],
            f"main-path six-step rows lg {lg} batch {tuple(xb.shape)}")
    # the trace LDE's shapes (phase 24): the inverse at 2^TRACE_LG and the
    # forward at 2^(TRACE_LG + blowup), each a four-step over all
    # TRACE_COLS columns with its own tables; the row pass takes the
    # column kernel's output, as the main path gives it
    for lg, inverse in ((TRACE_LG, True), (TRACE_LG + NARROW_BLOWUP, False)):
        tables = fused.fused_tables(NARROW_FIELD, lg, inverse, dev)
        lg1 = fused.split_lg1(lg, NARROW_FIELD)
        lg2 = lg - lg1
        check(lg2 <= fused.LG_TILE, f"trace LDE's 2^{lg} is a four-step")
        x = narrow_words(NARROW_FIELD, rng, dev, TRACE_COLS, 1 << lg1,
                         1 << lg2)
        c = K.mont32_cols(NARROW_FIELD, x, tables[0], lg1, tables[1])
        agree("mont32_ntt_cols", [
            (c, K.mont32_cols_plain(NARROW_FIELD, x, tables[0], lg1,
                                    tables[1]))],
            f"trace-LDE cols lg {lg} inverse={inverse} {tuple(x.shape)}")
        del x
        agree("mont32_ntt_rows", [
            (K.mont32_rows(NARROW_FIELD, c, tables[2], lg2, out_t=True),
             K.mont32_rows_plain(NARROW_FIELD, c, tables[2], lg2,
                                 out_t=True))],
            f"trace-LDE rows lg {lg} inverse={inverse} {tuple(c.shape)} "
            f"out_t")
        del c
    del xb, mul, mid
    seconds["20 kernels vs plain"] = time.perf_counter() - t0

    # -- 21. BASELINE config 1: BabyBear NTT 2^20 forward and inverse ----------
    t0 = time.perf_counter()
    main_rng = np.random.default_rng(2024)
    config1 = {}
    for field in NARROW_FIELDS:
        F = get_mont32_ops(field)
        fp = get_field(field)
        lg = NARROW_CONFIG_LG
        wire = main_rng.integers(0, fp.modulus, size=1 << lg,
                                 dtype=np.int64).astype(np.uint32)
        torch.cuda.synchronize()
        K.reset_launches()
        fwd_wire = ntt.ntt(field, wire, lg)
        back_wire = ntt.intt(field, fwd_wire, lg)
        config1[field] = launched(f"{field} NTT 2^{lg} forward + inverse "
                                  f"(ntt.ntt, ntt.intt)")
        check(fwd_wire.dtype == np.uint32 and fwd_wire.shape == wire.shape,
              f"{field} ntt.ntt 2^{lg} gives {fwd_wire.shape} u32 words")
        check(np.array_equal(back_wire, wire),
              f"{field} intt(ntt(x)) == x at 2^{lg}")
        x = F.from_wire_np(wire, dev)
        y = F.from_wire_np(fwd_wire, dev)
        check(torch.equal(y, fused.facade(field, x, lg, kern=K.PLAIN)),
              f"{field} NTT 2^{lg} == plain path on the card")
        check(torch.equal(F.from_wire_np(back_wire, dev),
                          fused.facade(field, y, lg, inverse=True,
                                       kern=K.PLAIN)),
              f"{field} iNTT 2^{lg} == plain path on the card")
        if field != NARROW_FIELD:
            continue
        config1_x = x
        for lg_o in NARROW_ORACLE_LGS:
            ints = F.to_int_list(x[:1 << lg_o])
            got = ntt.base_dev(field, x[:1 << lg_o].contiguous(), lg_o)
            check(F.to_int_list(got) == oracle.ntt_natural(fp, ints),
                  f"{field} NTT 2^{lg_o} == big-int oracle")
            back = ntt.base_dev(field, got, lg_o,
                                direction=ntt.Direction.inverse)
            check(F.to_int_list(back) == ints,
                  f"{field} intt round trip 2^{lg_o}")
        for lg_o in NARROW_ORDER_LGS:
            xs = narrow_words(field, main_rng, dev, 1 << lg_o)
            for order in ntt.InputOutputOrder:
                for inverse in (False, True):
                    for coset in (False, True):
                        got = ntt.base_dev(field, xs, lg_o, order,
                                           ntt.Direction(int(inverse)),
                                           ntt.Type(int(coset)))
                        want = fused.facade(field, xs, lg_o, order.value,
                                            inverse, coset, kern=K.PLAIN)
                        torch.cuda.synchronize()
                        check(torch.equal(got, want),
                              f"{field} 2^{lg_o} {order.value} "
                              f"inverse={inverse} coset={coset} == plain "
                              f"path")
    seconds["21 config 1"] = time.perf_counter() - t0

    # -- 22. BabyBear forward NTT 2^24 on device words (the four-step) ---------
    t0 = time.perf_counter()
    F = get_mont32_ops(NARROW_FIELD)
    fp = get_field(NARROW_FIELD)
    n = 1 << NARROW_LG
    x = narrow_words(NARROW_FIELD, main_rng, dev, n, planted=False)
    fused.fused_tables(NARROW_FIELD, NARROW_LG, False, dev)
    torch.cuda.synchronize()
    K.reset_launches()
    y = ntt.base_dev(NARROW_FIELD, x, NARROW_LG)
    torch.cuda.synchronize()
    ntt_launches = launched(f"NTT {NARROW_FIELD} 2^{NARROW_LG} (base_dev)")
    back = ntt.base_dev(NARROW_FIELD, y, NARROW_LG,
                        direction=ntt.Direction.inverse)
    check(torch.equal(back, x), f"intt(ntt(x)) == x at 2^{NARROW_LG}")
    del back
    w = fp.root_of_unity(NARROW_LG)
    for k in (int(v) for v in main_rng.integers(0, n, size=3)):
        got = F.to_int_list(y[k:k + 1])[0]
        check(got == eval_at(F, x, pow(w, k, fp.modulus), dev),
              f"NTT 2^{NARROW_LG} output {k} == sum_i x_i w^(ik) on the card")
    seconds["22 NTT 2^24"] = time.perf_counter() - t0

    # -- 23. BabyBear coset LDE 2^24 x 4 (the six-step at lg 26) ----------------
    t0 = time.perf_counter()
    lg, lg_ext = NARROW_LG, NARROW_LG + NARROW_BLOWUP
    torch.cuda.synchronize()
    K.reset_launches()
    ext = ntt.lde_dev(NARROW_FIELD, x, lg, NARROW_BLOWUP)
    torch.cuda.synchronize()
    lde_launches = launched(f"LDE {NARROW_FIELD} 2^{lg} x"
                            f"{1 << NARROW_BLOWUP} (lde_dev)")
    check(torch.equal(ext, fused.lde(NARROW_FIELD, x, lg, NARROW_BLOWUP,
                                     kern=K.PLAIN)),
          f"LDE 2^{lg} x{1 << NARROW_BLOWUP} == plain path on the card")
    inv = ntt.base_dev(NARROW_FIELD, ext, lg_ext,
                       direction=ntt.Direction.inverse,
                       ntt_type=ntt.Type.coset)
    check(bool((inv[n:] == 0).all()), f"LDE: coefficients above 2^{lg} "
                                      f"are 0")
    check(torch.equal(ntt.base_dev(NARROW_FIELD, inv[:n].contiguous(), lg),
                      x), "LDE: inverse coset transform gives back x")
    del inv, ext
    ints = F.to_int_list(x[:1 << 10])
    got = ntt.lde_dev(NARROW_FIELD, x[:1 << 10].contiguous(), 10, 1)
    check(F.to_int_list(got) == oracle.lde(fp, ints, 1),
          "LDE 2^10 x2 == big-int oracle")
    seconds["23 LDE 2^24"] = time.perf_counter() - t0

    # -- 24. the batched trace LDE: (64, 2^20) columns x 4 ----------------------
    t0 = time.perf_counter()
    trace = narrow_words(NARROW_FIELD, main_rng, dev, TRACE_COLS,
                         1 << TRACE_LG, planted=False)
    torch.cuda.synchronize()
    K.reset_launches()
    text = ntt.lde_dev(NARROW_FIELD, trace, TRACE_LG, NARROW_BLOWUP)
    torch.cuda.synchronize()
    trace_launches = launched(f"trace LDE {NARROW_FIELD} ({TRACE_COLS}, "
                              f"2^{TRACE_LG}) x{1 << NARROW_BLOWUP}")
    check(text.shape == (TRACE_COLS, 1 << (TRACE_LG + NARROW_BLOWUP)),
          f"trace LDE gives {tuple(text.shape)} words "
          f"({text.numel() * 4 / 2**30:.2f} GiB)")
    cols = [0, TRACE_COLS - 1]
    for c in cols:
        check(torch.equal(text[c], ntt.lde_dev(NARROW_FIELD, trace[c],
                                               TRACE_LG, NARROW_BLOWUP)),
              f"trace LDE column {c} == the single-column LDE")
    check(torch.equal(text, fused.lde(NARROW_FIELD, trace, TRACE_LG,
                                      NARROW_BLOWUP, kern=K.PLAIN)),
          f"trace LDE, all {TRACE_COLS} columns, == plain path on the card")
    del text
    seconds["24 trace LDE"] = time.perf_counter() - t0

    # -- 25. times -------------------------------------------------------------------
    t0 = time.perf_counter()
    lg20 = NARROW_CONFIG_LG
    t_pair = median_ms(lambda: ntt.base_dev(
        NARROW_FIELD, ntt.base_dev(NARROW_FIELD, config1_x, lg20), lg20,
        direction=ntt.Direction.inverse), reps=20, warmup=2)
    wire20 = F.to_wire_np(config1_x)
    t_pair_host = wall_ms(lambda: ntt.intt(NARROW_FIELD, ntt.ntt(
        NARROW_FIELD, wire20, lg20), lg20), reps=5)
    bfly20 = (1 << (lg20 - 1)) * lg20
    print(f"time NTT {NARROW_FIELD} 2^{lg20} forward + inverse: {t_pair:.4f} "
          f"ms on device words (median of 20, CUDA events), "
          f"{2 * bfly20 / (t_pair * 1e-3):.4e} butterflies/s; "
          f"{t_pair_host:.4f} ms through ntt.ntt + ntt.intt on host arrays "
          f"(median of 5, wall clock)  [{card}]", flush=True)
    state = [x]

    def ntt_step():
        state[0] = ntt.base_dev(NARROW_FIELD, state[0], NARROW_LG)

    t_ntt = median_ms(ntt_step, reps=20, warmup=2)
    bfly = (n // 2) * NARROW_LG
    print(f"time NTT {NARROW_FIELD} 2^{NARROW_LG} forward (dependent "
          f"chain): {t_ntt:.4f} ms, {bfly / (t_ntt * 1e-3):.4e} "
          f"butterflies/s  [{card}]", flush=True)
    del state
    t_lde = median_ms(lambda: ntt.lde_dev(NARROW_FIELD, x, lg,
                                          NARROW_BLOWUP), reps=5)
    bfly_lde = (1 << (lg - 1)) * lg + (1 << (lg_ext - 1)) * lg_ext
    print(f"time LDE {NARROW_FIELD} 2^{lg} x{1 << NARROW_BLOWUP}: "
          f"{t_lde:.4f} ms (median of 5), {bfly_lde / (t_lde * 1e-3):.4e} "
          f"butterflies/s  [{card}]", flush=True)
    shift = get_parameters(NARROW_FIELD, dev).coset_powers(lg_ext, False)
    coeffs = ntt.base_dev(NARROW_FIELD, x, lg,
                          direction=ntt.Direction.inverse)
    pad = torch.zeros((1 << lg_ext) - n, dtype=torch.int32, device=dev)
    ext = F.mul(torch.cat([coeffs, pad]), shift)
    parts = {
        f"inverse NTT 2^{lg}": median_ms(lambda: ntt.base_dev(
            NARROW_FIELD, x, lg, direction=ntt.Direction.inverse), reps=5),
        "pad + coset shift (plain)": median_ms(
            lambda: F.mul(torch.cat([coeffs, pad]), shift), reps=5),
        f"forward NTT 2^{lg_ext}": median_ms(
            lambda: ntt.base_dev(NARROW_FIELD, ext, lg_ext), reps=5),
    }
    print("time LDE parts: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in parts.items()) + f"  [{card}]",
        flush=True)
    del coeffs, pad, ext
    t_trace = median_ms(lambda: ntt.lde_dev(NARROW_FIELD, trace, TRACE_LG,
                                            NARROW_BLOWUP), reps=5)
    tl_ext = TRACE_LG + NARROW_BLOWUP
    bfly_trace = TRACE_COLS * ((1 << (TRACE_LG - 1)) * TRACE_LG
                               + (1 << (tl_ext - 1)) * tl_ext)
    print(f"time trace LDE {NARROW_FIELD} ({TRACE_COLS}, 2^{TRACE_LG}) "
          f"x{1 << NARROW_BLOWUP}: {t_trace:.4f} ms (median of 5), "
          f"{bfly_trace / (t_trace * 1e-3):.4e} butterflies/s  [{card}]",
          flush=True)
    tshift = get_parameters(NARROW_FIELD, dev).coset_powers(tl_ext, False)
    coeffs = ntt.base_dev(NARROW_FIELD, trace, TRACE_LG,
                          direction=ntt.Direction.inverse)
    pad = torch.zeros((TRACE_COLS, (1 << tl_ext) - (1 << TRACE_LG)),
                      dtype=torch.int32, device=dev)
    ext = F.mul(torch.cat([coeffs, pad], -1), tshift)
    trace_parts = {
        f"inverse NTT ({TRACE_COLS}, 2^{TRACE_LG})": median_ms(
            lambda: ntt.base_dev(NARROW_FIELD, trace, TRACE_LG,
                                 direction=ntt.Direction.inverse), reps=5),
        "pad + coset shift (plain)": median_ms(
            lambda: F.mul(torch.cat([coeffs, pad], -1), tshift), reps=5),
        f"forward NTT ({TRACE_COLS}, 2^{tl_ext})": median_ms(
            lambda: ntt.base_dev(NARROW_FIELD, ext, tl_ext), reps=5),
    }
    print("time trace LDE parts: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in trace_parts.items()) + f"  [{card}]",
        flush=True)
    del coeffs, pad, ext, trace

    # each kernel alone at the forward NTT 2^24 shapes
    tw1, mid, tw2 = fused.fused_tables(NARROW_FIELD, NARROW_LG, False, dev)
    lg1 = fused.split_lg1(NARROW_LG, NARROW_FIELD)
    lg2 = NARROW_LG - lg1
    xm = x.reshape(1 << lg1, 1 << lg2)
    cases = [
        ("mont32_ntt_cols", tuple(xm.shape),
         lambda: K.mont32_cols(NARROW_FIELD, xm, tw1, lg1, mid),
         lambda: K.mont32_cols_plain(NARROW_FIELD, xm, tw1, lg1, mid),
         WORD32 * (3 * n + tw1.numel()),
         transform_ops(lg1, n >> lg1, OPS_PER_MUL_MONT32,
                       OPS_ADD_SUB_MONT32) + OPS_PER_MUL_MONT32 * n),
        ("mont32_ntt_rows", tuple(xm.shape),
         lambda: K.mont32_rows(NARROW_FIELD, xm, tw2, lg2, out_t=True),
         lambda: K.mont32_rows_plain(NARROW_FIELD, xm, tw2, lg2, out_t=True),
         WORD32 * (2 * n + tw2.numel()),
         transform_ops(lg2, n >> lg2, OPS_PER_MUL_MONT32,
                       OPS_ADD_SUB_MONT32)),
    ]
    timing = {}
    regs = ptxas_summary(build_log)
    for name, shape, kfn, pfn, nbytes, ops in cases:
        ms = median_ms(kfn, reps=20)
        pms = median_ms(pfn, reps=3)
        b, by = bound(nbytes, ops, rate)
        timing[name] = (ms, pms, b, by)
        kern = name.split("_")[-1] + "_kernel"
        print(f"time {name} at {shape}: {ms:.4f} ms (median of 20; plain "
              f"{pms:.4f} ms, median of 3), bound {b:.4f} ms by {by}, "
              f"{b / ms:.3f} of bound; "
              f"{regs.get(kern, 'registers: not rebuilt in this run')}  "
              f"[{card}]", flush=True)
    del xm, x, y
    seconds["25 times"] = time.perf_counter() - t0
    print("narrow phases' seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()), flush=True)

    main_runs = [*config1.values(), ntt_launches, lde_launches,
                 trace_launches]
    launches = {k: sum(r[k] for r in main_runs) for k in errs}
    numbers = {"narrow_config1_pair_ms": t_pair,
               "narrow_config1_pair_host_ms": t_pair_host,
               "narrow_ntt_ms": t_ntt, "narrow_lde_ms": t_lde,
               "narrow_lde_parts_ms": parts, "narrow_trace_lde_ms": t_trace,
               "narrow_trace_lde_parts_ms": trace_parts,
               "narrow_config1_launches": config1,
               "narrow_ntt_launches": ntt_launches,
               "narrow_lde_launches": lde_launches,
               "narrow_trace_lde_launches": trace_launches,
               "narrow_phase_seconds": seconds}
    replaces = {"mont32_ntt_rows": "sppark_tpu/ntt/pallas_kernels.py:206",
                "mont32_ntt_cols": "sppark_tpu/ntt/pallas_kernels.py:319"}
    entries = []
    for name, rep in replaces.items():
        ms, pms, b, by = timing[name]
        entries.append({"name": name, "route": "cuda",
                        "source": "sppark_tpu_torch/csrc/ntt_mont32.cu",
                        "replaces": rep, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": ms, "plain_ms": pms,
                        "bound_ms": b, "bound_by": by, "library_ms": None})
    return entries, numbers


# -- MSM round modes (26-27) ------------------------------------------------------

ROUND_LG = 20           # mode "affine"'s main paths and batch_addition
ROUND_EQUAL_LG = 12     # all-equal scalars: rounds = n


def round_phases(dev, card, rate, g1, g2):
    """Phases 26-27: the MSM modes "xyzz" and "affine" (MSMRoundStages)
    and batch_addition through the entry points, each path with the
    launch counts set to 0 just before and read just after.  `g1`, `g2`:
    the G1 and G2 main paths' (base points, exact result[, exact function
    of the words]).  Returns (the phases' numbers, the paths' launches
    summed by kernel)."""
    import torch
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.msm import MSMContext, batch_addition
    from sppark_tpu_torch.oracle.ec import get_oracle
    from sppark_tpu_torch.oracle.msm import msm_naive
    from sppark_tpu_torch.params import get_curve

    numbers, seconds, total = {}, {}, {}

    def path(key, curve, lg, launches, ctx, wd):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        t_msm, peak, _, busy, t_prof, phases, by_kernel = msm_times(
            ctx, wd, curve, lg, card)
        numbers.update({f"{key}_msm_ms": t_msm, f"{key}_peak_gib": peak,
                        f"{key}_device_busy_ms": busy,
                        f"{key}_profiled_wall_ms": t_prof,
                        f"{key}_phases_device_host_ms": phases,
                        f"{key}_kernels_ms_launches": by_kernel,
                        f"{key}_launches": launches})

    # -- 26. mode xyzz: G1 2^24 on phase 7's input, G2 2^23 on phase 15's ---
    base, want = g1
    base2, want2, exact2 = g2
    for mode, lgs in (("xyzz", (MSM_LG, G2_LG)), ("affine", (ROUND_LG,) * 2)):
        # -- 27. mode affine at 2^20: the tiled G1 and G2 inputs ------------
        for curve, lg, b, exact, small, full in (
                (MSM_CURVE, lgs[0], base,
                 (lambda w: want) if lgs[0] == MSM_LG else None, LG_SMALL,
                 True),
                (G2_CURVE, lgs[1], base2, (lambda w: want2)
                 if lgs[1] == G2_LG else exact2, LG_SMALL_G2, False)):
            t0 = time.perf_counter()
            ctx, wd, launches, _, _ = msm_main(
                curve, lg, dev, full=full, base=b, exact=exact,
                lg_small=small, mode=mode)
            op = "xyzz_madd" if mode == "xyzz" else "pair_prep"
            print(f"MSM {curve} 2^{lg} mode {mode}: rounds "
                  f"{ctx.stages.schedule(wd)[-1]}, {EK.kernel_name(op, curve)}"
                  f" launches {launches[EK.kernel_name(op, curve)]}",
                  flush=True)
            key = f"{mode}_{'g1' if curve == MSM_CURVE else 'g2'}"
            path(key, curve, lg, launches, ctx, wd)
            del ctx, wd
            torch.cuda.empty_cache()
            seconds[f"{key} 2^{lg}"] = time.perf_counter() - t0

    # all-equal scalars: 8 points tiled to 2^12, one bucket a window holds
    # every point
    t0 = time.perf_counter()
    cp = get_curve(MSM_CURVE)
    r = cp.scalar.modulus
    n = 1 << ROUND_EQUAL_LG
    pts = [base[i % 8] for i in range(n)]
    pts[3] = get_oracle(cp).infinity_affine()
    k = random.Random(26).randrange(r)
    want_eq = msm_naive(cp, base[:8], [k * (n // 8 - (j == 3)) % r
                                       for j in range(8)])
    for mode in ("xyzz", "affine"):
        ctx = MSMContext(MSM_CURVE, n, mode=mode)
        ctx.set_points(pts)
        wd = scalar_words([k] * n, ctx.n_words, dev)
        rounds = ctx.stages.schedule(wd)[-1]
        check(rounds == n, f"MSM {MSM_CURVE} 2^{ROUND_EQUAL_LG} mode {mode}, "
                           f"all-equal scalars: rounds {rounds} == n")
        check(ctx.invoke(wd) == want_eq,
              f"MSM {MSM_CURVE} 2^{ROUND_EQUAL_LG} mode {mode}, all-equal "
              f"scalars == msm_naive")
        ms = wall_ms(lambda: ctx.invoke(wd), reps=1)
        numbers[f"{mode}_all_equal_2^{ROUND_EQUAL_LG}_ms"] = ms
        print(f"time MSM {MSM_CURVE} 2^{ROUND_EQUAL_LG} mode {mode}, all-"
              f"equal scalars ({rounds} rounds): {ms:.4f} ms (wall)  "
              f"[{card}]", flush=True)
    seconds["all-equal"] = time.perf_counter() - t0

    # batch_addition at 2^20: a seeded bitmap and refmap over the tiled
    # G1 input, against the oracle sum of the base with each point's signed
    # selections summed; the empty selection
    t0 = time.perf_counter()
    n = 1 << ROUND_LG
    _, (px, py), _, _ = msm_input(MSM_CURVE, ROUND_LG, dev, base)
    g = np.random.default_rng(27)
    bits = g.integers(0, 2, size=n)
    refs = g.integers(0, 2, size=n)
    coef = bits * (1 - 2 * refs)
    coef[3] = 0                                     # the infinity
    nb = len(base)
    sums = [int(s) % r for s in coef.reshape(-1, nb).sum(axis=0)]
    want_ba = msm_naive(cp, base, sums)
    reset_all()
    got = batch_addition(MSM_CURVE, (px, py), bits, refs)
    torch.cuda.synchronize()
    ba_launches = {k: v for k, v in {**EK.launches, **FK.launches}.items()
                   if v}
    check(got == want_ba, f"batch_addition {MSM_CURVE} 2^{ROUND_LG} with a "
                          f"seeded bitmap and refmap == the oracle sum")
    check(ba_launches.get("ec_xyzz_madd", 0) > 0
          and ba_launches.get("ec_xyzz_add", 0) > 0,
          f"batch_addition {MSM_CURVE} 2^{ROUND_LG} went through the madd "
          f"and the add")
    for kname, v in ba_launches.items():
        total[kname] = total.get(kname, 0) + v
    check(batch_addition(MSM_CURVE, (px, py), np.zeros(n, np.int64)).inf,
          f"batch_addition {MSM_CURVE} 2^{ROUND_LG}, the empty selection "
          f"== infinity")
    ms = wall_ms(lambda: batch_addition(MSM_CURVE, (px, py), bits, refs),
                 reps=3)
    numbers["batch_addition_ms"] = ms
    numbers["batch_addition_launches"] = ba_launches
    print(f"time batch_addition {MSM_CURVE} 2^{ROUND_LG}: {ms:.4f} ms "
          f"(median of 3, wall); launches {ba_launches}  [{card}]",
          flush=True)
    del px, py
    seconds["batch_addition"] = time.perf_counter() - t0
    numbers["round_phase_seconds"] = seconds
    print(f"round phases' seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()), flush=True)
    return numbers, total


# -- phases 28-31: polynomial, the sharded NTT and MSM, the tail ------------

POLY_FIELDS = ("goldilocks", "baby_bear", "bls12_381_fr")
POLY_LG = 24            # prefix_sum, prefix_product, div_by_x_minus_z
POLY_EVAL_LG = 20       # evaluate: 2^20 coefficients ...
POLY_POINTS = 8         # ... at 8 points
POLY_PLAIN_LG = 16      # word for word against the plain path
POLY_SAMPLES = 1024     # sampled prefix positions against Python ints
POLY_ANCHOR = 4096      # the first prefixes against Python ints
POLY_HORNER_LG = 12     # evaluate against Horner on a 2^12 slice
SHARD_NTT = (("goldilocks", 24), ("bn254_fr", 26))  # BASELINE config 5
SHARD_MSM_CURVE, SHARD_MSM_LG = "bn254", 26         # its MSM, one rank
TAIL_LG = 12            # scalar_mul, the jacobian ops, the madd's sign
TAIL_BASE = 16          # distinct points of the tail's batch, tiled
CPU_MSM_LG = 16         # the host ffi.native.cpu_msm


def field_words(field, n, rng, dev):
    """n random canonical words of `field` in its layout: Goldilocks int64,
    BabyBear int32 Montgomery, a wide field's (n32, n) Montgomery words
    (rand_canon's, the planted edge values in lanes 0-3 drawn anew: a zero
    there would zero every prefix product)."""
    import torch
    from sppark_tpu_torch.ff import gl64
    from sppark_tpu_torch.ff.bigmont import get_field_ops
    from sppark_tpu_torch.ntt.core import elem_ops
    from sppark_tpu_torch.params import get_field

    p = get_field(field).modulus
    if elem_ops(field).lead:
        F = get_field_ops(field)
        w = rand_canon(F, n, rng, dev)
        w[:, :4] = rand_canon(F, 8, rng, dev)[:, 4:]
        return w
    if p == gl64.P:
        return gl64.from_wire(rng.integers(0, p, size=n, dtype=np.uint64),
                              dev)
    return torch.from_numpy(rng.integers(0, p, size=n).astype(np.int32)
                            ).to(dev)


def field_conv(field):
    """(to_ints(tensor), from_ints(ints, dev), sub) of a field's words."""
    from sppark_tpu_torch.ff import gl64
    from sppark_tpu_torch.ff.bigmont import get_field_ops
    from sppark_tpu_torch.ff.mont32 import get_mont32_ops
    from sppark_tpu_torch.params import get_field

    if get_field(field).modulus == gl64.P:
        return gl64.to_ints, gl64.from_ints, gl64.sub
    F = (get_mont32_ops(field) if get_field(field).bits <= 32
         else get_field_ops(field))
    return (F.to_int_list,
            lambda v, dev: F.from_int_list(v, device=dev), F.sub)


def poly_phase(field, dev, card, rng):
    """Phase 28 on one field: the main path (each op's bigmont_ew launches
    counted around it), its checks and its times.  Returns (numbers,
    the ops' launches summed by kernel)."""
    import torch
    from sppark_tpu_torch import polynomial as P
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.ntt.core import elem_ops
    from sppark_tpu_torch.params import get_field

    F = elem_ops(field)
    lead = F.lead
    ints, from_ints, sub = field_conv(field)
    p = get_field(field).modulus
    n, ne = 1 << POLY_LG, 1 << POLY_EVAL_LG
    x = field_words(field, n, rng, dev)
    zt_i = [int(v) for v in rng.integers(1, 1 << 62, size=2)]
    zt = from_ints(zt_i, dev)
    z, t = zt[..., :1], zt[..., 1:]
    xs = field_words(field, POLY_POINTS, rng, dev)
    c = x[..., :ne]
    ops = {
        "prefix_sum": lambda kern=FK.KERNELS: P.prefix_sum(field, x, kern),
        "prefix_product": lambda kern=FK.KERNELS: P.prefix_product(
            field, x, kern),
        "div_by_x_minus_z": lambda kern=FK.KERNELS: P.div_by_x_minus_z(
            field, x, z, kern=kern),
        "div_by_x_minus_z rotate": lambda kern=FK.KERNELS:
            P.div_by_x_minus_z(field, x, z, True, kern),
        "evaluate": lambda kern=FK.KERNELS: P.evaluate(field, c, xs, kern),
    }
    out, launches, total = {}, {}, {}
    torch.cuda.synchronize()
    for name, op in ops.items():
        reset_all()
        out[name] = op()
        torch.cuda.synchronize()
        launches[name] = FK.launches["bigmont_ew"]
        for k, v in FK.launches.items():
            total[k] = total.get(k, 0) + v
    tag = f"{field} 2^{POLY_LG}"
    if lead:
        check(all(v > 0 for k, v in launches.items() if k != "prefix_sum"),
              f"polynomial {tag}: every op that multiplies launched "
              f"bigmont_ew {launches}")
    ps, pp = out["prefix_sum"], out["prefix_product"]
    q, r = out["div_by_x_minus_z"]
    rot, ev = out["div_by_x_minus_z rotate"], out["evaluate"]

    # 2^16: word for word against the plain path on the card
    m = 1 << POLY_PLAIN_LG
    xm, cm = x[..., :m], x[..., :m]
    for name, got, want in (
            ("prefix_sum", P.prefix_sum(field, xm),
             P.prefix_sum(field, xm, FK.PLAIN)),
            ("prefix_product", P.prefix_product(field, xm),
             P.prefix_product(field, xm, FK.PLAIN)),
            ("div rotate", P.div_by_x_minus_z(field, xm, z, True),
             P.div_by_x_minus_z(field, xm, z, True, FK.PLAIN)),
            ("evaluate", P.evaluate(field, cm, xs),
             P.evaluate(field, cm, xs, FK.PLAIN))):
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"polynomial {field} 2^{POLY_PLAIN_LG}"
                                      f" {name} == the plain path on the card")

    # the whole scans by their recurrences, on the card
    check(torch.equal(sub(ps[..., 1:], ps[..., :-1]), x[..., 1:])
          and torch.equal(ps[..., :1], x[..., :1]),
          f"prefix_sum {tag}: s[i] - s[i - 1] == x[i] at every i")
    check(torch.equal(F.mul(pp[..., :-1], x[..., 1:]), pp[..., 1:])
          and torch.equal(pp[..., :1], x[..., :1]),
          f"prefix_product {tag}: m[i - 1] x[i] == m[i] at every i")
    # sampled positions and the first prefixes against Python ints
    pos = np.sort(rng.choice(n - 1, POLY_SAMPLES, replace=False)) + 1
    idx = torch.from_numpy(np.concatenate([pos - 1, pos])).to(dev)
    xi = ints(x.index_select(-1, idx[POLY_SAMPLES:]))
    si, mi = (ints(a.index_select(-1, idx)) for a in (ps, pp))
    k = POLY_SAMPLES
    check(all(si[k + j] == (si[j] + xi[j]) % p
              and mi[k + j] == mi[j] * xi[j] % p for j in range(k)),
          f"prefix scans {tag}: {k} sampled positions against Python ints")
    acc_s, acc_m, ok = 0, 1, True
    head = ints(x[..., :POLY_ANCHOR])
    hs, hm = ints(ps[..., :POLY_ANCHOR]), ints(pp[..., :POLY_ANCHOR])
    for j, v in enumerate(head):
        acc_s, acc_m = (acc_s + v) % p, acc_m * v % p
        ok = ok and hs[j] == acc_s and hm[j] == acc_m
    check(ok, f"prefix scans {tag}: the first {POLY_ANCHOR} against "
              f"Python ints")

    # the division: the layouts, r == p(z), q(t)(t - z) + r == p(t)
    check(torch.equal(rot, torch.cat([r, q[..., :-1]], dim=-1))
          and bool((q[..., -1:] == 0).all()),
          f"div_by_x_minus_z {tag}: rotate == [r, q...], q's top word 0")
    pz = P.evaluate(field, x, z)
    check(torch.equal(pz, r), f"div_by_x_minus_z {tag}: remainder == "
                              f"evaluate(p, z)")
    pt, qt = ints(P.evaluate(field, x, t))[0], ints(P.evaluate(field, q,
                                                               t))[0]
    zi, ti, ri = zt_i[0] % p, zt_i[1] % p, ints(r)[0]
    check((qt * (ti - zi) + ri) % p == pt,
          f"div_by_x_minus_z {tag}: q(t) (t - z) + r == p(t) at a random t")

    # evaluate: the halves' identity at 2^20, Horner on a 2^12 slice
    half = ne // 2
    lo = ints(P.evaluate(field, c[..., :half], xs))
    hi = ints(P.evaluate(field, c[..., half:], xs))
    pts = ints(xs)
    check(ints(ev) == [(a + pow(v, half, p) * b) % p
                       for a, b, v in zip(lo, hi, pts)],
          f"evaluate {field} 2^{POLY_EVAL_LG} at {POLY_POINTS} points == "
          f"p_lo(x) + x^{half} p_hi(x)")
    sl = ints(c[..., :1 << POLY_HORNER_LG])
    want = []
    for v in pts:
        acc = 0
        for coef in reversed(sl):
            acc = (acc * v + coef) % p
        want.append(acc)
    check(ints(P.evaluate(field, c[..., :1 << POLY_HORNER_LG], xs)) == want,
          f"evaluate {field} 2^{POLY_HORNER_LG} slice == Horner over ints")
    del pz, ps, pp, q, r, rot, out
    numbers = {}
    for name, op in ops.items():
        ms = median_ms(op, reps=3)
        numbers[name] = {"ms": ms, "bigmont_ew": launches[name]}
        size = (f"2^{POLY_EVAL_LG} x {POLY_POINTS} points"
                if name == "evaluate" else f"2^{POLY_LG}")
        print(f"time {name} {field} {size}: {ms:.4f} ms (median of 3, CUDA "
              f"events), bigmont_ew launches {launches[name]}  [{card}]",
              flush=True)
    return numbers, total


def read_counts():
    """Every launch count of the port's kernels, the nonzero ones."""
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.ntt import kernels as K
    return {k: v for k, v in {**K.launches, **K.narrow_launches,
                              **K.wide_launches, **EK.launches,
                              **EK.fp2_launches, **FK.launches}.items() if v}


def reset_counts():
    from sppark_tpu_torch.ntt import kernels as K
    reset_all()
    K.reset_launches()


def sharded_ntt_phase(mesh, dev, card, rng):
    """Phase 29: config 5's NTTs on a group of one, ntt_sharded and
    ntt_matrix_sharded, forward and inverse, against the port's ntt.
    Returns (numbers, launches)."""
    import torch
    from sppark_tpu_torch import ntt
    from sppark_tpu_torch.parallel import ntt_matrix_sharded, ntt_sharded

    numbers, total = {}, {}
    for field, lg in SHARD_NTT:
        n = 1 << lg
        n1, n2 = 1 << (lg // 2), 1 << (lg - lg // 2)
        x = field_words(field, n, rng, dev)
        a = x.reshape(x.shape[:-1] + (n1, n2))
        torch.cuda.synchronize()
        reset_counts()
        fwd = ntt_sharded(field, x, lg, mesh)
        back = ntt_sharded(field, fwd, lg, mesh, inverse=True)
        mat = ntt_matrix_sharded(field, a, lg, mesh)
        mat_inv = ntt_matrix_sharded(field, a, lg, mesh, inverse=True)
        torch.cuda.synchronize()
        launches = read_counts()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        print(f"main path sharded NTT {field} 2^{lg} (group of one) "
              f"launches: {launches}", flush=True)
        check(any(k.endswith("_ntt_rows") for k in launches)
              and any(k.endswith("_ntt_cols") for k in launches),
              f"sharded NTT {field} 2^{lg} went through the row and column "
              f"kernels")
        want = ntt.base_dev(field, x, lg)
        check(torch.equal(fwd, want), f"ntt_sharded {field} 2^{lg} == "
                                      f"ntt.base_dev, word for word")
        check(torch.equal(back, x), f"ntt_sharded inverse {field} 2^{lg} "
                                    f"gives back x")
        t_want = want.reshape(want.shape[:-1] + (n2, n1)).transpose(-1, -2)
        check(torch.equal(mat, t_want), f"ntt_matrix_sharded {field} 2^{lg}"
                                        f" == D[k1, k2] = X[k1 + N1 k2]")
        del want, t_want, back
        inv = ntt.base_dev(field, x, lg, direction=ntt.Direction.inverse)
        check(torch.equal(mat_inv, inv.reshape(
            inv.shape[:-1] + (n2, n1)).transpose(-1, -2)),
            f"ntt_matrix_sharded inverse {field} 2^{lg} == the single "
            f"device's inverse, transposed")
        del inv, fwd, mat, mat_inv
        times = {
            "ntt_sharded": median_ms(lambda: ntt_sharded(
                field, x, lg, mesh), reps=5),
            "ntt_sharded inverse": median_ms(lambda: ntt_sharded(
                field, x, lg, mesh, inverse=True), reps=5),
            "ntt_matrix_sharded": median_ms(lambda: ntt_matrix_sharded(
                field, a, lg, mesh), reps=5),
            "ntt_matrix_sharded inverse": median_ms(
                lambda: ntt_matrix_sharded(field, a, lg, mesh, inverse=True),
                reps=5),
            "ntt.base_dev (single device)": median_ms(
                lambda: ntt.base_dev(field, x, lg), reps=5)}
        print(f"time sharded NTT {field} 2^{lg} (group of one): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in times.items())
            + f" (median of 5, CUDA events)  [{card}]", flush=True)
        numbers[f"{field}_2^{lg}"] = {"ms": times, "launches": launches}
        del x, a
        torch.cuda.empty_cache()
    return numbers, total


def sharded_msm_phase(mesh, dev, card):
    """Phase 30: config 5's MSM on the group of one, against the exact
    result and MSMContext(mode="xyzz").  Returns (numbers, launches)."""
    import torch
    from sppark_tpu_torch.msm import MSMContext
    from sppark_tpu_torch.parallel import msm_sharded

    curve, lg = SHARD_MSM_CURVE, SHARD_MSM_LG
    n = 1 << lg
    t0 = time.perf_counter()
    base, pts, words, wd = msm_input(curve, lg, dev)
    print(f"{curve} 2^{lg}: input made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    reset_counts()
    got = msm_sharded(curve, pts, wd, mesh)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"main path sharded MSM {curve} 2^{lg} (group of one) launches: "
          f"{launches}; peak device memory {peak:.3f} GiB, {resident:.3f} "
          f"GiB of it the input  [{card}]", flush=True)
    check(all(launches.get(k, 0) > 0 for k in (
        "ec_xyzz_madd", "ec_xyzz_add", "ec_xyzz_dbl", "bigmont_ew")),
        f"sharded MSM {curve} 2^{lg} went through madd, add, dbl and the "
        f"Montgomery multiply")
    t0 = time.perf_counter()
    want = tiled_oracle(curve, base, words)
    check(got == want, f"msm_sharded {curve} 2^{lg} == exact oracle over all "
                       f"2^{lg} terms ({time.perf_counter() - t0:.1f} s)")
    ms = wall_ms(lambda: msm_sharded(curve, pts, wd, mesh), reps=2)
    ctx = MSMContext(curve, n, mode="xyzz")
    ctx.set_points(pts)
    check(ctx.invoke(wd) == got, f"msm_sharded {curve} 2^{lg} == "
                                 f"MSMContext(mode='xyzz')")
    ms_ctx = wall_ms(lambda: ctx.invoke(wd), reps=2)
    print(f"time MSM {curve} 2^{lg}: msm_sharded (group of one) {ms:.4f} ms, "
          f"MSMContext(mode='xyzz') {ms_ctx:.4f} ms (median of 2, wall)  "
          f"[{card}]", flush=True)
    del ctx, pts, wd
    torch.cuda.empty_cache()
    return {"lg": lg, "ms": ms, "context_xyzz_ms": ms_ctx, "peak_gib": peak,
            "input_gib": resident, "launches": launches}, launches


def tail_phase(dev, card):
    """Phase 31: scalar_mul and the jacobian ops on BLS12-381 G1 and G2,
    the madd's sign, the host cpu_msm.  Returns (numbers, launches)."""
    import torch
    from sppark_tpu_torch.ec import get_curve_ops
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ffi import cpu_msm
    from sppark_tpu_torch.msm import MSMContext
    from sppark_tpu_torch.oracle.ec import get_oracle
    from sppark_tpu_torch.params import get_curve

    numbers, total = {}, {}
    n = 1 << TAIL_LG
    for curve in (MSM_CURVE, G2_CURVE):
        cp = get_curve(curve)
        o = get_oracle(cp)
        rng = random.Random(31)
        base = [o.random_point(rng) for _ in range(TAIL_BASE)]
        pts = [base[i % TAIL_BASE] for i in range(n)]
        pts[3] = o.infinity_affine()
        ops = get_curve_ops(curve)
        a = ops.affine_from_ints(pts, dev)
        # G2's plain fp2 additions make its chain host-bound (~45 s for a
        # 255-bit k): a 64-bit k there
        k = rng.randrange(cp.scalar.modulus) if cp.degree == 1 else \
            rng.randrange(1 << 63, 1 << 64)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        km = ops.xyzz_to_affine(ops.scalar_mul(a, k))
        j = ops.affine_to_jacobian(a)
        j3 = ops.jacobian_to_affine(ops.jacobian_add(j, ops.jacobian_dbl(j)))
        x2 = ops.jacobian_to_affine(ops.xyzz_to_jacobian(
            ops.xyzz_dbl(ops.affine_to_xyzz(a))))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        for kname, v in launches.items():
            total[kname] = total.get(kname, 0) + v
        check(launches.get("bigmont_ew", 0) > 0,
              f"scalar_mul and the jacobian ops {curve} went through "
              f"bigmont_ew ({launches})")
        z = (o.zero, o.zero)

        def aff(q):
            return z if q.inf else (q.x, q.y)
        want = {i: (aff(o.jacobian_to_affine(o.scalar_mul(b, k))),
                    aff(o.jacobian_to_affine(o.scalar_mul(b, 3))),
                    aff(o.jacobian_to_affine(o.scalar_mul(b, 2))))
                for i, b in enumerate(base)}
        got = list(zip(ops.affine_to_ints(km), ops.affine_to_ints(j3),
                       ops.affine_to_ints(x2)))
        check(all(got[i] == ((z,) * 3 if i == 3 else want[i % TAIL_BASE])
                  for i in range(n)),
              f"scalar_mul, jacobian_add(P, jacobian_dbl(P)) and "
              f"xyzz_to_jacobian {curve} 2^{TAIL_LG} == oracle on every lane")
        print(f"time scalar_mul ({k.bit_length()}-bit k) + jacobian ops "
              f"{curve} 2^{TAIL_LG}: {ms:.4f} ms (wall, one run), launches "
              f"{launches}  [{card}]", flush=True)
        # the madd's sign: per lane and through a table with its index
        p = ops.xyzz_dbl(ops.affine_to_xyzz(ops.affine_from_ints(
            pts[::-1], dev)))
        g = np.random.default_rng(31)
        sign = torch.from_numpy(g.integers(0, 2, size=n).astype(bool)).to(dev)
        idx = torch.from_numpy(g.integers(0, n, size=n).astype(np.int32)
                               ).to(dev)
        name = EK.kernel_name("xyzz_madd", curve)
        reset_counts()
        got_l = EK.xyzz_madd(curve, p, a, sign=sign)
        got_t = EK.xyzz_madd(curve, p, a, idx, sign=sign)
        torch.cuda.synchronize()
        madd = read_counts()
        for kname, v in madd.items():
            total[kname] = total.get(kname, 0) + v
        check(madd.get(name, 0) == 2, f"{name} with sign: one launch a "
                                      f"call ({madd})")
        check(all(torch.equal(u, v) for u, v in zip(
            got_l + got_t, EK.xyzz_madd_plain(curve, p, a, sign=sign)
            + EK.xyzz_madd_plain(curve, p, a, idx, sign))),
            f"{name} with sign (per lane, and through a table and its "
            f"index) == the plain madd with sign, 2^{TAIL_LG} lanes")
        numbers[curve] = {"ms": ms, "launches": launches}
    # the host native MSM on BN254 2^16 against the port's MSM
    curve = SHARD_MSM_CURVE
    base, pts, words, wd = msm_input(curve, CPU_MSM_LG, dev)
    m = 1 << CPU_MSM_LG
    o = get_oracle(get_curve(curve))
    hpts = [base[i % len(base)] for i in range(m)]
    hpts[3] = o.infinity_affine()
    scal = [sum(int(words[w, i]) << (32 * w) for w in range(words.shape[0]))
            for i in range(m)]
    t0 = time.perf_counter()
    host = cpu_msm(curve, hpts, scal)
    ms_host = (time.perf_counter() - t0) * 1e3
    ctx = MSMContext(curve, m)
    ctx.set_points(pts)
    check(host == ctx.invoke(wd), f"ffi.native.cpu_msm {curve} 2^{CPU_MSM_LG}"
                                  f" (host, built from the checkout) == the "
                                  f"port's MSM on the card")
    print(f"time cpu_msm {curve} 2^{CPU_MSM_LG} on the host: {ms_host:.4f} "
          f"ms (wall, build included on a first call)", flush=True)
    numbers["cpu_msm_ms"] = ms_host
    return numbers, total


def port_phases(dev, card):
    """Phases 28-31, each main path with the launch counts set to 0 just
    before it and read just after.  Returns (numbers, launches summed by
    kernel)."""
    import torch
    from sppark_tpu_torch.parallel import destroy, init_distributed, make_mesh

    numbers, total, seconds = {}, {}, {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    rng = np.random.default_rng(28)
    t0 = time.perf_counter()
    for field in POLY_FIELDS:
        nums, counts = poly_phase(field, dev, card, rng)
        numbers[f"polynomial_{field}"] = nums
        add(counts)
        torch.cuda.empty_cache()
    seconds["polynomial"] = time.perf_counter() - t0
    # -- 29-30. BASELINE config 5's one-card half on an NCCL group of one --
    t0 = time.perf_counter()
    check(init_distributed() == 1, "an NCCL process group of one")
    try:
        mesh = make_mesh()
        nums, counts = sharded_ntt_phase(mesh, dev, card, rng)
        numbers["sharded_ntt"] = nums
        add(counts)
        seconds["sharded NTT"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        nums, counts = sharded_msm_phase(mesh, dev, card)
        numbers["sharded_msm"] = nums
        add(counts)
        seconds["sharded MSM"] = time.perf_counter() - t0
    finally:
        destroy()
    t0 = time.perf_counter()
    nums, counts = tail_phase(dev, card)
    numbers["tail"] = nums
    add(counts)
    seconds["tail"] = time.perf_counter() - t0
    numbers["port_phase_seconds"] = seconds
    print(f"phases 28-31 seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; total {sum(seconds.values()):.1f}", flush=True)
    return numbers, total


# -- phase 32: the two examples as the port's entry points ---------------------

EX_NTT_FIELDS = ("goldilocks", "baby_bear")
EX_NTT_LG = 24
EX_MSM_CURVES = ("bn254", "bls12_381")
EX_MSM_LG = 20          # the examples' base of 2^11 oracle points, tiled
EX_MSM_KERNELS = ("ec_xyzz_madd", "ec_xyzz_add", "ec_xyzz_dbl",
                  "bigmont_inv_up", "bigmont_pow", "bigmont_inv_down",
                  "bigmont_ew")
EX_BUDGET_S = 90


def examples_phase(card):
    """Phase 32: sppark_tpu_torch.examples' ntt_example and msm_example
    through their `main`, on the card, each run with the launch counts set
    to 0 just before it and read just after.  Returns (numbers, launches
    summed by kernel)."""
    import torch
    from sppark_tpu_torch import ntt
    from sppark_tpu_torch.examples import msm_example, ntt_example
    from sppark_tpu_torch.oracle.ec import get_oracle
    from sppark_tpu_torch.params import get_curve

    numbers, total = {}, {}
    t_phase = time.perf_counter()

    def run(fn, argv):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = fn(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return out, wall, counts

    for field in EX_NTT_FIELDS:
        out, wall, counts = run(ntt_example.main, [field, str(EX_NTT_LG)])
        kind = "gl64" if field == "goldilocks" else "mont32"
        check(all(counts.get(f"{kind}_ntt_{p}", 0) > 0 for p in
                  ("rows", "cols")),
              f"ntt_example {field} 2^{EX_NTT_LG} went through {kind}_ntt_rows"
              f" and {kind}_ntt_cols ({counts})")
        data = out["data"]
        check(np.array_equal(ntt.intt(field, out["ntt"], EX_NTT_LG), data)
              and np.array_equal(ntt.coset_intt(field, out["coset_ntt"],
                                                EX_NTT_LG), data)
              and out["lde"].shape == (data.size << 2,),
              f"ntt_example {field} 2^{EX_NTT_LG}: the NTT and coset round "
              f"trips exact, the LDE x4 of {data.size << 2} words")
        print(f"time ntt_example {field} 2^{EX_NTT_LG}: {wall:.3f} s wall "
              f"(host arrays, five transforms), launches {counts}  [{card}]",
              flush=True)
        numbers[f"ntt_example_{field}"] = {"s": wall, "launches": counts}
    for curve in EX_MSM_CURVES:
        out, wall, counts = run(msm_example.main, [curve, str(EX_MSM_LG)])
        res, host = out["result"], out["host"]
        check(all(counts.get(k, 0) > 0 for k in EX_MSM_KERNELS),
              f"msm_example {curve} 2^{EX_MSM_LG} went through "
              f"{', '.join(EX_MSM_KERNELS)} ({counts})")
        check(host is not None and res == host and not res.inf
              and get_oracle(get_curve(curve)).on_curve(res),
              f"msm_example {curve} 2^{EX_MSM_LG} == ffi.native.cpu_msm "
              f"and on the curve")
        print(f"time msm_example {curve} 2^{EX_MSM_LG}: {wall:.3f} s wall "
              f"(mult_pippenger {out['device_s']:.3f} s from oracle points,"
              f" cpu_msm {out['host_s']:.3f} s on the host), launches "
              f"{counts}  [{card}]", flush=True)
        numbers[f"msm_example_{curve}"] = {
            "s": wall, "device_s": out["device_s"],
            "host_s": out["host_s"], "launches": counts}
        del out, res, host
    seconds = time.perf_counter() - t_phase
    check(seconds <= EX_BUDGET_S, f"phase 32 within {EX_BUDGET_S} s "
                                  f"({seconds:.1f} s)")
    numbers["example_phase_seconds"] = seconds
    return numbers, total


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from sppark_tpu_torch import _build, params
    from sppark_tpu_torch.ff import gl64
    from sppark_tpu_torch import ntt
    from sppark_tpu_torch.ntt import fused, kernels as K
    from sppark_tpu_torch.ntt.parameters import get_parameters
    from sppark_tpu_torch.oracle import ntt as oracle

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    rate = int32_rate()

    # -- 1. probe and build ----------------------------------------------------
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {kind}  [{card}]  "
          f"INT32 rate {rate:.4e} op/s", flush=True)
    t0 = time.perf_counter()
    info = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(info) or 'nothing (already built)'}", flush=True)
    for name, rec in info.items():
        entry = ""
        for line in rec["log"].splitlines():
            m = re.search(r"Compiling entry function '\w*?"
                          r"((?:ew|pow|rows|cols|mid)_kernel|inv_up|inv_down)"
                          r"(I(?:L[ib]\d+E)+E)?", line)
            if m:
                args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
                entry = m.group(1) + (f"<{','.join(args)}>" if args else "")
            m = re.search(r"ec_kernelIN4mont\d+(" + EC_ELEMS + r")ILi(\d+)"
                          r"EEELi(\d)E", line)
            if m:
                entry = (f"ec_kernel<{m.group(1)}<{m.group(2)}>,"
                         f"{EC_OPS[int(m.group(3))]}>")
            if "registers" in line or "spill" in line:
                print(f"  {name} {entry}: {line.strip()}")

    fp = params.get_field(FIELD)
    pm = get_parameters(FIELD, dev)
    rng = np.random.default_rng(2024)

    def rand_words(*shape):
        w = rng.integers(0, fp.modulus, size=shape, dtype=np.uint64)
        return gl64.from_wire(w, dev)

    def raw_words(*shape):
        """Any 64-bit words, non-canonical ones included: 0, p - 1, p,
        p + 1 and 2^64 - 1 in the first lanes and 2^64 - 1 in a whole
        warp's lanes (32-63)."""
        w = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
        flat = w.reshape(-1)
        edges = [0, fp.modulus - 1, fp.modulus, fp.modulus + 1, M64]
        flat[:len(edges)] = edges[:flat.size]
        flat[32:64] = M64
        return gl64.from_wire(w, dev)

    errs = {"gl64_ntt_rows": 0, "gl64_ntt_cols": 0}

    def same(name, got, want, what, quiet=False):
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        errs[name] = max(errs[name], e)
        ok = e == 0 and got.shape == want.shape
        if quiet and ok:
            return
        check(ok, f"{name} == plain: {what}")

    # -- 2. kernels vs plain ---------------------------------------------------
    t0 = time.perf_counter()
    for lg in GL64_ROW_LGS:
        tw = pm.power_table(lg, False)
        n_lg = 1 << lg
        shapes = [(r, n_lg) for r in GL64_ROW_COUNTS] + [
            (ob, b, n_lg) for ob, b in GL64_ROW_BATCHES]
        cases = 0
        for shape in shapes:
            x = raw_words(*shape)
            mul = raw_words(*shape)
            for in_rev in (False, True):
                for out_rev in (False, True):
                    for out_t in (False, True):
                        for m in ((None,) if out_rev else (None, mul)):
                            args = (x, tw, lg, m, in_rev, out_rev, out_t)
                            same("gl64_ntt_rows", K.ntt_rows(*args),
                                 K.ntt_rows_plain(*args),
                                 f"lg {lg} {shape} in_rev={in_rev} "
                                 f"out_rev={out_rev} out_t={out_t} "
                                 f"mul={m is not None}", quiet=True)
                            cases += 1
        check(True, f"gl64_ntt_rows == plain: lg {lg}, {shapes}, every "
                    f"option ({cases} cases)")
    for lg1 in GL64_COL_LGS:
        tw = pm.power_table(lg1, True)
        cases = 0
        for m_cols in GL64_COL_COUNTS:
            mid = raw_words(1 << lg1, m_cols)
            for batch in ((), (3,)):
                x = raw_words(*batch, 1 << lg1, m_cols)
                for m in (None, mid):
                    same("gl64_ntt_cols", K.ntt_cols(x, tw, lg1, m),
                         K.ntt_cols_plain(x, tw, lg1, m),
                         f"lg1 {lg1} {tuple(x.shape)} mul={m is not None}",
                         quiet=True)
                    cases += 1
            del x, mid
        check(True, f"gl64_ntt_cols == plain: lg1 {lg1}, M in "
                    f"{GL64_COL_COUNTS}, batch, middle matrix ({cases} "
                    f"cases)")

    # the shapes the main path gives the kernels: the four-step at 2^24 and
    # the six-step at 2^26 (LDE), forward and inverse tables
    main_shapes = []
    for lg, inverse in ((LG, False), (LG, True), (LG + LG_BLOWUP, False)):
        tables = fused.fused_tables(FIELD, lg, inverse, dev)
        lg1 = fused.split_lg1(lg, FIELD)
        x = raw_words(1 << lg1, 1 << (lg - lg1))
        same("gl64_ntt_cols", K.ntt_cols(x, tables[0], lg1, tables[1]),
             K.ntt_cols_plain(x, tables[0], lg1, tables[1]),
             f"main-path cols lg {lg} inverse={inverse}")
        if lg - lg1 <= fused.LG_TILE:
            same("gl64_ntt_rows",
                 K.ntt_rows(x, tables[2], lg - lg1, out_t=True),
                 K.ntt_rows_plain(x, tables[2], lg - lg1, out_t=True),
                 f"main-path rows lg {lg} inverse={inverse} out_t")
            main_shapes.append((lg, inverse, x, tables, lg1))
            continue
        lg2 = lg - lg1
        lg21 = fused.split_lg1(lg2, FIELD)
        xb = raw_words(1 << lg1, 1 << lg21, 1 << (lg2 - lg21))
        same("gl64_ntt_cols", K.ntt_cols(xb, tables[2], lg21, tables[3]),
             K.ntt_cols_plain(xb, tables[2], lg21, tables[3]),
             f"main-path six-step cols lg {lg} batch {tuple(xb.shape)}")
        same("gl64_ntt_rows",
             K.ntt_rows(xb, tables[4], lg2 - lg21, out_t=True),
             K.ntt_rows_plain(xb, tables[4], lg2 - lg21, out_t=True),
             f"main-path six-step rows lg {lg} batch {tuple(xb.shape)}")
    del x, xb, mul
    print(f"phase 2: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 3. main path: forward NTT 2^24 through the host-array entry point --
    n = 1 << LG
    wire = rng.integers(0, fp.modulus, size=n, dtype=np.uint64)
    K.reset_launches()
    out_wire = ntt.ntt(FIELD, wire, LG)
    ntt_launches = dict(K.launches)
    print(f"main path NTT 2^{LG} launches: {ntt_launches}", flush=True)
    check(all(v > 0 for v in ntt_launches.values()),
          f"NTT 2^{LG} went through both kernels")
    x = gl64.from_wire(wire, dev)
    y = gl64.from_wire(out_wire, dev)
    y_plain = fused.facade(FIELD, x, LG, kern=K.PLAIN)
    torch.cuda.synchronize()
    check(torch.equal(y, y_plain), f"NTT 2^{LG} == plain path on the card")
    back = ntt.base_dev(FIELD, y, LG, direction=ntt.Direction.inverse)
    check(torch.equal(back, x), f"intt(ntt(x)) == x at 2^{LG}")
    del y_plain, back
    for lg in (1, 12, 14):
        ints = [int(v) for v in wire[: 1 << lg]]
        got = ntt.base_dev(FIELD, gl64.from_ints(ints, dev), lg)
        check(gl64.to_ints(got) == oracle.ntt_natural(fp, ints),
              f"NTT 2^{lg} == big-int oracle")
        got = ntt.base_dev(FIELD, got, lg, direction=ntt.Direction.inverse)
        check(gl64.to_ints(got) == ints, f"intt round trip 2^{lg}")
    for lg in (10, 16):
        xs = rand_words(1 << lg)
        for order in ntt.InputOutputOrder:
            for inverse in (False, True):
                for coset in (False, True):
                    got = ntt.base_dev(FIELD, xs, lg, order,
                                       ntt.Direction(int(inverse)),
                                       ntt.Type(int(coset)))
                    want = fused.facade(FIELD, xs, lg, order.value, inverse,
                                        coset, kern=K.PLAIN)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want),
                          f"2^{lg} {order.value} inverse={inverse} "
                          f"coset={coset} == plain path")

    # -- 4. LDE 2^24 x 4 (six-step at lg 26) -----------------------------------
    lg_ext = LG + LG_BLOWUP
    K.reset_launches()
    ext = ntt.lde_dev(FIELD, x, LG, LG_BLOWUP)
    torch.cuda.synchronize()
    lde_launches = dict(K.launches)
    print(f"main path LDE 2^{LG} x{1 << LG_BLOWUP} launches: {lde_launches}",
          flush=True)
    check(all(v > 0 for v in lde_launches.values()),
          f"LDE 2^{LG} x{1 << LG_BLOWUP} went through both kernels")
    check(torch.equal(ext, fused.lde(FIELD, x, LG, LG_BLOWUP, kern=K.PLAIN)),
          f"LDE 2^{LG} x{1 << LG_BLOWUP} == plain path on the card")
    inv = ntt.base_dev(FIELD, ext, lg_ext, direction=ntt.Direction.inverse,
                       ntt_type=ntt.Type.coset)
    check(bool((inv[n:] == 0).all()), f"LDE: coefficients above 2^{LG} are 0")
    check(torch.equal(ntt.base_dev(FIELD, inv[:n].contiguous(), LG), x),
          "LDE: inverse coset transform gives back x")
    del inv
    ints = [int(v) for v in wire[:1 << 10]]
    got = ntt.lde_dev(FIELD, gl64.from_ints(ints, dev), 10, 1)
    check(gl64.to_ints(got) == oracle.lde(fp, ints, 1),
          "LDE 2^10 x2 == big-int oracle")

    # -- 5. times ------------------------------------------------------------
    state = [x]

    def ntt_step():
        state[0] = ntt.base_dev(FIELD, state[0], LG)

    t_ntt = median_ms(ntt_step, reps=20, warmup=2)
    bfly = (n // 2) * LG
    print(f"time NTT 2^{LG} forward (dependent chain): {t_ntt:.4f} ms, "
          f"{bfly / (t_ntt * 1e-3):.4e} butterflies/s  [{card}]", flush=True)
    t_lde = median_ms(lambda: ntt.lde_dev(FIELD, x, LG, LG_BLOWUP), reps=5)
    bfly_lde = bfly + (1 << (lg_ext - 1)) * lg_ext
    print(f"time LDE 2^{LG} x{1 << LG_BLOWUP}: {t_lde:.4f} ms, "
          f"{bfly_lde / (t_lde * 1e-3):.4e} butterflies/s  [{card}]",
          flush=True)
    # where the LDE's time goes: the inverse NTT, the plain zero pad and
    # coset shift, the forward six-step
    shift = pm.coset_powers(lg_ext, False)
    coeffs = ntt.base_dev(FIELD, x, LG, direction=ntt.Direction.inverse)
    pad = torch.zeros((1 << lg_ext) - n, dtype=torch.int64, device=dev)
    ext = gl64.mul(torch.cat([coeffs, pad]), shift)
    parts = {
        f"inverse NTT 2^{LG}": median_ms(lambda: ntt.base_dev(
            FIELD, x, LG, direction=ntt.Direction.inverse), reps=5),
        "pad + coset shift (plain)": median_ms(
            lambda: gl64.mul(torch.cat([coeffs, pad]), shift), reps=5),
        f"forward NTT 2^{lg_ext}": median_ms(
            lambda: ntt.base_dev(FIELD, ext, lg_ext), reps=5),
    }
    print("time LDE parts: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in parts.items()) + f"  [{card}]",
        flush=True)
    del coeffs, pad, ext

    # each kernel alone at the forward NTT 2^24 shapes
    _, _, xm, tables, lg1 = main_shapes[0]
    lg2 = LG - lg1
    tw1, mid, tw2 = tables[0], tables[1], tables[2]

    cols_ms = median_ms(lambda: K.ntt_cols(xm, tw1, lg1, mid), reps=20)
    cols_plain_ms = median_ms(lambda: K.ntt_cols_plain(xm, tw1, lg1, mid),
                              reps=3)
    cols_bound, cols_by = bound(
        WORD * (3 * n + tw1.numel()),
        transform_ops(lg1, n >> lg1, OPS_PER_MUL, OPS_ADD_SUB)
        + OPS_PER_MUL * n, rate)
    rows_ms = median_ms(lambda: K.ntt_rows(xm, tw2, lg2, out_t=True),
                        reps=20)
    rows_plain_ms = median_ms(
        lambda: K.ntt_rows_plain(xm, tw2, lg2, out_t=True), reps=3)
    rows_bound, rows_by = bound(
        WORD * (2 * n + tw2.numel()),
        transform_ops(lg2, n >> lg2, OPS_PER_MUL, OPS_ADD_SUB), rate)
    regs = ptxas_summary(info.get("ntt_gl64", {}).get("log", ""))
    for name, ms, pms, b, by in (
            ("gl64_ntt_cols", cols_ms, cols_plain_ms, cols_bound, cols_by),
            ("gl64_ntt_rows", rows_ms, rows_plain_ms, rows_bound, rows_by)):
        kern = name.split("_")[-1] + "_kernel"
        print(f"time {name} at 2^{LG} shapes: {ms:.4f} ms (plain "
              f"{pms:.4f} ms, bound {b:.4f} ms by {by}, "
              f"{b / ms:.3f} of bound); "
              f"{regs.get(kern, 'registers: not rebuilt in this run')}  "
              f"[{card}]", flush=True)

    del xm, tables, main_shapes, state, x, y
    logs = {k: v.get("log", "") for k, v in info.items()}
    msm_entries, g1_input, g1_launches, pow_err = msm_phases(dev, card,
                                                             rate, logs)
    torch.cuda.empty_cache()
    wide_entries, wide_numbers = wide_phases(dev, card, rate)
    torch.cuda.empty_cache()
    g2_entries, g2_numbers, g2_input = g2_phases(dev, card, rate, logs)
    torch.cuda.empty_cache()
    tree_entries, tree_numbers, tree_launches = tree_phases(
        dev, card, rate, g1_input, g2_input, pow_err, logs)
    torch.cuda.empty_cache()
    narrow_entries, narrow_numbers = narrow_phases(
        dev, card, rate, info.get("ntt_mont32", {}).get("log", ""))
    torch.cuda.empty_cache()
    round_numbers, round_launches = round_phases(dev, card, rate, g1_input,
                                                 g2_input)
    del g1_input, g2_input
    # the Montgomery kernels run on all four MSM paths, whose counts were
    # read apart: the G1 and G2 slabs', then the two trees'; the point
    # kernels of the slabs' entries also run in the trees' integrate
    paths = (g1_launches, g2_numbers["g2_launches"],
             tree_numbers["tree_g1_launches"],
             tree_numbers["tree_g2_launches"])
    for e in msm_entries + g2_entries + tree_entries:
        if e["name"] in ("bigmont_ew", "bigmont_pow", "bigmont_inv_up",
                         "bigmont_inv_down"):
            e["launches"] = sum(run[e["name"]] for run in paths)
        elif e in msm_entries + g2_entries and e["name"] in tree_launches:
            e["launches"] += tree_launches[e["name"]]
    # the round modes' and batch_addition's paths run the point and field
    # kernels of the slab and the tree
    for e in msm_entries + g2_entries + tree_entries:
        e["launches"] += round_launches.get(e["name"], 0)
    torch.cuda.empty_cache()
    port_numbers, port_launches = port_phases(dev, card)
    torch.cuda.empty_cache()
    example_numbers, example_launches = examples_phase(card)

    # -- 33. summary -----------------------------------------------------------
    src = "sppark_tpu_torch/csrc/ntt_gl64.cu"
    kernels_line = {"kernels": [
        {"name": "gl64_ntt_rows", "route": "cuda", "source": src,
         "replaces": "sppark_tpu/ntt/pallas_kernels.py:206",
         "launches": ntt_launches["gl64_ntt_rows"]
         + lde_launches["gl64_ntt_rows"],
         "max_abs_err": errs["gl64_ntt_rows"], "ms": rows_ms,
         "plain_ms": rows_plain_ms, "bound_ms": rows_bound,
         "bound_by": rows_by, "library_ms": None},
        {"name": "gl64_ntt_cols", "route": "cuda", "source": src,
         "replaces": "sppark_tpu/ntt/pallas_kernels.py:319",
         "launches": ntt_launches["gl64_ntt_cols"]
         + lde_launches["gl64_ntt_cols"],
         "max_abs_err": errs["gl64_ntt_cols"], "ms": cols_ms,
         "plain_ms": cols_plain_ms, "bound_ms": cols_bound,
         "bound_by": cols_by, "library_ms": None},
    ] + msm_entries + wide_entries + g2_entries + tree_entries
        + narrow_entries}
    # the paths of phases 28-32 run the NTT, point and field kernels too
    for e in kernels_line["kernels"]:
        e["launches"] += port_launches.get(e["name"], 0) \
            + example_launches.get(e["name"], 0)
    print(json.dumps({"ntt_ms": t_ntt, "lde_ms": t_lde,
                      "lde_parts_ms": parts, "ntt_launches": ntt_launches,
                      "lde_launches": lde_launches, **wide_numbers,
                      **g2_numbers, **tree_numbers, **narrow_numbers,
                      **round_numbers, **port_numbers, **example_numbers,
                      "seconds": time.perf_counter() - t_start,
                      "card": card}))
    print(json.dumps(kernels_line))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the "
          f"build included")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        import sppark_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the sppark_tpu_torch package is missing ({e})",
              file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
