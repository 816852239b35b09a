"""Smoke run of the PyTorch/CUDA port (sppark_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from sppark_tpu_torch/csrc, then:
  1. prints the toolchain, the card, and the build time;
  2. holds each kernel against its plain PyTorch version on the card, at
     the listed shapes and options and at the shapes the main path gives
     it: exact equality (integer field arithmetic, tolerance zero);
  3. drives the main path, a Goldilocks forward NTT of 2^24 through the
     host-array entry point `ntt.ntt`, with the launch counts set to 0
     just before it and read just after; checks it against the plain path
     on the card, the intt round trip, the big-int oracle at small lg, and
     the four orders x forward/inverse x standard/coset at lg 10 and 16;
  4. drives the coset LDE 2^24 with blowup 4 (the six-step at lg 26) the
     same way; checks it against the plain path on the card, the inverse
     round trip and the oracle at lg 10;
  5. times the NTT, the LDE and each kernel alone at its 2^24 shapes with
     CUDA events, beside the plain versions and the kernels' bounds;
  6. prints one JSON line of the kernels, the card's name and power limit,
     and last {"ok": true, "device": {...}}.
Any failed check raises, so the run exits non-zero and prints no last line.
It exits non-zero at once without a CUDA device or without the package.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): device memory rate, and the float32
# rate outside the tensor cores (67 T/s), taken as the rate of the 32-bit
# integer operations the butterflies are made of
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# 32-bit integer operations counted per radix-2 butterfly (one 64x64 ->
# 128-bit product as four 32x32 products, its reduction, one add, one sub)
# and per extra field multiply; a floor, not a count of issued instructions
OPS_PER_BUTTERFLY = 20
OPS_PER_MUL = 12
WORD = 8

FIELD = "goldilocks"
LG = 24
LG_BLOWUP = 2


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


def main():
    import torch

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

    # -- 1. probe and build ----------------------------------------------------
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {kind}  [{card}]", flush=True)
    t0 = time.perf_counter()
    info = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(info) or 'nothing (already built)'}", flush=True)
    for name, rec in info.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    fp = params.get_field(FIELD)
    pm = get_parameters(FIELD, dev)
    rng = np.random.default_rng(2024)

    def rand_words(*shape):
        w = rng.integers(0, fp.modulus, size=shape, dtype=np.uint64)
        return gl64.from_wire(w, dev)

    def raw_words(*shape):
        """Any 64-bit words, non-canonical ones included."""
        w = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
        return gl64.from_wire(w, dev)

    errs = {"gl64_ntt_rows": 0, "gl64_ntt_cols": 0}

    def same(name, got, want, what):
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        errs[name] = max(errs[name], e)
        check(e == 0 and got.shape == want.shape, f"{name} == plain: {what}")

    # -- 2. kernels vs plain ---------------------------------------------------
    for lg in (1, 5, 10, 13):
        tw = pm.power_table(lg, False)
        for shape in ((1, 1 << lg), (16, 1 << lg), (3, 16, 1 << lg)):
            x = raw_words(*shape)
            mul = raw_words(*shape)
            for in_rev in (False, True):
                for out_rev in (False, True):
                    for out_t in (False, True):
                        for m in (None, mul):
                            if m is not None and out_rev:
                                continue
                            args = (x, tw, lg, m, in_rev, out_rev, out_t)
                            same("gl64_ntt_rows", K.ntt_rows(*args),
                                 K.ntt_rows_plain(*args),
                                 f"lg {lg} {shape} in_rev={in_rev} "
                                 f"out_rev={out_rev} out_t={out_t} "
                                 f"mul={m is not None}")
    for lg1 in (1, 6, 11):
        tw = pm.power_table(lg1, True)
        for m_cols in (8, 8192):
            mid = raw_words(1 << lg1, m_cols)
            for batch in ((), (3,)):
                x = raw_words(*batch, 1 << lg1, m_cols)
                for m in (None, mid):
                    same("gl64_ntt_cols", K.ntt_cols(x, tw, lg1, m),
                         K.ntt_cols_plain(x, tw, lg1, m),
                         f"lg1 {lg1} {tuple(x.shape)} mul={m is not None}")

    # the shapes the main path gives the kernels: the four-step at 2^24 and
    # the six-step at 2^26 (LDE), forward and inverse tables
    main_shapes = []
    for lg, inverse in ((LG, False), (LG, True), (LG + LG_BLOWUP, False)):
        tables = fused.fused_tables(FIELD, lg, inverse, dev)
        lg1 = fused.split_lg1(lg)
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
        lg21 = fused.split_lg1(lg2)
        xb = raw_words(1 << lg1, 1 << lg21, 1 << (lg2 - lg21))
        same("gl64_ntt_cols", K.ntt_cols(xb, tables[2], lg21, tables[3]),
             K.ntt_cols_plain(xb, tables[2], lg21, tables[3]),
             f"main-path six-step cols lg {lg} batch {tuple(xb.shape)}")
        same("gl64_ntt_rows",
             K.ntt_rows(xb, tables[4], lg2 - lg21, out_t=True),
             K.ntt_rows_plain(xb, tables[4], lg2 - lg21, out_t=True),
             f"main-path six-step rows lg {lg} batch {tuple(xb.shape)}")
    del x, xb, mul, mid

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

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
        return max(t_bytes, t_ops) * 1e3, \
            "bytes" if t_bytes >= t_ops else "operations"

    cols_ms = median_ms(lambda: K.ntt_cols(xm, tw1, lg1, mid), reps=20)
    cols_plain_ms = median_ms(lambda: K.ntt_cols_plain(xm, tw1, lg1, mid),
                              reps=3)
    cols_bound, cols_by = bound(
        WORD * (3 * n + tw1.numel()),
        OPS_PER_BUTTERFLY * (n // 2) * lg1 + OPS_PER_MUL * n)
    rows_ms = median_ms(lambda: K.ntt_rows(xm, tw2, lg2, out_t=True),
                        reps=20)
    rows_plain_ms = median_ms(
        lambda: K.ntt_rows_plain(xm, tw2, lg2, out_t=True), reps=3)
    rows_bound, rows_by = bound(WORD * (2 * n + tw2.numel()),
                                OPS_PER_BUTTERFLY * (n // 2) * lg2)
    for name, ms, pms, b, by in (
            ("gl64_ntt_cols", cols_ms, cols_plain_ms, cols_bound, cols_by),
            ("gl64_ntt_rows", rows_ms, rows_plain_ms, rows_bound, rows_by)):
        print(f"time {name} at 2^{LG} shapes: {ms:.4f} ms (plain "
              f"{pms:.4f} ms, bound {b:.4f} ms by {by}, "
              f"{b / ms:.3f} of bound)  [{card}]", flush=True)

    # -- 6. summary ------------------------------------------------------------
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
    ]}
    print(json.dumps({"ntt_ms": t_ntt, "lde_ms": t_lde,
                      "lde_parts_ms": parts, "ntt_launches": ntt_launches,
                      "lde_launches": lde_launches, "card": card}))
    print(json.dumps(kernels_line))
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
