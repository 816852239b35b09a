"""Build variants of the point kernels and of the batch inversion, timed
against the committed ones on one card and on the same data:

    python3 -m sppark_tpu_torch.variants [part of a name]

(with an argument, only the variants whose name holds it, and the
committed kernels they replace)

Each variant is a scratch copy of csrc/ under build/variants/ (git-ignored)
with one change to its text.  For the lane-pair fp2 add and pair finish:
one thread a lane (`mont::Fp2`, their element before the lane pair), a
minimum of 1, 3 or 4 blocks an SM in `__launch_bounds__` (which caps ptxas
at 65536 / (128 blocks) registers a thread; the committed kernels give no
minimum), or the finish's direct strided loads in place of its
shared-memory tile of level 0's rows.  For the one-thread G1 madd: a
minimum of 1 block.  For the batch inversion (csrc/batch_inv.cu): other
blocks of T threads of C lanes, and in degree 2 the norm recomputed in the
down kernel in place of the one the up kernel stores.  The point kernels'
variants are built at n32 = 12 only.  The script
prints ptxas's registers and spills of each, then each one's time by CUDA
events at the main paths' shapes on random canonical words: the G2 add at
147,456 lanes (the G2 slab's fold), every lane taking the fast leg; the
G2 finish at level 1's 6,459,904 lanes on point-major rows, every lane a
chord; the G1 madd at 294,912 lanes; the batch inversion's three launches
at the trees' level 1, 12,964,864 BLS12-381 Fp lanes and 6,459,904 Fp2
lanes.  Two rounds in opposite orders; each
output equals the committed kernel's word for word.  The committed
kernels' own registers are printed by chip_smoke.py.  Nothing of the port
calls this module.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from . import _build
from .ec import kernels as EK
from .ff import kernels as FK
from .params import get_curve

ADD_LANES, FINISH_LANES, MADD_LANES = 147_456, 6_459_904, 294_912
INV_LANES = 12_964_864          # the G1 tree's level 1; G2's: FINISH_LANES
#: the point kernels by their template's op number (csrc/ec_kernel.cuh)
OPS = ("xyzz_madd", "xyzz_add", "xyzz_dbl", "pair_prep", "pair_finish")
BOUNDS = "__launch_bounds__(THREADS)"


def _blocks(k):
    """A minimum of k blocks an SM for every kernel of the source."""
    return (BOUNDS, f"__launch_bounds__(THREADS, {k})")


def variants():
    """{name: (source, [(old, new) text substitutions])}; the name says
    what differs from the committed build."""
    out = {"ec_xyzz madd, 1 block": ("ec_xyzz", [_blocks(1)])}
    for source, op in (("ec_fp2_add", "ADD"), ("ec_fp2_pair", "PAIR_FINISH")):
        out[f"{source} one thread a lane"] = (source, [
            (f"ec::dispatch<mont::Fp2Pair, ec::{op}>",
             f"ec::dispatch<mont::Fp2, ec::{op}>")])
        for k in (1, 3, 4):
            out[f"{source}, {k} block{'s' * (k > 1)}"] = (source,
                                                          [_blocks(k)])
    out["ec_fp2_pair direct loads"] = ("ec_fp2_pair", [
        ("a.rows = OP == PAIR_FINISH", "a.rows = false && OP")])
    block = [(f"constexpr int {k} = {v};", f"constexpr int {k} = {{}};")
             for k, v in (("T", FK.INV_THREADS), ("C", FK.INV_CHUNK))]
    for t, c in ((32, 32), (64, 16), (64, 32), (128, 4), (128, 8),
                 (128, 16), (128, 32), (256, 8), (256, 16)):
        out[f"batch_inv T {t} C {c}"] = ("batch_inv", [
            (old, new.format(v)) for (old, new), v in zip(block, (t, c))])
    out["batch_inv norm recomputed"] = ("batch_inv", [
        ("            store<N>(dn, n, i, d);\n", ""),
        ("load<N>(DEG == 1 ? x : dn, n, i)",
         "DEG == 1 ? load<N>(x, n, i) : norm(load<N>(x, n, i), "
         "load<N>(x + N * n, n, i), c)")])
    return out


def _make(name, source, subs):
    """Write the variant's sources, N = 12 only; returns (library, nvcc
    command)."""
    d = _build.BUILD / "variants" / re.sub(r"\W+", "_", name)
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    files = [_build.CSRC / f"{source}.cu"] + sorted(
        _build.CSRC.glob("*.cuh"))
    text = {f.name: f.read_text() for f in files}
    text["ec_kernel.cuh"] = re.sub(
        r"\n\s*case (2|8): launch<F<\1>, OP>\([^)]*\); break;", "",
        text["ec_kernel.cuh"])
    for old, new in subs:
        f = next((f for f, t in text.items() if old in t), None)
        if f is None:
            raise ValueError(f"{name}: {old!r} not found")
        text[f] = text[f].replace(old, new)
    for f, t in text.items():
        (d / f).write_text(t)
    lib = d / f"lib{source}.so"
    return lib, [_build.nvcc(), *_build.FLAGS, "-o", str(lib),
                 str(d / f"{source}.cu")]


def _registers(log):
    """ptxas's lines for the N = 12 kernels of a build log."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"ec_kernelIN4mont\d+(Fp2Pair|Fp2|Fp)ILi12EEELi(\d)E",
                      line)
        k = re.search(r"(inv_up|inv_down)ILi12ELi(\d)E", line)
        if "Compiling entry function" in line:
            entry = (f"{m.group(1)}<12>,{OPS[int(m.group(2))]}" if m else
                     f"{k.group(1)}<12,{k.group(2)}>" if k else None)
        elif entry and ("registers" in line or "spill" in line):
            out.append(f"{entry}: {line.strip()}")
    return out


def _load(path, source):
    lib = ctypes.CDLL(str(path))
    sigs = {fn: [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
            for fn, s in EK.SOURCES.items() if s == source}
    if source == "batch_inv":
        sigs = FK._INV_SIGNATURES
    for fn, argtypes in sigs.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def _events_ms(fn, reps=20):
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


def _words(p, n32, shape, rng, dev):
    """Random canonical base-field words (n32, *shape) as int32."""
    w = rng.integers(0, 1 << 32, size=(n32,) + shape,
                     dtype=np.uint64).astype(np.uint32)
    w[-1] %= np.uint32(p >> (32 * (n32 - 1)))
    return torch.from_numpy(w.view(np.int32)).to(dev)


def _fp2(p, n32, shape, rng, dev):
    return torch.cat([_words(p, n32, shape, rng, dev),
                      _words(p, n32, shape, rng, dev)])


def main():
    if not torch.cuda.is_available():
        print("variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    chosen = {name: v for name, v in variants().items()
              if (sys.argv[1:] or [""])[0] in name
              and f"T {FK.INV_THREADS} C {FK.INV_CHUNK}" not in name}
    _build.build({v[0] for v in chosen.values()} | {"bigmont"})
    todo = {name: _make(name, *v) for name, v in chosen.items()}
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, (_, cmd) in todo.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        libs[name] = _load(todo[name][0], chosen[name][0])
        for line in _registers(log):
            print(f"ptxas {name}: {line}")
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)

    cp = get_curve("bls12_381_g2")
    p, n32 = cp.field.modulus, cp.field.n_ref_limbs
    W = 2 * n32
    rng = np.random.default_rng(8)
    pt = tuple(_fp2(p, n32, (ADD_LANES,), rng, dev) for _ in range(4))
    qt = tuple(_fp2(p, n32, (ADD_LANES,), rng, dev) for _ in range(4))
    rows = torch.cat([_fp2(p, n32, (2 * FINISH_LANES,), rng, dev),
                      _fp2(p, n32, (2 * FINISH_LANES,), rng, dev)]).T
    rows = rows.contiguous()            # (2 lanes, 2 W): level 0
    l = (rows[0::2, :W].T, rows[0::2, W:].T)
    r = (rows[1::2, :W].T, rows[1::2, W:].T)
    inv = _fp2(p, n32, (FINISH_LANES,), rng, dev)
    flags = torch.full((FINISH_LANES,), EK.ACTIVE, dtype=torch.int32,
                       device=dev)
    g1 = tuple(_words(p, n32, (MADD_LANES,), rng, dev) for _ in range(6))
    d1 = _words(p, n32, (INV_LANES,), rng, dev)
    d2 = _fp2(p, n32, (FINISH_LANES,), rng, dev)
    nr = cp.fp2.nr_small
    calls = {"ec_fp2_add": lambda: EK.xyzz_add("bls12_381_g2", pt, qt),
             "ec_fp2_pair": lambda: EK.affine_pair_finish(
                 "bls12_381_g2", l, r, inv, flags),
             "ec_xyzz": lambda: EK.xyzz_madd("bls12_381", g1[:4], g1[4:]),
             "batch_inv": lambda: [FK.mont_batch_inv(d1, cp.field)],
             "batch_inv_fp2": lambda: [FK.mont_batch_inv(d2, cp.field, 2,
                                                         nr)]}

    def source_of(call):            # both degrees run batch_inv's source
        return "batch_inv" if call == "batch_inv_fp2" else call

    sources = {v[0] for v in chosen.values()}
    calls = {k: f for k, f in calls.items() if source_of(k) in sources}
    want = {s: [c.clone() for c in fn()] for s, fn in calls.items()}
    torch.cuda.synchronize()
    runs = [f"{s} committed" for s in calls]
    for name in libs:
        runs.append(name)
        if name.startswith("batch_inv"):
            runs.append(name.replace("batch_inv", "batch_inv_fp2", 1))
    times = {name: [] for name in runs}
    block = (FK.INV_THREADS, FK.INV_CHUNK)
    for order in (runs, runs[::-1]):
        for name in order:
            call = re.match(r"\w+", name).group()
            source = source_of(call)
            variant = name.replace("batch_inv_fp2", "batch_inv", 1)
            committed = _build._libs[source]
            if variant in libs:
                _build._libs[source] = libs[variant]
            m = re.search(r"T (\d+) C (\d+)", name)
            FK.INV_THREADS, FK.INV_CHUNK = map(int, m.groups()) if m \
                else block
            try:
                got = calls[call]()
                torch.cuda.synchronize()
                if not all(torch.equal(g, w)
                           for g, w in zip(got, want[call])):
                    raise RuntimeError(f"{name}: output differs from the "
                                       "committed kernel")
                del got
                times[name].append(_events_ms(calls[call]))
            finally:
                _build._libs[source] = committed
                FK.INV_THREADS, FK.INV_CHUNK = block
    lanes_of = {"ec_fp2_add": ADD_LANES, "ec_fp2_pair": FINISH_LANES,
                "ec_xyzz": MADD_LANES, "batch_inv": INV_LANES,
                "batch_inv_fp2": FINISH_LANES}
    for name in runs:
        lanes = lanes_of[re.match(r"\w+", name).group()]
        print(f"time {name} at {lanes} lanes: " + " / ".join(
            f"{t:.4f}" for t in times[name]) + f" ms (rounds 1 / 2)  "
            f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
