"""Build variants of the point kernels, of the batch inversion and of the
wide, 31-bit and Goldilocks NTTs' row and column passes, timed against
the committed ones on one card and on the same data:

    python3 -m sppark_tpu_torch.variants [--parent DIR] [part of a name ...]
    python3 -m sppark_tpu_torch.variants --sass [source ...]
    python3 -m sppark_tpu_torch.variants --sass --parent DIR [source ...]

(with arguments, only the variants whose name holds one of them, and the
committed kernels they replace; with --parent, one more variant of each
chosen source built from DIR, a copy of csrc/ at an earlier commit
(`git archive REV sppark_tpu_torch/csrc | tar -x -C DIR0`, DIR =
DIR0/sppark_tpu_torch/csrc); with --sass, no timing: ptxas's registers
and the SASS counts of the committed N = 12 point kernels, N = 8 wide
NTT kernels and mont32 and Goldilocks NTT kernels of the named sources,
default all, and of the probes below)

Each variant is a scratch copy of csrc/ under build/variants/ (git-ignored)
with one change to its text.  For the lane-pair fp2 add and pair kernels:
one thread a lane (`mont::Fp2`, each one's element before the lane pair;
the prep then reads the table by 16-byte loads), a minimum of 1, 2, 3
or 4 blocks an SM in `__launch_bounds__` (which caps ptxas at 65536 /
(128 blocks) registers a thread; the committed kernels give no minimum),
the prep's or both pair kernels' direct loads from the table in place of
their shared-memory tile, and the tile's copies cached in L2 only
(`cp.async.cg`).  For the G1 madd, add and dbl: their element before
the carry chains (`mont::Fp`, with no minimum of blocks), or a minimum of
1 or 2 blocks, or none, in place of the committed 3.  For the G1 pair
finish: its element before the carry chains (`mont::Fp`, no minimum of
blocks), no minimum or a minimum of 3 or 5 blocks an SM in place of the
committed 4, inv loaded on the active lanes only (a copy or zero lane
needs none), and the G1 pair kernels' level-1 rows staged in the
lane-pair kernels' shared-memory tile (`staged`).  For the batch
inversion (csrc/batch_inv.cu): other blocks of T threads of C lanes, and
in degree 2 the norm recomputed in the down kernel in place of the one
the up kernel stores.  For the wide NTT passes (csrc/ntt_wide.cu): radix
4 or 16 in place of 8 (RADIX_LG stages a pass), radix 16 on 128 threads
a block, and no minimum of blocks an SM or a minimum of 1 or 3 in place
of the committed 2.  The 31-bit and Goldilocks NTT passes are one text,
csrc/ntt_radix.cuh, whose shape each policy states (csrc/mont32.cuh,
csrc/gl64.cuh), so their variants change the policy's constants.  For
the 31-bit passes (csrc/ntt_mont32.cu): radix 8 or 32 in place of 16
(RADIX_LG), 4 rows a row block at lg 13 in place of 2 (ROW_TILE_LG 15: a
128 KiB tile, and clusters of 2), the transposed store by the block's
runs of rows in place of a cluster's runs of 8, 256 threads a block in
place of 512, no minimum of blocks an SM or a minimum of 1 or 3 in place
of 2, and the parent's unsigned Montgomery product (nine operations) in
place of the signed one (seven).  For the Goldilocks passes
(csrc/ntt_gl64.cu; committed: radix 16, 256 threads, 3 row blocks and 2
column blocks an SM, the last pass's three stages' twiddles from device
memory, 4 columns a column block at lg 11, 32-byte runs of 4 rows
through a cluster at lg 12-13, the ops on carry chains): radix 8; 512
threads with 1 block an SM; 2 row blocks; 3 column blocks; one stage's
twiddles from device memory, with 3 row blocks (2 fit by shared memory)
or 2; the full stage-major twiddle table in shared memory (128 KiB at lg
13: 1 block an SM); 8 columns a column block (COL_TILE_LG 14: 1 block an
SM); 64-byte runs of 8 rows (clusters of 8 at lg 13); the transposed
store by the block's runs of rows in place of a cluster's; the parent's
64-bit C++ ops (sums, compares and selects).  Each Goldilocks variant
is also timed with its row pass in natural order (no out_t) and through
the entry points, the NTT 2^24 (`ntt.base_dev`) and the LDE 2^24 x4
(`ntt.lde_dev`), on its library.
The point kernels' variants are built at n32 = 12 only.  The script
prints ptxas's registers and spills of each, and the static SASS
instructions by class of each N = 12 point kernel, N = 8 wide NTT kernel
and mont32 and Goldilocks NTT kernel (`cuobjdump -sass`: IMAD, IMAD.MOV,
IADD3, other integer, branch, memory, other), then each one's time by
CUDA events at the main paths' shapes on random words: the G2 add at
147,456 lanes (the G2 slab's fold), every lane taking the fast leg; the
G2 pair prep and finish at level 1's 6,459,904 lanes through a table of
2^24 + 1 rows (the G2 tree 2^23's) and a random row a side, 35% of the
lanes reading the zero row as the tree's padding does (ZERO_PAIRS), the
finish on the prep's flags, and both at level 2's 3,229,952 lanes on the
even and odd lanes of a limb-major level (a parent build takes level 1's
rows gathered, as its tree did); the G1 madd at 294,912 lanes through a
table of 589,825 rows and a random slot index, and the G1 add at 294,912
lanes, every lane on the fast leg; the G1 dbl at 16 lanes (the
integrate's, by its C entry point on views made once, so that
back-to-back launches time the device and not the wrapper) and at
262,144 lanes; the G1 pair finish and prep at level 1 of the G1 tree 2^24,
12,964,864 lanes through a table of 2 x 2^24 + 1 rows with ZERO_PAIRS'
padding, the finish on the prep's flags, and the finish at level 2,
6,482,432 lanes on the even and odd lanes of a limb-major level with the
same share of copy or zero lanes; the batch inversion's three launches
at the trees' level 1, 12,964,864 BLS12-381 Fp lanes and 6,459,904 Fp2
lanes; the wide NTT's column pass at (8, 256, 262144), lg 8, and its row
pass at (8, 256, 256, 1024), lg 10, out_t (the BLS12-381 Fr NTT 2^26's
shapes); the 31-bit and the Goldilocks column passes at (2048, 8192), lg
11, times the middle matrix, and their row passes at (2048, 8192), lg
13, out_t (the NTT 2^24's shapes; Goldilocks on any 64-bit words).  Two
rounds in opposite orders, each time over back-to-back calls that fill
at least 20 ms (_events_ms); each output equals the committed kernel's
word for word.  With --parent and both of ec_pair and ec_xyzz chosen,
the G1 tree MSM 2^24 (chip_smoke.py's input: 2^11 random points tiled,
seeded scalar words) runs through the entry point on the committed
libraries and on the parent's, in the order parent, committed,
committed, parent: the wall time of an invoke (median of 3), then one
invoke under torch.profiler for its device busy ms, the pair finish's
device ms and the dbl's device microseconds a launch; the results equal
each other.  The probes are one field op of each base-field element
at N = 8 and 12 (mul, sqr, add, sub, and a copy for the loads and stores
around it) and one Goldilocks op (mul, add, sub, canon, and a copy) in a
kernel of its own, whose SASS counts give the instructions of one op.
The committed kernels' own registers are printed by chip_smoke.py.
--sass also prints, for each point kernel, the memory instructions
before its first IMAD.WIDE (the order of its loads); --sass --parent DIR
builds the named point sources (default all) from the parent's text too
and says, for each N = 12 point kernel, whether the two builds give the
same instructions.  For the fp2 dbl (csrc/ec_fp2_dbl.cu; committed: the
lane pair on the carry-chain element, mont::Fp2PairCC): the lane pair on
mont::Fp2Pair (the fp2 add's element) and one thread a lane on
mont::Fp2CC, timed at the G2 integrate's 17 lanes by its C entry point
and at 2^18 lanes, and with any of them built, each one's device
microseconds a launch in one profiled G2 slab 2^23 and one G2 tree 2^23
invoke (g2_dbl_times; with --parent, the parent's one thread a lane on
mont::Fp2 too).
Nothing of the port calls this module.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import _build, ntt
from .ec import kernels as EK
from .ff import gl64 as G64
from .ff import kernels as FK
from .ntt import fused, kernels as NK
from .ntt.parameters import get_parameters
from .params import get_curve, get_field

ADD_LANES, FINISH_LANES, MADD_LANES = 147_456, 6_459_904, 294_912
#: the G1 tree 2^24's level 1 (INV_LANES) and its point table; level 2
G1_TABLE_ROWS = (2 << 24) + 1
G1_L2_LANES = 6_482_432
#: the G1 dbl: the integrate's lanes, and a wide shape; the G2 dbl's
#: integrate runs on 17 lanes
DBL_LANES, DBL_WIDE_LANES = 16, 1 << 18
FP2_DBL_LANES = 17
#: the fp2 dbl's dispatch (csrc/ec_fp2_dbl.cu)
FP2_DBL = "ec::dispatch<mont::Fp2PairCC, ec::DBL>"
#: the G2 MSMs the fp2 dbl's variants run in: the slab and the tree 2^23
G2_LG = 23
#: the G1 tree MSM the --parent run times end to end
TREE_LG = 24
#: the G2 tree 2^23's point table: 2 n + 1 rows, the last the zero row
TABLE_ROWS = (2 << 23) + 1
#: the shares of level-1 lanes with both slots padding (the zero row) and
#: with the odd slot alone: the G2 tree 2^23's level 1 has 35% copy or
#: zero lanes (PERF.md), nearly all (zero, zero), since a run's padding
#: fills its end
ZERO_PAIRS = (0.33, 0.02)
INV_LANES = 12_964_864          # the G1 tree's level 1; G2's: FINISH_LANES
#: the point kernels by their template's op number (csrc/ec_kernel.cuh)
OPS = ("xyzz_madd", "xyzz_add", "xyzz_dbl", "pair_prep", "pair_finish")
BOUNDS = "__launch_bounds__(THREADS)"
#: the minimum of blocks an SM of the G1 carry-chain kernels: the pair
#: finish's, then the madd, add and dbl's (csrc/ec_kernel.cuh:
#: cc_min_blocks; 0 launches the kernel with none)
FINISH_BLOCKS, XYZZ_BLOCKS = 4, 3
CC_BLOCKS = f"OP == PAIR_FINISH ? {FINISH_BLOCKS} : {XYZZ_BLOCKS}"


def _cc_blocks(finish=FINISH_BLOCKS, xyzz=XYZZ_BLOCKS):
    """A substitution of the G1 carry-chain kernels' minimums of blocks."""
    return (CC_BLOCKS, f"OP == PAIR_FINISH ? {finish} : {xyzz}")
#: the point kernels' sources (csrc/<source>.cu)
POINT_SOURCES = ("ec_xyzz", "ec_pair", "ec_fp2_madd", "ec_fp2_add",
                 "ec_fp2_dbl", "ec_fp2_pair")
#: the sources whose kernels --sass and the variants' builds count
SASS_SOURCES = POINT_SOURCES + ("ntt_wide", "ntt_mont32", "ntt_gl64")
#: the wide NTT's field and its passes' shapes on the NTT 2^26's path
WIDE_FIELD = "bls12_381_fr"
WIDE_COLS = ((8, 256, 262144), 8)
WIDE_ROWS = ((8, 256, 256, 1024), 10)
#: csrc/ntt_wide.cu's row and column kernels' bounds
WIDE_BOUNDS = "__launch_bounds__(THREADS, 2)"
#: the 31-bit NTT's field and its passes' shapes on the NTT 2^24's path:
#: (shape, lg) of the column pass (with the middle matrix) and the row pass
#: (out_t)
NARROW_FIELD, NARROW_LG = "baby_bear", 24
NARROW_COLS = ((2048, 8192), 11)
NARROW_ROWS = ((2048, 8192), 13)
#: the transposed store by a block's runs of rows in place of a cluster's
NO_CLUSTERS = (": lgr < RL && b % (1 << RL) == 0",
               ": false && b % (1 << RL) == 0")
#: the Goldilocks NTT 2^24's passes (the same shapes, int64 words)
GL64_FIELD, GL64_LG, GL64_BLOWUP = "goldilocks", 24, 2
#: the parent's Goldilocks ops: 64-bit C++ sums, compares and selects, in
#: place of csrc/gl64.cuh's carry chains
GL64_OPS_CXX = """    GL64_HD word add(word a, word b) const {
        word s = a + b;
        word m = s < a ? 0xFFFFFFFFull : 0;
        s += m;
        return s + (s < m ? 0xFFFFFFFFull : 0);
    }

    GL64_HD word sub(word a, word b) const {
        word d = a - b;
        word m = a < b ? 0xFFFFFFFFull : 0;
        word d2 = d - m;
        return d2 - (d < m ? 0xFFFFFFFFull : 0);
    }

    GL64_HD word mul(word a, word b) const {
        word lo = a * b;
#ifdef __CUDA_ARCH__
        word hi = __umul64hi(a, b);
#else
        word hi = (word)(((unsigned __int128)a * b) >> 64);
#endif
        word w3 = hi >> 32, w2 = hi & 0xFFFFFFFFull;
        word r = lo - w3;
        r -= lo < w3 ? 0xFFFFFFFFull : 0;
        word u = (w2 << 32) - w2;
        word s = r + u;
        return s + (s < u ? 0xFFFFFFFFull : 0);
    }

"""


def _gl64_ops():
    """csrc/gl64.cuh's add, sub and mul, as they stand."""
    text = (_build.CSRC / "gl64.cuh").read_text()
    return text[text.index("    GL64_HD word add("):
                text.index("    GL64_HD word canon(")]


#: csrc/mont32.cuh's signed product, and the parent's unsigned one
MONT32_MUL = ("const unsigned int m = lo * pinv;\n"
              "        const unsigned int t = umulhi(a, b) - umulhi(m, p);\n"
              "        return umin(t, t + p);")
MONT32_MUL_UNSIGNED = (
    "const unsigned int m = lo * (0u - pinv);\n"
    "        const unsigned int t = umulhi(a, b) + umulhi(m, p) + (lo != 0);\n"
    "        return umin(t, t - p);")


def _shape(policy, name, old, new):
    """A substitution of one of csrc/<policy>.cuh's kernel shape constants
    (csrc/ntt_radix.cuh reads them from the policy)."""
    return (f"{policy}.cuh", f"static constexpr int {name} = {old};",
            f"static constexpr int {name} = {new};")


def _blocks(k):
    """A minimum of k blocks an SM for every kernel of the source."""
    return (BOUNDS, f"__launch_bounds__(THREADS, {k})")


def _blocks_name(source, k):
    return f"{source}, " + (f"{k} block{'s' * (k > 1)}" if k else
                            "no minimum")


def variants():
    """{name: (source, [(old, new) text substitutions])}; the name says
    what differs from the committed build."""
    out = {"ec_xyzz on mont::Fp": ("ec_xyzz", [
        ("ec::dispatch<mont::FpCC, ec::", "ec::dispatch<mont::Fp, ec::")]),
        **{_blocks_name("ec_xyzz", k): ("ec_xyzz", [_cc_blocks(xyzz=k)])
           for k in (0, 1, 2, 3) if k != XYZZ_BLOCKS},
        "ec_pair on mont::Fp": ("ec_pair", [
            ("ec::dispatch<mont::FpCC, ec::PAIR_FINISH",
             "ec::dispatch<mont::Fp, ec::PAIR_FINISH")]),
        **{_blocks_name("ec_pair", k): ("ec_pair", [_cc_blocks(finish=k)])
           for k in (0, 3, 4, 5) if k != FINISH_BLOCKS},
        "ec_pair inv on active lanes": ("ec_pair", [
            ("E inv = load<E>(a.in[4], i);",
             "E inv = f & pair::ACTIVE ? load<E>(a.in[4], i)\n"
             "                                    : mont::Elem<E>::zero();")]),
        "ec_pair staged": ("ec_pair", [
            ("constexpr bool staged = mont::Elem<E>::THREADS == 2;",
             "constexpr bool staged = true;")])}
    for source, op in (("ec_fp2_add", "ADD"), ("ec_fp2_pair", "PAIR_FINISH"),
                       ("ec_fp2_pair", "PAIR_PREP")):
        what = " prep" if op == "PAIR_PREP" else ""
        out[f"{source}{what} one thread a lane"] = (source, [
            (f"ec::dispatch<mont::Fp2Pair, ec::{op}",
             f"ec::dispatch<mont::Fp2, ec::{op}")])
    # the fp2 dbl's elements: the lane pair on mont::Fp (the fp2 add's),
    # and one thread a lane on mont::Fp2CC (the committed element's
    # coefficients without the lane pair)
    for what, elem in (("lane pair on mont::Fp2Pair", "Fp2Pair"),
                       ("one thread on mont::Fp2CC", "Fp2CC")):
        out[f"ec_fp2_dbl {what}"] = ("ec_fp2_dbl", [
            (FP2_DBL, FP2_DBL.replace("Fp2PairCC", elem))])
    for source in ("ec_fp2_add", "ec_fp2_pair"):
        for k in (1, 2, 3, 4):
            out[f"{source}, {k} block{'s' * (k > 1)}"] = (source,
                                                          [_blocks(k)])
    tile = "a.tile = TABLE && (OP == PAIR_PREP || OP == PAIR_FINISH) &&"
    out["ec_fp2_pair prep direct loads"] = ("ec_fp2_pair", [
        (tile, "a.tile = TABLE && OP == PAIR_FINISH &&")])
    out["ec_fp2_pair direct loads"] = ("ec_fp2_pair", [
        (tile, "a.tile = false && OP == PAIR_FINISH &&")])
    out["ec_fp2_pair tile in L2 only"] = ("ec_fp2_pair", [
        ("cp.async.ca.shared.global", "cp.async.cg.shared.global")])
    block = [(f"constexpr int {k} = {v};", f"constexpr int {k} = {{}};")
             for k, v in (("T", FK.INV_THREADS), ("C", FK.INV_CHUNK))]
    for t, c in ((32, 32), (64, 16), (64, 32), (128, 4), (128, 8),
                 (128, 16), (128, 32), (256, 8), (256, 16)):
        out[f"batch_inv T {t} C {c}"] = ("batch_inv", [
            (old, new.format(v)) for (old, new), v in zip(block, (t, c))])
    for k in (2, 4):
        out[f"ntt_wide radix {1 << k}"] = ("ntt_wide", [
            ("constexpr int RADIX_LG = 3;",
             f"constexpr int RADIX_LG = {k};")])
    out["ntt_wide radix 16, 128 threads"] = ("ntt_wide", [
        ("constexpr int RADIX_LG = 3;", "constexpr int RADIX_LG = 4;"),
        ("constexpr int THREADS = 256;", "constexpr int THREADS = 128;")])
    out["ntt_wide, no minimum"] = ("ntt_wide", [
        (WIDE_BOUNDS, "__launch_bounds__(THREADS)")])
    for k in (1, 3):
        out[f"ntt_wide, {k} block{'s' * (k > 1)}"] = ("ntt_wide", [
            (WIDE_BOUNDS, f"__launch_bounds__(THREADS, {k})")])
    for k in (3, 5):
        out[f"ntt_mont32 radix {1 << k}"] = ("ntt_mont32", [
            _shape("mont32", "RADIX_LG", 4, k)])
    out["ntt_mont32 4 rows a block"] = ("ntt_mont32", [
        _shape("mont32", "ROW_TILE_LG", 14, 15)])
    out["ntt_mont32 rows without clusters"] = ("ntt_mont32", [NO_CLUSTERS])
    out["ntt_mont32 256 threads"] = ("ntt_mont32", [
        _shape("mont32", "THREADS", 512, 256)])
    out["ntt_mont32, no minimum"] = ("ntt_mont32", [
        (f"__launch_bounds__(F::THREADS, F::{k}_MIN_BLOCKS)",
         "__launch_bounds__(F::THREADS)") for k in ("ROW", "COL")])
    for k in (1, 3):
        out[f"ntt_mont32, {k} block{'s' * (k > 1)}"] = ("ntt_mont32", [
            _shape("mont32", f"{w}_MIN_BLOCKS", 2, k) for w in ("ROW", "COL")])
    out["ntt_mont32 unsigned product"] = ("ntt_mont32", [
        (MONT32_MUL, MONT32_MUL_UNSIGNED)])
    gl64 = {"radix 8": [("RADIX_LG", 4, 3)],
            "512 threads, 1 block": [("THREADS", 256, 512),
                                     ("ROW_MIN_BLOCKS", 3, 1),
                                     ("COL_MIN_BLOCKS", 2, 1)],
            "2 row blocks": [("ROW_MIN_BLOCKS", 3, 2)],
            "3 column blocks": [("COL_MIN_BLOCKS", 2, 3)],
            "1 global stage": [("TW_GLOBAL", 3, 1)],
            "1 global stage, 2 row blocks": [("TW_GLOBAL", 3, 1),
                                             ("ROW_MIN_BLOCKS", 3, 2)],
            "full twiddle table": [("TW_GLOBAL", 3, 0)],
            "8 columns a block": [("COL_TILE_LG", 13, 14)],
            "64-byte runs": [("RUN_LG", 2, 3)]}
    for what, subs in gl64.items():
        out[f"ntt_gl64 {what}"] = ("ntt_gl64", [
            _shape("gl64", *s) for s in subs])
    out["ntt_gl64 rows without clusters"] = ("ntt_gl64", [NO_CLUSTERS])
    out["ntt_gl64 64-bit C++ ops"] = ("ntt_gl64", [
        ("gl64.cuh", _gl64_ops(), GL64_OPS_CXX)])
    out["batch_inv norm recomputed"] = ("batch_inv", [
        ("            store<N>(dn, n, i, d);\n", ""),
        ("load<N>(DEG == 1 ? x : dn, n, i)",
         "DEG == 1 ? load<N>(x, n, i) : norm(load<N>(x, n, i), "
         "load<N>(x + N * n, n, i), c)")])
    return out


def _make(name, source, subs, csrc=None):
    """Write the variant's sources, from csrc/ or the directory `csrc`
    (a parent's), the point kernels at N = 12 only; each substitution is
    (old, new), in the first file that holds old, or (file, old, new);
    returns (library, nvcc command)."""
    d = _build.BUILD / "variants" / re.sub(r"\W+", "_", name)
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    csrc = Path(csrc) if csrc else _build.CSRC
    files = [csrc / f"{source}.cu"] + sorted(csrc.glob("*.cuh"))
    text = {f.name: f.read_text() for f in files}
    text["ec_kernel.cuh"] = re.sub(
        r"\n\s*case (2|8): launch<F<\1>, OP[^>]*>\([^)]*\); break;", "",
        text["ec_kernel.cuh"])
    for sub in subs:
        old, new = sub[-2:]
        f = sub[0] if len(sub) == 3 else next(
            (f for f, t in text.items() if old in t), None)
        if f is None or old not in text[f]:
            raise ValueError(f"{name}: {old!r} not found")
        text[f] = text[f].replace(old, new)
    for f, t in text.items():
        (d / f).write_text(t)
    lib = d / f"lib{source}.so"
    return lib, [_build.nvcc(), *_build.FLAGS, "-o", str(lib),
                 str(d / f"{source}.cu")]


def _registers(log):
    """ptxas's lines for the N = 12 point and inversion kernels, the N = 8
    wide NTT kernels and the mont32 NTT kernels of a build log."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"ec_kernelIN4mont\d+(Fp2PairCC|Fp2Pair|Fp2CC|FpCC|"
                      r"Fp2|Fp)ILi12EEELi"
                      r"(\d)ELb([01])E", line)
        k = re.search(r"(inv_up|inv_down)ILi12ELi(\d)E", line)
        w = re.search(r"(rows|cols|mid)_kernelI(Li8E|\w*?(?:Mont32|Gl64))",
                      line)
        if "Compiling entry function" in line:
            entry = (_point_name(*m.groups()) if m else
                     f"{k.group(1)}<12,{k.group(2)}>" if k else
                     f"{w.group(1)}_kernel<{_elem(w.group(2))}>" if w
                     else None)
        elif entry and ("registers" in line or "spill" in line):
            out.append(f"{entry}: {line.strip()}")
    return out


#: SASS opcode classes, in the order sass_counts prints them
SASS_CLASSES = ("IMAD", "IMAD.MOV", "IADD3", "other integer", "branch",
                "memory", "other")
def _sass_class(op):
    if op.startswith("IMAD.MOV"):
        return "IMAD.MOV"
    if op.startswith(("IMAD", "IADD3")):
        return op.split(".")[0]
    if op.split(".")[0] in ("BRA", "BRX", "JMP", "JMX", "EXIT", "RET",
                            "CALL", "BSSY", "BSYNC", "BREAK", "WARPSYNC",
                            "BMOV"):
        return "branch"
    if re.match(r"U?(LD|ST|ATOM|RED|CCTL|DEPBAR)", op):
        return "memory"
    if re.match(r"(U?I|U?LOP|U?SHF|U?SEL|U?LEA|U?PLOP|P2R|R2P|U?MOV|"
                r"U?PRMT|U?FLO|U?POPC|U?BREV|VOTE|SHFL|S2R|S2UR|CS2R)", op):
        return "other integer"
    return "other"


def _elem(arg):
    """The element of an NTT kernel's mangled template argument."""
    return "8" if arg == "Li8E" else "Gl64" if arg.endswith("Gl64") \
        else "Mont32"


def _point_name(elem, op, table):
    """A point kernel's short name: its element at N = 12, its op, and
    ",table" for the build that reads a tree's first level through the
    index."""
    return f"{elem}<12>,{OPS[int(op)]}" + (",table" if table == "1" else "")


def _sass_name(mangled):
    """A short name for a point kernel or a probe at N = 12, a wide NTT
    kernel at N = 8 or a mont32 NTT kernel, else None."""
    m = re.search(r"ec_kernelIN4mont\d+(\w+?)ILi12EEELi(\d)ELb([01])E",
                  mangled)
    if m:
        return _point_name(*m.groups())
    m = re.search(r"(rows|cols|mid)_kernelI(Li8E|\w*?(?:Mont32|Gl64))",
                  mangled)
    if m:
        return f"{m.group(1)}_kernel<{_elem(m.group(2))}>"
    m = re.fullmatch(r"probe_(\w+)", mangled)
    return m.group(1) if m else None


def sass_counts(lib):
    """{kernel: {class: static instruction count}} from `cuobjdump -sass`
    of a built library: the N = 12 point kernels, the N = 8 wide NTT
    kernels and the probes, NOPs left out; for a kernel with carry-chain
    products, also its global loads before and after the first
    IMAD.WIDE.U32.X (the order of its loads)."""
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, name, chain = {}, None, set()
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _sass_name(m.group(1))
            if name:
                out[name] = dict.fromkeys(SASS_CLASSES + ("all",), 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if name and m and m.group(1) != "NOP":
            op = m.group(1)
            out[name][_sass_class(op)] += 1
            out[name]["all"] += 1
            if op.startswith("IMAD.WIDE.U32.X"):
                chain.add(name)
            if op.startswith("LDG"):
                key = "LDG after" if name in chain else "LDG before"
                out[name][key] = out[name].get(key, 0) + 1
    return {k: {**v, "LDG after": v.get("LDG after", 0)} if k in chain
            else v for k, v in out.items()}


def _sass_line(what, counts):
    return f"sass {what}: " + ", ".join(
        f"{k} {v}" for k, v in counts.items())


#: one field op of each element alone, between 2 N word loads and N stores:
#: the copy's count is the loads' and stores' own
PROBE_OPS = {"copy": "a", "mul": "mul(a, b, c)", "sqr": "sqr(a, c)",
             "add": "add(a, b, c)", "sub": "sub(a, b, c)"}


#: one Goldilocks op alone, between two word loads and one store
GL64_PROBE_OPS = {"copy": "a", "mul": "f.mul(a, b)", "add": "f.add(a, b)",
                  "sub": "f.sub(a, b)", "canon": "f.canon(a)"}


def _probe():
    """Build the probes of every base-field element the headers define, at
    N = 8 and 12; returns the library."""
    d = _build.BUILD / "variants" / "probe"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    heads = sorted(_build.CSRC.glob("mont*.cuh"))
    elems = [e for e in ("Fp", "FpCC") if any(
        f"struct {e} {{" in h.read_text() for h in heads)]
    text = "".join(f'#include "{h.name}"\n' for h in heads) + """
#define PROBE(E, N, NAME, EXPR)                                            \\
    extern "C" __global__ void probe_##NAME(                               \\
        const uint32_t* x, uint32_t* y, const mont::Consts<N> c) {         \\
        using namespace mont;                                              \\
        E<N> a, b;                                                         \\
        for (int w = 0; w < N; w++) {                                      \\
            a.w[w] = x[w * 128 + threadIdx.x];                             \\
            b.w[w] = x[(N + w) * 128 + threadIdx.x];                       \\
        }                                                                  \\
        E<N> r = EXPR;                                                     \\
        for (int w = 0; w < N; w++) y[w * 128 + threadIdx.x] = r.w[w];     \\
    }
"""
    for e in elems:
        for n in (8, 12):
            for op, expr in PROBE_OPS.items():
                text += f"PROBE(mont::{e}, {n}, {e}{n}_{op}, {expr})\n"
    text += '#include "gl64.cuh"\n' + """
#define GL64_PROBE(NAME, EXPR)                                             \\
    extern "C" __global__ void probe_gl64_##NAME(                          \\
        const unsigned long long* x, unsigned long long* y) {              \\
        const narrow::Gl64 f{};                                            \\
        const unsigned long long a = x[threadIdx.x];                       \\
        const unsigned long long b = x[128 + threadIdx.x];                 \\
        y[threadIdx.x] = EXPR;                                             \\
    }
"""
    for op, expr in GL64_PROBE_OPS.items():
        text += f"GL64_PROBE({op}, {expr})\n"
    (d / "probe.cu").write_text(text)
    lib = d / "libprobe.so"
    proc = subprocess.run([_build.nvcc(), *_build.FLAGS, "-I",
                           str(_build.CSRC), "-o", str(lib),
                           str(d / "probe.cu")], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc probe.cu:\n{proc.stdout}{proc.stderr}")
    return lib


def print_sass(sources, card):
    """ptxas's registers and the SASS counts of the committed N = 12 point
    kernels and N = 8 wide NTT kernels of `sources`, then of the
    probes."""
    info = _build.build(sources)
    for source in sources:
        for line in _registers(info.get(source, {}).get("log", "")):
            print(f"ptxas {source}: {line}")
        for k, c in sass_counts(_build._target(source)).items():
            print(_sass_line(f"{source} {k}", c) + f"  [{card}]")
    for k, c in sass_counts(_probe()).items():
        print(_sass_line(f"probe {k}", c) + f"  [{card}]", flush=True)


def _load(path, source):
    lib = ctypes.CDLL(str(path))
    sigs = {fn: [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
            for fn, s in EK.SOURCES.items() if s == source}
    if source == "batch_inv":
        sigs = FK._INV_SIGNATURES
    if source == "ntt_wide":
        sigs = NK._WIDE_SIGNATURES
    if source == "ntt_mont32":
        sigs = NK._MONT32_SIGNATURES
    if source == "ntt_gl64":
        sigs = NK._SIGNATURES
    for fn, argtypes in sigs.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def _events_ms(fn, reps=20, window_ms=20.0):
    """Device ms a call over back-to-back calls between two CUDA events,
    after a warm-up call; the count of calls grows until they take at
    least `window_ms`, so that a short kernel is not timed in the few
    milliseconds in which the card's clock is still rising."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    while True:
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        ms = start.elapsed_time(stop)
        if ms >= window_ms or reps >= 1 << 14:
            return ms / reps
        reps = min(1 << 14, reps * max(2, int(window_ms / max(ms, 0.01))
                                       + 1))


def _words(p, n32, shape, rng, dev):
    """Random canonical base-field words (n32, *shape) as int32."""
    w = rng.integers(0, 1 << 32, size=(n32,) + shape,
                     dtype=np.uint64).astype(np.uint32)
    w[-1] %= np.uint32(p >> (32 * (n32 - 1)))
    return torch.from_numpy(w.view(np.int32)).to(dev)


def _fp2(p, n32, shape, rng, dev):
    return torch.cat([_words(p, n32, shape, rng, dev),
                      _words(p, n32, shape, rng, dev)])


def _bare_dbl(curve, p):
    """The dbl of `curve`'s degree (ec_xyzz_dbl or ec_fp2_xyzz_dbl) on the
    point p by its C entry point, on views and an output made once, so
    that back-to-back calls time the device where the wrapper's host time
    (~0.04 ms a call) would hide it at a few lanes; the library is looked
    up at each call, so a variant's takes its place.  Returns the call,
    which returns [output]."""
    words, n = p[0].shape
    out = torch.empty((4 * words, n), dtype=torch.int32, device=p[0].device)
    views = np.zeros(5 * len(p), dtype=np.int64)
    for k, c in enumerate(p):
        views[5 * k:5 * k + 3] = (c.data_ptr(), c.stride(0), c.stride(1))
    args = (get_curve(curve).field.n_ref_limbs, views.ctypes.data,
            out.data_ptr(), n, EK._consts(curve).ctypes.data,
            torch.cuda.current_stream().cuda_stream)
    name = EK.kernel_name("xyzz_dbl", curve)
    EK._lib(name)

    def call(_keep=(p, views)):     # what args points to lives with call
        if getattr(_build._libs[EK.SOURCES[name]], name)(*args):
            raise RuntimeError(f"{name}: launch failed")
        return [out]
    return call


def tree_times(dev, card, parent):
    """The G1 tree MSM 2^TREE_LG (BLS12-381) through the entry point on the
    committed libraries of ec_pair and ec_xyzz and on the parent's
    (`parent`: {source: library}), in the order parent, committed,
    committed, parent: each an invoke's wall time (median of 3, after one
    invoke checked against the first), then one invoke under
    torch.profiler: the device's busy ms, the pair finish's device ms and
    launches and the dbl's device microseconds a launch.  The input and
    the profile's reading are chip_smoke.py's (msm_input,
    profile_breakdown)."""
    import chip_smoke as CS
    from torch.profiler import ProfilerActivity, profile
    from .msm import MSMContext

    curve = "bls12_381"
    t0 = time.perf_counter()
    _, pts, _, wd = CS.msm_input(curve, TREE_LG, dev)
    ctx = MSMContext(curve, 1 << TREE_LG, mode="tree")
    ctx.set_points(pts)
    del pts
    EK._lib("ec_pair_finish")
    EK._lib("ec_xyzz_dbl")
    committed = {s: _build._libs[s] for s in parent}
    print(f"tree G1 2^{TREE_LG}: input and points set in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    first = None
    try:
        for which in ("parent", "committed", "committed", "parent"):
            _build._libs.update(parent if which == "parent" else committed)
            got = ctx.invoke(wd)
            first = got if first is None else first
            if got != first:
                raise RuntimeError(f"tree G1 2^{TREE_LG}: the {which} "
                                   f"libraries give another result")
            wall = CS.wall_ms(lambda: ctx.invoke(wd), reps=3)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                ctx.invoke(wd)
                torch.cuda.synchronize()
                t_prof = (time.perf_counter() - t1) * 1e3
            busy, _, by_kernel, _ = CS.profile_breakdown(prof)
            fin = by_kernel.get("ec_pair_finish", (0.0, 0))
            dbl = by_kernel.get("ec_xyzz_dbl", (0.0, 0))
            print(f"tree G1 2^{TREE_LG} on the {which} ec_pair and ec_xyzz: "
                  f"wall {wall:.4f} ms (median of 3); profiled invoke: "
                  f"device busy {busy:.4f} of {t_prof:.4f} ms, "
                  f"ec_pair_finish {fin[0]:.4f} device ms ({fin[1]} "
                  f"launches), ec_xyzz_dbl {dbl[0]:.4f} device ms ("
                  f"{dbl[1]} launches, "
                  f"{dbl[0] / max(dbl[1], 1) * 1e3:.2f} us a launch)  "
                  f"[{card}]", flush=True)
    finally:
        _build._libs.update(committed)
    del ctx, wd
    torch.cuda.empty_cache()


def g2_dbl_times(dev, card, libs):
    """The fp2 dbl's device microseconds a launch in one profiled G2 slab
    2^G2_LG invoke and one G2 tree invoke (BLS12-381; chip_smoke.py's
    base points r_j G, msm_input's tiling and scalars) on each library of
    `libs` ({name: library of ec_fp2_dbl}), in the order given and back;
    each invoke's result equals the first."""
    import chip_smoke as CS
    from torch.profiler import ProfilerActivity, profile
    from .msm import MSMContext

    curve = "bls12_381_g2"
    t0 = time.perf_counter()
    _, _, base = CS.g2_base(curve, 1 << CS.LG_BASE, seed=42)
    _, pts, _, wd = CS.msm_input(curve, G2_LG, dev, base)
    ctxs = {}
    for mode in ("slab", "tree"):
        ctxs[mode] = MSMContext(curve, 1 << G2_LG, mode=mode)
        ctxs[mode].set_points(pts)
    del pts
    EK._lib("ec_fp2_xyzz_dbl")
    committed = _build._libs["ec_fp2_dbl"]
    print(f"G2 2^{G2_LG}: input and points set in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    first = {}
    order = list(libs)
    try:
        for name in order + order[::-1]:
            _build._libs["ec_fp2_dbl"] = libs[name]
            for mode, ctx in ctxs.items():
                got = ctx.invoke(wd)
                first.setdefault(mode, got)
                if got != first[mode]:
                    raise RuntimeError(f"G2 {mode} 2^{G2_LG}: {name} gives "
                                       f"another result")
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    ctx.invoke(wd)
                    torch.cuda.synchronize()
                _, _, by_kernel, _ = CS.profile_breakdown(prof)
                ms, k = by_kernel.get("ec_fp2_xyzz_dbl", (0.0, 0))
                print(f"G2 {mode} 2^{G2_LG} on {name}: ec_fp2_xyzz_dbl "
                      f"{ms:.4f} device ms, {k} launches, "
                      f"{ms / max(k, 1) * 1e3:.2f} us a launch  [{card}]",
                      flush=True)
    finally:
        _build._libs["ec_fp2_dbl"] = committed
    del ctxs, wd
    torch.cuda.empty_cache()


def sass_text(lib):
    """{kernel: [instruction, ...]} of the N = 12 point kernels and probes
    of a built library (`cuobjdump -sass`), addresses and encodings left
    out: two builds compiled to the same code give equal lists."""
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _sass_name(m.group(1))
            if name:
                out[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name and m:
            out[name].append(m.group(1))
    return out


def compare_sass(sources, parent, card):
    """Whether each N = 12 point kernel of `sources` compiles to the same
    instructions from the parent's text (the directory `parent`) as from
    the committed one."""
    todo = {s: _make(f"{s} parent sass", s, [], parent) for s in sources}
    procs = {s: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for s, (_, cmd) in todo.items()}
    _build.build(list(sources))
    for s, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {s} parent:\n{log}")
        old = sass_text(todo[s][0])
        new = sass_text(_build._target(s))
        for k in sorted(set(old) | set(new)):
            a, b = old.get(k), new.get(k)
            if a is None or b is None:
                what = "only in the " + ("committed" if a is None
                                         else "parent") + " build"
            elif a == b:
                what = f"identical ({len(a)} instructions)"
            else:
                at = next((i for i, (x, y) in enumerate(zip(a, b))
                           if x != y), min(len(a), len(b)))
                what = (f"differs: {len(a)} / {len(b)} instructions, first "
                        f"at {at}")
            print(f"sass vs parent {s} {k}: {what}  [{card}]", flush=True)


def main():
    if not torch.cuda.is_available():
        print("variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    args = sys.argv[1:]
    if args[:1] == ["--sass"]:
        if args[1:2] == ["--parent"]:
            compare_sass(args[3:] or list(POINT_SOURCES), args[2], card)
            return 0
        print_sass(args[1:] or list(SASS_SOURCES), card)
        return 0
    every = variants()
    parent = None
    if args[:1] == ["--parent"]:
        parent, args = args[1], args[2:]
    t0 = time.perf_counter()
    chosen = {name: v for name, v in every.items()
              if any(a in name for a in args or [""])
              and f"T {FK.INV_THREADS} C {FK.INV_CHUNK}" not in name}
    if parent:
        chosen.update({f"{s} parent": (s, []) for s in sorted(
            {v[0] for v in chosen.values()})})
    _build.build({v[0] for v in chosen.values()} | {"bigmont"})
    todo = {name: _make(name, *v, parent if name.endswith(" parent")
                        else None) for name, v in chosen.items()}
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
        if chosen[name][0] in SASS_SOURCES:
            for k, c in sass_counts(todo[name][0]).items():
                print(_sass_line(f"{name} {k}", c) + f"  [{card}]")
    for source in sorted({v[0] for v in chosen.values()}
                         & set(SASS_SOURCES)):
        for k, c in sass_counts(_build._target(source)).items():
            print(_sass_line(f"{source} committed {k}", c) + f"  [{card}]")
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if {"ec_pair parent", "ec_xyzz parent"} <= set(libs):
        tree_times(dev, card, {s: libs[f"{s} parent"]
                               for s in ("ec_pair", "ec_xyzz")})
    dbl_libs = {n: lib for n, lib in libs.items()
                if n.startswith("ec_fp2_dbl")}
    if dbl_libs:
        EK._lib("ec_fp2_xyzz_dbl")
        g2_dbl_times(dev, card, {**dbl_libs, "ec_fp2_dbl committed":
                                 _build._libs["ec_fp2_dbl"]})

    cp = get_curve("bls12_381_g2")
    p, n32 = cp.field.modulus, cp.field.n_ref_limbs
    W = 2 * n32
    rng = np.random.default_rng(8)
    sources = {v[0] for v in chosen.values()}
    if sources & {"ec_fp2_add", "ec_fp2_pair", "ec_xyzz", "batch_inv"}:
        pt = tuple(_fp2(p, n32, (ADD_LANES,), rng, dev) for _ in range(4))
        qt = tuple(_fp2(p, n32, (ADD_LANES,), rng, dev) for _ in range(4))
        # level 1 of the G2 tree: the point table and a random row a side,
        # the padding as the tree lays it out (ZERO_PAIRS); level 0's rows
        # gathered, for a parent, whose tree read them so
        tab = torch.cat([_fp2(p, n32, (TABLE_ROWS,), rng, dev),
                         _fp2(p, n32, (TABLE_ROWS,), rng, dev)])
        tab = tab.T.contiguous()
        tab[-1] = 0
        table = (tab[:, :W].T, tab[:, W:].T)
        idx = rng.integers(0, TABLE_ROWS - 1, size=(2, FINISH_LANES))
        u = rng.random(FINISH_LANES)
        zero = TABLE_ROWS - 1
        idx[1, u < sum(ZERO_PAIRS)] = idx[0, u < ZERO_PAIRS[0]] = zero
        idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
        rows = tab.index_select(0, idx.T.reshape(-1))      # (2 lanes, 2 W)
        l = (rows[0::2, :W].T, rows[0::2, W:].T)
        r = (rows[1::2, :W].T, rows[1::2, W:].T)
        # level 2: the even and odd lanes of a limb-major level
        X = _fp2(p, n32, (FINISH_LANES,), rng, dev)
        Y = _fp2(p, n32, (FINISH_LANES,), rng, dev)
        l2, r2 = (X[:, 0::2], Y[:, 0::2]), (X[:, 1::2], Y[:, 1::2])
        inv = _fp2(p, n32, (FINISH_LANES,), rng, dev)
        flags = EK.affine_pair_prep("bls12_381_g2", table, table,
                                    (idx[0], idx[1]))[1]
        g1 = tuple(_words(p, n32, (MADD_LANES,), rng, dev)
                   for _ in range(8))
        # the madd's points: a table of 2 MADD_LANES + 1 rows, a random row
        # a lane
        g1_rows = torch.cat([_words(p, n32, (2 * MADD_LANES + 1,), rng, dev)
                             for _ in range(2)]).T.contiguous()
        g1_table = (g1_rows[:, :n32].T, g1_rows[:, n32:].T)
        g1_idx = torch.from_numpy(rng.integers(
            0, 2 * MADD_LANES + 1, size=MADD_LANES).astype(np.int32)).to(dev)
        d1 = _words(p, n32, (INV_LANES,), rng, dev)
        d2 = _fp2(p, n32, (FINISH_LANES,), rng, dev)
        nr = cp.fp2.nr_small
    g = np.random.default_rng(15)
    if "ec_pair" in sources:
        # level 1 of the G1 tree 2^24: a random row of its point table a
        # side, the padding as the tree lays it out (ZERO_PAIRS); BLS12-381
        # G1's base field is the G2 curve's
        tab1 = torch.cat([_words(p, n32, (G1_TABLE_ROWS,), g, dev)
                          for _ in range(2)]).T.contiguous()
        tab1[-1] = 0
        table1 = (tab1[:, :n32].T, tab1[:, n32:].T)
        i1 = g.integers(0, G1_TABLE_ROWS - 1, size=(2, INV_LANES))
        u = g.random(INV_LANES)
        i1[1, u < sum(ZERO_PAIRS)] = i1[0, u < ZERO_PAIRS[0]] = \
            G1_TABLE_ROWS - 1
        i1 = torch.from_numpy(i1.astype(np.int32)).to(dev)
        ix1 = (i1[0], i1[1])
        inv1 = _words(p, n32, (INV_LANES,), g, dev)
        flags1 = EK.affine_pair_prep("bls12_381", table1, table1, ix1)[1]
        # level 2: the even and odd lanes of a limb-major level, the same
        # share of zero pairs
        X1, Y1 = (_words(p, n32, (2 * G1_L2_LANES,), g, dev)
                  for _ in range(2))
        u = g.random(G1_L2_LANES)
        for side, share in ((0, ZERO_PAIRS[0]), (1, sum(ZERO_PAIRS))):
            lanes = torch.from_numpy(
                np.flatnonzero(u < share) * 2 + side).to(dev)
            X1[:, lanes] = 0
            Y1[:, lanes] = 0
        l21, r21 = (X1[:, 0::2], Y1[:, 0::2]), (X1[:, 1::2], Y1[:, 1::2])
        inv21 = _words(p, n32, (G1_L2_LANES,), g, dev)
        flags21 = EK.affine_pair_prep("bls12_381", l21, r21)[1]
    if "ec_xyzz" in sources:
        dbl16 = _bare_dbl("bls12_381", tuple(
            _words(p, n32, (DBL_LANES,), g, dev) for _ in range(4)))
        dblw = tuple(_words(p, n32, (DBL_WIDE_LANES,), g, dev)
                     for _ in range(4))
    if "ec_fp2_dbl" in sources:
        dbl17 = _bare_dbl("bls12_381_g2", tuple(
            _fp2(p, n32, (FP2_DBL_LANES,), g, dev) for _ in range(4)))
        dblw2 = tuple(_fp2(p, n32, (DBL_WIDE_LANES,), g, dev)
                      for _ in range(4))
    if "ntt_wide" in sources:
        pw = get_parameters(WIDE_FIELD, dev)
        fr = get_field(WIDE_FIELD)
        (cshape, clg), (rshape, rlg) = WIDE_COLS, WIDE_ROWS
        xc = _words(fr.modulus, fr.n_ref_limbs, cshape[1:], rng, dev)
        xr = _words(fr.modulus, fr.n_ref_limbs, rshape[1:], rng, dev)
        twc, twr = pw.power_table(clg, True), pw.power_table(rlg, False)
    if "ntt_mont32" in sources:
        fb = get_field(NARROW_FIELD)
        (ncshape, nclg), (nrshape, nrlg) = NARROW_COLS, NARROW_ROWS
        ntw1, nmid, ntw2 = fused.fused_tables(NARROW_FIELD, NARROW_LG, False,
                                              dev)
        nxc = _words(fb.modulus, 1, ncshape, rng, dev)[0]
        nxr = _words(fb.modulus, 1, nrshape, rng, dev)[0]
    if "ntt_gl64" in sources:
        # any 64-bit words, as the Goldilocks kernels take them
        gtw1, gmid, gtw2 = fused.fused_tables(GL64_FIELD, GL64_LG, False,
                                              dev)
        gxc, gxr = (torch.from_numpy(rng.integers(
            -1 << 63, 1 << 63, size=NARROW_COLS[0] if k == 0
            else NARROW_ROWS[0], dtype=np.int64)).to(dev) for k in (0, 1))
        gx24 = G64.from_wire(rng.integers(
            0, get_field(GL64_FIELD).modulus, size=1 << GL64_LG,
            dtype=np.uint64), dev)
    calls = {"ec_fp2_add": lambda: EK.xyzz_add("bls12_381_g2", pt, qt),
             "ec_fp2_pair": lambda: EK.affine_pair_finish(
                 "bls12_381_g2", table, table, inv, flags, (idx[0], idx[1])),
             "ec_fp2_pair_prep": lambda: EK.affine_pair_prep(
                 "bls12_381_g2", table, table, (idx[0], idx[1])),
             "ec_fp2_pair_prep_l2": lambda: EK.affine_pair_prep(
                 "bls12_381_g2", l2, r2),
             "ec_fp2_pair_l2": lambda: EK.affine_pair_finish(
                 "bls12_381_g2", l2, r2, inv[:, 0::2], flags[0::2]),
             "ec_xyzz": lambda: EK.xyzz_madd("bls12_381", g1[:4], g1_table,
                                             g1_idx),
             "ec_xyzz_add": lambda: EK.xyzz_add("bls12_381", g1[:4],
                                                g1[4:]),
             "ec_xyzz_dbl": lambda: dbl16(),
             "ec_xyzz_dbl_wide": lambda: EK.xyzz_dbl("bls12_381", dblw),
             "ec_fp2_dbl": lambda: dbl17(),
             "ec_fp2_dbl_wide": lambda: EK.xyzz_dbl("bls12_381_g2", dblw2),
             "ec_pair": lambda: EK.affine_pair_finish(
                 "bls12_381", table1, table1, inv1, flags1, ix1),
             "ec_pair_prep": lambda: EK.affine_pair_prep(
                 "bls12_381", table1, table1, ix1),
             "ec_pair_l2": lambda: EK.affine_pair_finish(
                 "bls12_381", l21, r21, inv21, flags21),
             "batch_inv": lambda: [FK.mont_batch_inv(d1, cp.field)],
             "batch_inv_fp2": lambda: [FK.mont_batch_inv(d2, cp.field, 2,
                                                         nr)],
             "ntt_wide": lambda: [NK.wide_cols(WIDE_FIELD, xc, twc, clg)],
             "ntt_wide_rows": lambda: [NK.wide_rows(WIDE_FIELD, xr, twr, rlg,
                                                    out_t=True)],
             "ntt_mont32": lambda: [NK.mont32_cols(NARROW_FIELD, nxc, ntw1,
                                                   nclg, nmid)],
             "ntt_mont32_rows": lambda: [NK.mont32_rows(
                 NARROW_FIELD, nxr, ntw2, nrlg, out_t=True)],
             "ntt_gl64": lambda: [NK.ntt_cols(gxc, gtw1, NARROW_COLS[1],
                                              gmid)],
             "ntt_gl64_rows": lambda: [NK.ntt_rows(gxr, gtw2, NARROW_ROWS[1],
                                                   out_t=True)],
             "ntt_gl64_rows_natural": lambda: [NK.ntt_rows(
                 gxr, gtw2, NARROW_ROWS[1])],
             "ntt_gl64_ntt": lambda: [ntt.base_dev(GL64_FIELD, gx24,
                                                   GL64_LG)],
             "ntt_gl64_lde": lambda: [ntt.lde_dev(GL64_FIELD, gx24, GL64_LG,
                                                  GL64_BLOWUP)]}

    # a parent's calls where its kernels took other operands: level 1's
    # gathered rows
    parent_calls = {
        "ec_fp2_pair": lambda: EK.affine_pair_finish("bls12_381_g2", l, r,
                                                     inv, flags),
        "ec_fp2_pair_prep": lambda: EK.affine_pair_prep("bls12_381_g2", l,
                                                        r)}
    # the other calls of a source: batch_inv's in degree 2, ec_xyzz's add
    # and dbl, the NTT sources' row passes, ec_fp2_pair's prep at levels
    # 1 and 2 and its finish at level 2, ec_pair's prep at level 1 and its
    # finish at level 2
    twins = {"batch_inv_fp2": "batch_inv", "ec_xyzz_add": "ec_xyzz",
             "ec_fp2_dbl_wide": "ec_fp2_dbl",
             "ec_xyzz_dbl": "ec_xyzz", "ec_xyzz_dbl_wide": "ec_xyzz",
             "ec_pair_prep": "ec_pair", "ec_pair_l2": "ec_pair",
             "ntt_wide_rows": "ntt_wide", "ntt_mont32_rows": "ntt_mont32",
             "ntt_gl64_rows": "ntt_gl64", "ntt_gl64_ntt": "ntt_gl64",
             "ntt_gl64_rows_natural": "ntt_gl64",
             "ntt_gl64_lde": "ntt_gl64",
             "ec_fp2_pair_prep": "ec_fp2_pair",
             "ec_fp2_pair_prep_l2": "ec_fp2_pair",
             "ec_fp2_pair_l2": "ec_fp2_pair"}

    def source_of(call):
        return twins.get(call, call)

    calls = {k: f for k, f in calls.items() if source_of(k) in sources}
    want = {s: [c.clone() for c in fn()] for s, fn in calls.items()}
    torch.cuda.synchronize()
    runs = [f"{s} committed" for s in calls]
    for name in libs:
        runs.append(name)
        runs += [twin + name[len(src):] for twin, src in twins.items()
                 if re.match(r"\w+", name).group() == src]
    times = {name: [] for name in runs}
    block = (FK.INV_THREADS, FK.INV_CHUNK)
    for order in (runs, runs[::-1]):
        for name in order:
            call = re.match(r"\w+", name).group()
            source = source_of(call)
            variant = source + name[len(call):]
            committed = _build._libs[source]
            if variant in libs:
                _build._libs[source] = libs[variant]
            m = re.search(r"T (\d+) C (\d+)", name)
            FK.INV_THREADS, FK.INV_CHUNK = map(int, m.groups()) if m \
                else block
            fn = calls[call]
            if name.endswith(" parent"):
                fn = parent_calls.get(call, fn)
            try:
                got = fn()
                torch.cuda.synchronize()
                if not all(torch.equal(g, w)
                           for g, w in zip(got, want[call])):
                    raise RuntimeError(f"{name}: output differs from the "
                                       "committed kernel")
                del got
                times[name].append(_events_ms(fn))
            finally:
                _build._libs[source] = committed
                FK.INV_THREADS, FK.INV_CHUNK = block
    shape_of = {"ec_fp2_add": ADD_LANES, "ec_fp2_pair": FINISH_LANES,
                "ec_fp2_pair_prep": FINISH_LANES,
                "ec_fp2_pair_prep_l2": FINISH_LANES // 2,
                "ec_fp2_pair_l2": FINISH_LANES // 2,
                "ec_xyzz": MADD_LANES, "ec_xyzz_add": MADD_LANES,
                "ec_xyzz_dbl": DBL_LANES, "ec_xyzz_dbl_wide": DBL_WIDE_LANES,
                "ec_fp2_dbl": FP2_DBL_LANES,
                "ec_fp2_dbl_wide": DBL_WIDE_LANES,
                "ec_pair": INV_LANES, "ec_pair_prep": INV_LANES,
                "ec_pair_l2": G1_L2_LANES,
                "batch_inv": INV_LANES,
                "batch_inv_fp2": FINISH_LANES}
    shape_of = {k: f"{v} lanes" for k, v in shape_of.items()}
    for k, what in (("ec_pair", "level 1 through the index"),
                    ("ec_pair_prep", "level 1 through the index"),
                    ("ec_pair_l2", "level 2 in place"),
                    ("ec_xyzz_dbl", "by its C entry point"),
                    ("ec_fp2_dbl", "by its C entry point")):
        shape_of[k] += f", {what}"
    shape_of["ntt_wide"] = f"{WIDE_COLS[0]}, lg {WIDE_COLS[1]}"
    shape_of["ntt_wide_rows"] = f"{WIDE_ROWS[0]}, lg {WIDE_ROWS[1]}, out_t"
    shape_of["ntt_mont32"] = (f"{NARROW_COLS[0]}, lg {NARROW_COLS[1]}, "
                              f"times the middle matrix")
    shape_of["ntt_mont32_rows"] = (f"{NARROW_ROWS[0]}, lg {NARROW_ROWS[1]}, "
                                   f"out_t")
    shape_of["ntt_gl64"] = shape_of["ntt_mont32"]
    shape_of["ntt_gl64_rows"] = shape_of["ntt_mont32_rows"]
    shape_of["ntt_gl64_rows_natural"] = (f"{NARROW_ROWS[0]}, lg "
                                         f"{NARROW_ROWS[1]}, natural order")
    shape_of["ntt_gl64_ntt"] = f"2^{GL64_LG}, ntt.base_dev"
    shape_of["ntt_gl64_lde"] = (f"2^{GL64_LG} x{1 << GL64_BLOWUP}, "
                                f"ntt.lde_dev")
    for name in runs:
        what = shape_of[re.match(r"\w+", name).group()]
        print(f"time {name} at {what}: " + " / ".join(
            f"{t:.4f}" for t in times[name]) + f" ms (rounds 1 / 2)  "
            f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
