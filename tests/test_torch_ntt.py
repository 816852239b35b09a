"""The port's NTT facade (sppark_tpu_torch.ntt) against the JAX package's
(sppark_tpu.ntt) on the CPU, where the port's kernels take their plain
versions: the same wire words from a seeded numpy generator through both,
compared exactly.  Also the four-step and six-step branches (caps lowered),
the LDE family, import hygiene and the no-silent-CPU rule."""

import ast
import itertools
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from sppark_tpu import ntt as jntt
from sppark_tpu import params as jparams
from sppark_tpu.oracle import ntt as joracle
from sppark_tpu_torch import ntt as tntt
from sppark_tpu_torch.ntt import fused
from sppark_tpu_torch.util.errors import SpparkError

ROOT = pathlib.Path(__file__).resolve().parent.parent
P = jparams.GOLDILOCKS.modulus
CONFIGS = list(itertools.product(["NN", "NR", "RN", "RR"], [0, 1], [0, 1]))


def _wire(seed, n):
    return np.random.default_rng(seed).integers(0, P, size=n,
                                                dtype=np.uint64)


def _both(field, x, lg, order, direction, coset):
    args = (lg,)
    got = tntt.base(field, x, *args, tntt.InputOutputOrder(order),
                    tntt.Direction(direction), tntt.Type(coset),
                    device="cpu")
    want = jntt.base(field, x, *args, jntt.InputOutputOrder(order),
                     jntt.Direction(direction), jntt.Type(coset))
    return got, np.asarray(want, dtype=np.uint64)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_facade_vs_jax_all_configs(cfg):
    """Every order x direction x type through both packages at lg 3."""
    got, want = _both("goldilocks", _wire(1, 8), 3, *cfg)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("lg", list(range(1, 11)))
def test_facade_vs_jax_by_lg(lg):
    """One configuration per lg against the JAX package (cycling through
    the 16), and all 16 against the JAX package's big-int oracle."""
    x = _wire(lg, 1 << lg)
    cfg = CONFIGS[(lg * 7) % len(CONFIGS)]
    got, want = _both("goldilocks", x, lg, *cfg)
    assert np.array_equal(got, want)
    ints = [int(v) for v in x]
    for order, direction, coset in CONFIGS:
        got = tntt.base("goldilocks", x, lg, tntt.InputOutputOrder(order),
                        tntt.Direction(direction), tntt.Type(coset),
                        device="cpu")
        exp = joracle.apply_order(jparams.GOLDILOCKS, ints, lg, order,
                                  bool(direction)) if not coset else None
        if coset:
            xin = joracle.bit_reverse(ints, lg) if order[0] == "R" else ints
            exp = joracle.coset_ntt(jparams.GOLDILOCKS, xin, bool(direction))
            if order[1] == "R":
                exp = joracle.bit_reverse(exp, lg)
        assert [int(v) for v in got] == exp, (order, direction, coset)


def test_plonky2_generator_vs_jax():
    got, want = _both("goldilocks_plonky2", _wire(5, 32), 5, "NR", 1, 1)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("cfg", [("NN", 0, 0), ("RN", 1, 1), ("NR", 0, 1),
                                 ("RR", 1, 0)],
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_four_step_vs_jax(cfg, monkeypatch):
    """lg > LG_TILE: column pass with the middle matrix, transposed row
    pass; R orders by standalone bit reversal; the inverse's 1/N in the
    middle matrix."""
    monkeypatch.setattr(fused, "LG_TILE", 4)
    got, want = _both("goldilocks", _wire(6, 64), 6, *cfg)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("lg", [7, 9])
def test_six_step_vs_jax(lg, monkeypatch):
    """lg > LG_COL_CAP + LG_TILE: the row side recurses (two levels at lg 9),
    only the top level scales the inverse."""
    monkeypatch.setattr(fused, "LG_TILE", 3)
    monkeypatch.setattr(fused, "LG_COL_CAP", 2)
    x = _wire(lg, 1 << lg)
    for direction in (0, 1):
        got, want = _both("goldilocks", x, lg, "NN", direction, 0)
        assert np.array_equal(got, want), direction


def test_lde_family_vs_jax(monkeypatch):
    """lde / lde_aux_dev / lde_powers_dev / lde_expand_dev at lg 6 blowup 2;
    the extension also through the six-step (caps lowered)."""
    from sppark_tpu.ff import get_jax_field
    from sppark_tpu_torch.ff import gl64

    F = get_jax_field("goldilocks")
    lg, blowup = 6, 2
    x = _wire(9, 1 << lg)
    want = np.asarray(jntt.lde("goldilocks", x, lg, blowup), dtype=np.uint64)
    assert np.array_equal(tntt.lde("goldilocks", x, lg, blowup, device="cpu"),
                          want)
    xd = gl64.from_wire(x)
    ext, coeffs = tntt.lde_aux_dev("goldilocks", xd, lg, blowup)
    jext, jcoeffs = jntt.lde_aux_dev("goldilocks", F.from_wire_np(x), lg,
                                     blowup)
    assert np.array_equal(gl64.to_wire(ext), F.to_wire_np(jext))
    assert np.array_equal(gl64.to_wire(coeffs), F.to_wire_np(jcoeffs))
    for bitrev in (False, True):
        got = tntt.lde_powers_dev("goldilocks", xd, lg, bitrev)
        exp = jntt.lde_powers_dev("goldilocks", F.from_wire_np(x), lg, bitrev)
        assert np.array_equal(gl64.to_wire(got), F.to_wire_np(exp))
    got = tntt.lde_expand_dev("goldilocks", xd, lg, blowup)
    exp = jntt.lde_expand_dev("goldilocks", F.from_wire_np(x), lg, blowup)
    assert np.array_equal(gl64.to_wire(got), F.to_wire_np(exp))
    monkeypatch.setattr(fused, "LG_TILE", 3)
    monkeypatch.setattr(fused, "LG_COL_CAP", 2)
    assert np.array_equal(tntt.lde("goldilocks", x, lg, blowup, device="cpu"),
                          want)


def test_domain_checks():
    x = torch.zeros(1 << 3, dtype=torch.int64)
    with pytest.raises(SpparkError):
        tntt.base_dev("goldilocks", torch.zeros(1, dtype=torch.int64), 33)
    with pytest.raises(ValueError):
        tntt.base_dev("goldilocks", x, 4)
    with pytest.raises(SpparkError):
        tntt.lde_dev("goldilocks", x, 3, 30)


def test_no_silent_cpu():
    """Host-array entry points run on the card unless told otherwise: with
    no card and no device they raise, they do not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = _wire(3, 8)
    for fn in (tntt.ntt, tntt.intt, tntt.coset_ntt, tntt.coset_intt):
        with pytest.raises(SpparkError):
            fn("goldilocks", x, 3)
    with pytest.raises(SpparkError):
        tntt.base("goldilocks", x, 3)
    with pytest.raises(SpparkError):
        tntt.lde("goldilocks", x, 3, 1)


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "jaxlib"
            or name.startswith("jaxlib.") or name == "sppark_tpu"
            or name.startswith("sppark_tpu."))


def test_import_hygiene():
    """Neither the port nor chip_smoke.py imports JAX or sppark_tpu: no
    import statement names them, and importing every module of the port
    (polynomial, parallel, ffi, util.slices and examples among them)
    loads none of them."""
    files = sorted((ROOT / "sppark_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    modules = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
        if path.parent.name != "sppark_tpu_torch" or path.stem != "__init__":
            rel = path.relative_to(ROOT).with_suffix("")
            if rel.parts[0] == "sppark_tpu_torch":
                parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
                modules.append(".".join(parts))
    for sub in ("polynomial", "parallel", "ffi", "util.slices", "examples"):
        assert any(m == f"sppark_tpu_torch.{sub}" or m.startswith(
            f"sppark_tpu_torch.{sub}.") for m in modules), sub
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'sppark_tpu.')) or "
        "m == 'sppark_tpu')\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
