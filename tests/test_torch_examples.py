"""The port's last public names against the JAX package's on the CPU, and
its two examples (sppark_tpu_torch/examples) run with --cpu.

  * CurveOps.affine_cneg and affine_infinity against the JAX package's
    CurveOps on test_bm64 and test_gl64; ntt/core.py:ntt_nn against
    sppark_tpu.ntt.core.ntt_nn on goldilocks, baby_bear and test_bm64_fr;
    one_wire_int and rand_ints of each family of fields against the JAX
    fields' from equal random.Random states; the BigMont roots, the
    Goldilocks zero tests and product-tree inversion and Fp2Field.inv;
    util.sppark_ok and runtime.accelerator_available;
  * the NTT example on goldilocks and baby_bear at lg 10, its transforms
    against the JAX package's big-int oracle on the same host arrays;
    the MSM example on test_gl64 at lg 8 against the JAX package's
    msm_naive, and on bn254 at lg 6 against the native host MSM, run as
    `python3 -m` (skipped where the native MSM does not build);
  * without a card and without --cpu both examples raise SpparkError.

Tolerance: exact words everywhere (integer field arithmetic).
"""

import math
import os
import pathlib
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from sppark_tpu_torch import params
from sppark_tpu_torch.ec import get_curve_ops
from sppark_tpu_torch.examples import msm_example, ntt_example
from sppark_tpu_torch.ff import bigmont, gl64
from sppark_tpu_torch.ff.bigmont import get_field_ops
from sppark_tpu_torch.ff.ext import BabyBear4Field, get_fp2_ops
from sppark_tpu_torch.ff.lane import get_lane_field
from sppark_tpu_torch.ff.mont32 import get_mont32_ops
from sppark_tpu_torch.ffi import cpu_available
from sppark_tpu_torch.ntt.core import elem_ops, ntt_nn
from sppark_tpu_torch.ntt.parameters import get_parameters
from sppark_tpu_torch.oracle.ec import AffinePoint, get_oracle
from sppark_tpu_torch.oracle.ntt import ntt_natural
from sppark_tpu_torch.runtime import accelerator_available
from sppark_tpu_torch.util import SpparkError, sppark_ok

ROOT = pathlib.Path(__file__).resolve().parent.parent


def to_jax(curve, t):
    """The port's coordinate words -> the JAX package's planes."""
    if params.get_curve(curve).field.modulus == gl64.P:
        return gl64.to_jax_planes(t[0])
    return bigmont.to_jax_planes(t)


# -- the point ops ---------------------------------------------------------------------

@pytest.mark.parametrize("curve", ["test_bm64", "test_gl64"])
def test_affine_cneg_and_infinity_vs_jax(curve):
    import jax.numpy as jnp
    from sppark_tpu.ec import get_curve_ops as jax_curve_ops
    o = get_oracle(params.get_curve(curve))
    rng = random.Random(5)
    pts = [o.random_point(rng) for _ in range(5)] + [o.infinity_affine()]
    flag = [True, False, True, True, False, True]
    ops, jops = get_curve_ops(curve), jax_curve_ops(curve)
    got = ops.affine_cneg(ops.affine_from_ints(pts), torch.tensor(flag))
    want = jops.affine_cneg(jops.affine_from_ints(pts), jnp.asarray(flag))
    for g, w in zip(got, want):
        assert np.array_equal(to_jax(curve, g), np.asarray(w))
    assert ops.affine_to_ints(got) == [
        (q.x, q.y) for q in (o.affine_neg(p) if f else p
                             for p, f in zip(pts, flag))]
    for shape in ((), (3,), (2, 4)):
        inf = ops.affine_infinity(shape, device="cpu")
        jinf = jops.affine_infinity(shape)
        assert all(np.array_equal(to_jax(curve, g), np.asarray(w))
                   for g, w in zip(inf, jinf))
        assert bool(ops.affine_is_inf(inf).all())


# -- ntt_nn ------------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["goldilocks", "baby_bear", "test_bm64_fr"])
def test_ntt_nn_vs_jax(field):
    import functools

    import jax
    from sppark_tpu.ff import get_jax_field
    from sppark_tpu.ntt import core as jcore
    from sppark_tpu.ntt.parameters import get_parameters as jax_parameters
    lg = 6
    fp = params.get_field(field)
    ints = [random.Random(lg).randrange(fp.modulus)
            for _ in range(1 << lg)]
    E = elem_ops(field)
    F = get_jax_field(field)
    tw = get_parameters(field).power_table(lg, False)
    got = ntt_nn(E, E.from_wire(F.to_wire_np(F.from_int_list(ints)), "cpu"),
                 lg, tw)
    run = jax.jit(functools.partial(jcore.ntt_nn, F, lg_n=lg))
    want = run(F.from_int_list(ints),
               twiddles=jax_parameters(field).power_table(lg, False))
    assert np.array_equal(E.to_wire(got), F.to_wire_np(want))
    assert F.to_int_list(want) == ntt_natural(fp, ints)


# -- the fields' host helpers ------------------------------------------------------------

def _jax_field(name):
    from sppark_tpu.ff import get_jax_field
    return get_jax_field(name)


@pytest.mark.parametrize("family,name", [
    ("gl64", "goldilocks"), ("mont32", "baby_bear"), ("mont32", "mersenne31"),
    ("bigmont", "bn254_fr"), ("bigmont", "goldilocks_bm"),
    ("lane", "goldilocks"), ("lane", "baby_bear")])
def test_one_wire_int_and_rand_ints_vs_jax(family, name):
    fp = params.get_field(name)
    F = {"gl64": lambda: gl64, "mont32": lambda: get_mont32_ops(name),
         "bigmont": lambda: get_field_ops(name),
         "lane": lambda: get_lane_field(fp)}[family]()
    J = _jax_field(name)
    assert F.one_wire_int() == J.one_wire_int()
    g, w = random.Random(9), random.Random(9)
    assert F.rand_ints(g, 12) == J.rand_ints(w, 12)
    assert g.getstate() == w.getstate()


def test_extension_one_wire_int_and_rand_ints_vs_jax():
    """The extensions' pairs and quadruples: the JAX base field's one and
    the JAX package's draws, coefficient by coefficient."""
    from sppark_tpu import params as jparams
    from sppark_tpu.oracle.field import Fp2 as JFp2
    fp2 = params.get_curve("bn254_g2").fp2
    F = get_fp2_ops(fp2)
    J = JFp2(jparams.get_curve("bn254_g2").fp2)
    assert F.one_wire_int() == (_jax_field("bn254_fp").one_wire_int(), 0)
    g, w = random.Random(4), random.Random(4)
    assert F.rand_ints(g, 6) == [J.rand(w) for _ in range(6)]
    B = BabyBear4Field()
    JB = _jax_field("baby_bear")
    assert B.one_wire_int() == (JB.one_wire_int(), 0, 0, 0)
    g, w = random.Random(4), random.Random(4)
    assert B.rand_ints(g, 5) == [tuple(JB.rand_ints(w, 4)) for _ in range(5)]
    # they feed the fields' own int lists
    assert B.to_int_list(B.from_int_list(B.rand_ints(random.Random(1), 3))) \
        == B.rand_ints(random.Random(1), 3)


def test_bigmont_roots():
    """nth_root, heptaroot, pentaroot and sqrt against exact ints, and the
    pentaroot word for word against the JAX BigMontField on test_bm64_fp."""
    F = get_field_ops("test_bm64_fp")
    p = F.p
    xs = F.rand_ints(random.Random(2), 6) + [0, 1]
    x = F.from_int_list(xs)
    for k, root in ((5, F.pentaroot), (7, F.heptaroot), (11, None)):
        if math.gcd(k, p - 1) == 1:
            want = [pow(v, pow(k, -1, p - 1), p) for v in xs]
            assert F.to_int_list(F.nth_root(x, k)) == want
            if root is not None:
                assert F.to_int_list(root(x)) == want
        else:
            with pytest.raises(ValueError):
                F.nth_root(x, k)
    with pytest.raises(ValueError):
        F.nth_root(x, 2)
    with pytest.raises(NotImplementedError):     # p = 1 (mod 4)
        F.sqrt(x)
    J = _jax_field("test_bm64_fp")
    assert F.to_int_list(F.pentaroot(x)) == \
        J.to_int_list(J.pentaroot(J.from_int_list(xs)))
    B = get_field_ops("bls12_381_fp")            # p = 3 (mod 4)
    ys = B.rand_ints(random.Random(3), 4) + [0]
    r = B.to_int_list(B.sqrt(B.sqr(B.from_int_list(ys))))
    assert r == [pow(v * v, (B.p + 1) // 4, B.p) for v in ys]
    assert [v * v % B.p for v in r] == [v * v % B.p for v in ys]


def test_gl64_zero_tests_and_tree_inversion():
    xs = gl64.rand_ints(random.Random(6), 8)
    x = gl64.from_ints(xs)
    z = gl64.zeros((8,))
    assert gl64.to_ints(z) == [0] * 8
    raw = torch.tensor([0, gl64.to_i64(gl64.P), 5, gl64.to_i64(gl64.P + 5)])
    assert gl64.is_zero(raw).tolist() == [True, True, False, False]
    assert gl64.eq(raw, torch.tensor([gl64.to_i64(gl64.P), 0, 5, 5])
                   ).tolist() == [True, True, True, True]
    J = _jax_field("goldilocks")
    assert gl64.is_zero(x).tolist() == np.asarray(
        J.is_zero(J.from_int_list(xs))).tolist()
    inv = gl64.to_ints(gl64.batch_inv_tree(x))
    assert inv == [pow(v, -1, gl64.P) for v in xs]
    assert inv == gl64.to_ints(gl64.batch_inv(x))


def test_fp2_inv():
    """Fp2Field.inv on every lane, zero giving zero, against the JAX
    package's big-int Fp2 and the port's own batch inversion."""
    from sppark_tpu import params as jparams
    from sppark_tpu.oracle.field import Fp2 as JFp2
    for curve in ("test_bm64_g2", "test_gl64_g2"):
        F = get_fp2_ops(params.get_curve(curve).fp2)
        J = JFp2(jparams.get_curve(curve).fp2)
        vals = F.rand_ints(random.Random(8), 5) + [(0, 0), (1, 0), (0, 1)]
        x = F.from_int_list(vals)
        assert F.to_int_list(F.inv(x)) == [J.inv(v) for v in vals]
        assert torch.equal(F.inv(x), F.batch_inv(x))


def test_sppark_ok_and_accelerator_available():
    sppark_ok(True, 5, "unused")
    with pytest.raises(SpparkError) as e:
        sppark_ok(False, 7, "bad input")
    assert e.value.code == 7 and e.value.message == "bad input"
    assert accelerator_available() == torch.cuda.is_available()
    if not torch.cuda.is_available():
        assert accelerator_available() is False


# -- the examples -------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["goldilocks", "baby_bear"])
def test_ntt_example_cpu(field):
    """The example's three transforms against the JAX package's big-int
    oracle on the example's own data (the facades themselves are held to
    each other in tests/test_torch_ntt*.py)."""
    from sppark_tpu import params as jparams
    from sppark_tpu.oracle import ntt as joracle
    from sppark_tpu.oracle.field import Fr as JFr
    out = ntt_example.main([field, "10", "--cpu"])
    jf = jparams.get_field(field)
    wire = JFr(jf)

    def ints(arr):
        return [wire.from_wire(int(v)) for v in arr]
    data = ints(out["data"])
    assert ints(out["ntt"]) == joracle.ntt_natural(jf, data)
    assert ints(out["coset_ntt"]) == joracle.coset_ntt(jf, data)
    assert ints(out["lde"]) == joracle.lde(jf, data, 2)


def test_ntt_example_refuses_a_wide_field():
    with pytest.raises(SystemExit):
        ntt_example.main(["bn254_fr", "4", "--cpu"])


def test_msm_example_cpu_test_gl64():
    from sppark_tpu import params as jparams
    from sppark_tpu.oracle.msm import msm_naive
    out = msm_example.main(["test_gl64", "8", "--cpu"])
    res = out["result"]
    assert len(out["points"]) == 256 and out["points"][3].inf
    want = msm_naive(jparams.get_curve("test_gl64"), out["points"],
                     out["scalars"])
    assert (res.x, res.y, res.inf) == (want.x, want.y, want.inf)
    assert get_oracle(params.get_curve("test_gl64")).on_curve(res)
    assert out["host"] is None      # a4 != 0: no native MSM


@pytest.mark.skipif(not cpu_available(), reason="native toolchain unavailable")
def test_msm_example_cpu_bn254():
    """Run as a user runs it, `python3 -m ...`, in a process of its own
    on one thread: the plain MSM's ~5,500 small Montgomery products run
    2x slower beside JAX's threads, and far slower when each of several
    test workers' processes spreads them over every core.  The example
    asserts the port's MSM equals the native host MSM."""
    out = subprocess.run(
        [sys.executable, "-m", "sppark_tpu_torch.examples.msm_example",
         "bn254", "6", "--cpu"], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"}, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("device MSM(bn254, 2^6) = (")
    assert lines[1].startswith("native CPU MSM agrees")
    x, y = (int(v) for v in lines[0].split("= (")[1].split(")")[0].split(","))
    assert get_oracle(params.get_curve("bn254")).on_curve(
        AffinePoint(x, y, False))


def test_examples_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SpparkError):
        ntt_example.main(["goldilocks", "4"])
    with pytest.raises(SpparkError):
        msm_example.main(["test_gl64", "4"])
