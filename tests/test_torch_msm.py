"""The port's Pippenger MSM (sppark_tpu_torch.msm) against the JAX package's
on the CPU, where every kernel wrapper takes its plain version.

  * the slab schedule arrays, and the window sums and their affine form
    word for word, on test_bm64 (a real prime-order curve with two-word
    coordinates, params.py);
  * whole MSMs against the port's msm_naive and the JAX package's result,
    with infinity, zero, r - 1 and duplicate terms planted; a chunked
    invoke, Montgomery-form scalars, resident points through a DevPtr;
  * Pasta and BLS12-381 against the port's own oracle at n <= 32;
  * the no-silent-CPU rule, the lazy DevPtr registry, and the build
    digest's coverage of the shared headers.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sppark_tpu.msm import MSMContext as JMSMContext
from sppark_tpu.msm.pippenger import _make_breakdown
from sppark_tpu.msm.slab import make_slab_schedule as jax_schedule
from sppark_tpu_torch import _build
from sppark_tpu_torch.ff.bigmont import to_jax_planes
from sppark_tpu_torch.msm import MSMContext, mult_pippenger, pippenger, slab
from sppark_tpu_torch.oracle.ec import AffinePoint, get_oracle
from sppark_tpu_torch.oracle.msm import msm_naive
from sppark_tpu_torch.params import get_curve
from sppark_tpu_torch.runtime.dev_ptr import DevPtr
from sppark_tpu_torch.util.errors import SpparkError

CURVE = "test_bm64"


def _input(curve, n, seed):
    """n points from 8 distinct ones (duplicates in every bucket), with
    infinity at 3; scalars with 0, r - 1 and a repeated scalar planted."""
    cp = get_curve(curve)
    o = get_oracle(cp)
    rng = random.Random(seed)
    base = [o.random_point(rng) for _ in range(8)]
    pts = [base[i % 8] for i in range(n)]
    pts[3] = AffinePoint(0, 0, True)
    r = cp.scalar.modulus
    sc = [rng.randrange(r) for _ in range(n)]
    sc[0], sc[1] = 0, r - 1
    for k in range(12, n, 8):
        sc[k] = sc[4]                       # same point, same scalar
    return cp, pts, sc


def _words(sc, n_words):
    return np.array([[(s >> (32 * i)) & 0xFFFFFFFF for s in sc]
                     for i in range(n_words)], dtype=np.uint32)


def test_slab_schedule_vs_jax():
    """breakdown + stable sort + capped rows: every schedule array equals
    the JAX package's, replica rows included (40 equal scalars overflow
    the cap of 16)."""
    cp = get_curve(CURVE)
    rng = np.random.default_rng(1)
    n, wbits = 256, 6
    nwins = (cp.scalar.bits + wbits - 1) // wbits
    words = rng.integers(0, 1 << 32, size=(2, n), dtype=np.uint64)
    words = words.astype(np.uint32)
    words[-1] %= np.uint32(cp.scalar.modulus >> 32)
    words[:, 100:140] = words[:, 7:8]
    cap, n_rows = slab.plan_slab(n, 1 << (wbits - 1))
    want = jax_schedule(_make_breakdown(CURVE, wbits, nwins, 2, spread=False),
                        1 << (wbits - 1), cap, n_rows)(jnp.asarray(words))
    got = slab.make_slab_schedule(
        pippenger.make_breakdown(CURVE, wbits, nwins, 2), 1 << (wbits - 1),
        cap, n_rows)(torch.from_numpy(words.view(np.int32)))
    assert int(got[-1][1]) > 1                 # some bucket has replicas
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_msm_vs_jax_and_oracle():
    """64 points: the window sums (xyzz words), their affine form, and the
    MSM against the JAX package's pipeline and msm_naive (6-bit windows:
    a short integrate keeps the JAX side quick)."""
    cp, pts, sc = _input(CURVE, 64, 2)
    ctx = MSMContext(CURVE, 64, wbits=6, device="cpu")
    jctx = JMSMContext(CURVE, 64, wbits=6)
    assert (ctx.wbits, ctx.nwins) == (jctx.wbits, jctx.nwins)
    words = _words(sc, ctx.n_words)
    px, py = ctx.ops.affine_from_ints(pts)
    win = ctx.stages.window_sums(torch.from_numpy(words.view(np.int32)),
                                 slab.point_rows(ctx.ops.F, px, py))
    jpts = (jnp.asarray(to_jax_planes(px)), jnp.asarray(to_jax_planes(py)))
    jwin = jctx._fn.window_sums(jnp.asarray(words), jpts)
    for g, w in zip(win, jwin):
        assert np.array_equal(to_jax_planes(g), np.asarray(w, np.uint32))
    aff = ctx.stages.to_affine(win)
    for g, w in zip(aff, jctx._fn.to_affine(jwin)):
        assert np.array_equal(to_jax_planes(g), np.asarray(w, np.uint32))
    got = mult_pippenger(CURVE, pts, sc, wbits=6, device="cpu")
    assert got == ctx._collect(*aff) == msm_naive(cp, pts, sc)
    jgot = jctx._collect(*jctx._fn.to_affine(jwin))
    assert (got.x, got.y, got.inf) == (jgot.x, jgot.y, jgot.inf)


def test_msm_chunked_mont_and_devptr():
    """A chunked invoke with a short tail chunk, Montgomery-form scalar
    words, host numpy points (streamed chunk by chunk) and resident points
    passed back as a DevPtr handle all give msm_naive's point."""
    cp, pts, sc = _input(CURVE, 40, 3)
    want = msm_naive(cp, pts, sc)
    ctx = MSMContext(CURVE, 40, wbits=5, chunk=16, device="cpu")
    ptr = ctx.set_points(pts)
    assert ctx.invoke(sc) == want
    mont = _words([cp.scalar.to_mont(s) for s in sc], ctx.n_words)
    assert ctx.invoke(mont, mont=True) == want
    host = tuple(a.numpy().view(np.uint32) for a in ptr.value)
    assert ctx.invoke(sc, points=host) == want
    ctx2 = MSMContext(CURVE, 40, wbits=5, device="cpu")
    assert ctx2.invoke(torch.from_numpy(_words(sc, 2).view(np.int32)),
                       points=ptr.handle) == want
    with pytest.raises(ValueError):
        ctx2.invoke(sc[:39], points=ptr)


def test_resident_points_keep_only_the_gather_table():
    """Points set in one chunk live on as their gather table alone (it
    holds every point); invoke reads them from it, and a scalar count that
    does not match is refused."""
    cp, pts, sc = _input(CURVE, 16, 6)
    ctx = MSMContext(CURVE, 16, wbits=4, device="cpu")
    ctx.set_points(ctx.ops.affine_from_ints(pts))
    assert ctx._points is None and ctx.rows.shape == (33, 4)
    assert ctx.invoke(sc) == msm_naive(cp, pts, sc)
    with pytest.raises(ValueError):
        ctx.invoke(sc[:15])


@pytest.mark.parametrize("curve", ["pallas", "bls12_381"])
def test_msm_wide_curves_vs_oracle(curve):
    """256- and 384-bit curves through the whole plain pipeline at n = 24
    (small windows keep the CPU integrate short)."""
    cp, pts, sc = _input(curve, 24, 4)
    assert mult_pippenger(curve, pts, sc, wbits=5, device="cpu") == \
        msm_naive(cp, pts, sc)


def test_msm_modes_and_no_silent_cpu():
    """Every mode of the JAX package is ported (auto, slab, tree, xyzz,
    affine); an unknown mode raises.  With no device given, the entry
    points run on the card and raise where there is none."""
    for mode in ("auto", "slab", "tree", "xyzz", "affine"):
        MSMContext(CURVE, 8, mode=mode, device="cpu")
    with pytest.raises(NotImplementedError, match="jacobian"):
        MSMContext(CURVE, 8, mode="jacobian", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SpparkError):
        MSMContext(CURVE, 8)
    _, pts, sc = _input(CURVE, 8, 5)
    with pytest.raises(SpparkError):
        mult_pippenger(CURVE, pts, sc)


def test_devptr_lazy_registry():
    """A DevPtr enters the registry on the first .handle access, not at
    construction; clone / drop count references and the last drop frees."""
    t = (torch.zeros(2, 3, dtype=torch.int32),)
    ptr = DevPtr(t)
    assert ptr not in DevPtr._registry.values()
    h = ptr.handle
    assert ptr.handle == h and DevPtr.from_handle(h) is ptr
    ptr.clone()
    ptr.drop()
    assert DevPtr.from_handle(h) is ptr and ptr.value is t
    ptr.drop()
    assert ptr.value is None
    with pytest.raises(KeyError):
        DevPtr.from_handle(h)
    never = DevPtr(t)
    never.drop()
    assert never.value is None and never not in DevPtr._registry.values()


def test_build_digest_covers_headers(tmp_path, monkeypatch):
    """Editing a shared header changes every library's file name, so the
    next build recompiles what includes it; an unrelated edit elsewhere
    does not."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    before = _build._target("a")
    assert _build.sources() == ["a"]
    (tmp_path / "h.cuh").write_text("// v2\n")
    after = _build._target("a")
    assert after != before and after.parent == tmp_path / "build"
    (tmp_path / "notes.txt").write_text("x")
    assert _build._target("a") == after
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build._target("a") != after
