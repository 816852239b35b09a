"""The port's sharded paths (sppark_tpu_torch.parallel) in gloo worlds of 2
and 4 ranks on the CPU, against the JAX package's sharded paths on a
virtual CPU mesh of as many devices, the port's single-device NTT and
msm_naive.

Each world is spawned once for the file (torch.multiprocessing, started
at the first test and joined where its results are read, so the first
test's JAX compiles run meanwhile); each rank takes its shard of the
same numpy input the JAX mesh receives and saves its outputs.  The
workers import no JAX: this module imports it only inside the tests.
The JAX package's msm_sharded runs at 5-bit windows, where it compiles
fastest (~15 s here, against ~30 s at 8); its result does not depend on
the window.
"""

import os
import random

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from sppark_tpu_torch import ntt as tntt
from sppark_tpu_torch.ff import gl64
from sppark_tpu_torch.ntt.core import elem_ops
from sppark_tpu_torch.oracle.ec import AffinePoint, get_oracle
from sppark_tpu_torch.oracle.msm import msm_naive
from sppark_tpu_torch.params import get_curve, get_field
from sppark_tpu_torch.util import SpparkError

NTT_CASES = [("baby_bear", 10), ("goldilocks", 12)]
MATRIX_CASE = ("goldilocks", 8)
WIDE_CASE = ("bn254_fr", 6)
WORLDS = (2, 4)


def ntt_input(field, lg):
    """Canonical words of `field` as numpy: u64 Goldilocks words, u32
    Montgomery words of a 31-bit field (the JAX package's uint32 words),
    or (n32, n) u32 Montgomery words of a wide field."""
    p = get_field(field).modulus
    g = np.random.default_rng(lg)
    if p == gl64.P:
        return g.integers(0, p, size=1 << lg, dtype=np.uint64)
    if p < 1 << 32:
        return g.integers(0, p, size=1 << lg).astype(np.uint32)
    from sppark_tpu_torch.ff.bigmont import get_field_ops
    F = get_field_ops(field)
    ints = [int(v) for v in g.integers(0, 1 << 62, size=1 << lg)]
    return F.from_int_list(ints).numpy().view(np.uint32)


def words(field, arr):
    """numpy words -> the port's tensor."""
    if arr.dtype == np.uint64:
        return gl64.from_wire(arr)
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int32))


def msm_input(curve, n, seed):
    """tests/test_parallel.py's input: 8 random points tiled, infinity at
    index 3, a zero scalar at 1."""
    cp = get_curve(curve)
    o = get_oracle(cp)
    rng = random.Random(seed)
    base = [o.random_point(rng) for _ in range(8)]
    points = [base[i % 8] for i in range(n)]
    points[3] = AffinePoint(0, 0, True)
    scalars = [rng.randrange(cp.scalar.modulus) for _ in range(n)]
    scalars[1] = 0
    return points, scalars


def shard_keys():
    """The sharded NTT's twiddle shards this process holds."""
    from sppark_tpu_torch.ntt.parameters import _PARAMETERS
    return [k for pm in _PARAMETERS.values() for k in pm._tables
            if k[0] == "shard"]


def _worker(rank, D, port, outdir):
    """One rank: every sharded case on its shard; saves its outputs."""
    from sppark_tpu_torch.parallel import (destroy, dryrun, init_distributed,
                                           local_mesh, make_mesh,
                                           msm_sharded, ntt_matrix_sharded,
                                           ntt_sharded)
    torch.set_num_threads(1)
    init_distributed(f"tcp://localhost:{port}", D, rank, device="cpu")
    mesh = make_mesh()
    out = {}
    for field, lg in NTT_CASES + [WIDE_CASE]:
        x = words(field, ntt_input(field, lg))
        m = x.shape[-1] // D
        mine = x[..., rank * m:(rank + 1) * m].contiguous()
        fwd = ntt_sharded(field, mine, lg, mesh)
        out[(field, lg, "fwd")] = fwd
        out[(field, lg, "inv")] = ntt_sharded(field, mine, lg, mesh,
                                              inverse=True)
        out[(field, lg, "back")] = ntt_sharded(field, fwd, lg, mesh,
                                               inverse=True)
    field, lg = MATRIX_CASE
    n1, n2 = 1 << (lg // 2), 1 << (lg - lg // 2)
    a = words(field, ntt_input(field, lg)).reshape(n1, n2)
    out["matrix"] = ntt_matrix_sharded(
        field, a[:, rank * n2 // D:(rank + 1) * n2 // D], lg, mesh)
    # columns longer than the column kernel takes: the NTT path along the
    # last axis, then the twiddle product (BN254 Fr 2^26's route)
    import sppark_tpu_torch.parallel.ntt as pntt
    pntt.LG_MAX = pntt.LG_MAX_WIDE = 2
    for field, lg in (MATRIX_CASE, WIDE_CASE):
        x = words(field, ntt_input(field, lg))
        m = x.shape[-1] // D
        mine = x[..., rank * m:(rank + 1) * m].contiguous()
        out[(field, lg, "long columns")] = (
            ntt_sharded(field, mine, lg, mesh),
            ntt_sharded(field, mine, lg, mesh, inverse=True))
    pts, sc = msm_input("test_gl64", 64, 1)
    out["msm_gl64"] = msm_sharded("test_gl64", pts, sc, mesh, wbits=8)
    if D == 2:
        pts, sc = msm_input("pallas", 64, 2)
        out["msm_pallas"] = msm_sharded("pallas", pts, sc, mesh, wbits=10)
    else:
        out["dryrun"] = dryrun(mesh)
    try:
        local_mesh(D + 1)
    except ValueError:
        out["local_mesh_refused"] = True
    out["shards"] = [len(shard_keys())]
    destroy()
    out["shards"].append(len(shard_keys()))
    torch.save(out, os.path.join(outdir, f"world{D}_rank{rank}.pt"))


class Worlds:
    """The gloo worlds, started together; `get(D)` joins world D and
    returns its ranks' outputs."""

    def __init__(self, outdir):
        from sppark_tpu_torch.parallel.mesh import free_port
        self.outdir = str(outdir)
        self.ctx = {D: mp.spawn(_worker, args=(D, free_port(), self.outdir),
                                nprocs=D, join=False) for D in WORLDS}
        self.out = {}

    def get(self, D):
        if D not in self.out:
            while not self.ctx[D].join():
                pass
            self.out[D] = [torch.load(os.path.join(
                self.outdir, f"world{D}_rank{r}.pt"), weights_only=False)
                for r in range(D)]
        return self.out[D]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = Worlds(tmp_path_factory.mktemp("worlds"))
    yield w
    for D in WORLDS:
        w.get(D)


def gather(world, key):
    return torch.cat([r[key] for r in world], dim=-1)


def to_jax(field, t):
    import jax.numpy as jnp
    if t.dtype == torch.int64:
        return jnp.asarray(gl64.to_jax_planes(t))
    return jnp.asarray(t.numpy().view(np.uint32))


def test_msm_sharded_matches_jax_and_oracle(worlds):
    """test_gl64 at 8-bit windows, n = 64: both worlds against msm_naive,
    and against the JAX package's msm_sharded on a 2-device mesh (at
    5-bit windows)."""
    from sppark_tpu.parallel import local_mesh, msm_sharded
    cp = get_curve("test_gl64")
    pts, sc = msm_input("test_gl64", 64, 1)
    want = msm_naive(cp, pts, sc)
    jgot = msm_sharded("test_gl64", pts, sc, local_mesh(2), wbits=5)
    assert (jgot.x, jgot.y, jgot.inf) == (want.x, want.y, want.inf)
    for D in WORLDS:
        for r, out in enumerate(worlds.get(D)):
            got = out["msm_gl64"]
            assert (got.x, got.y, got.inf) == (want.x, want.y, want.inf), \
                (D, r)


@pytest.mark.parametrize("field,lg", NTT_CASES)
def test_ntt_sharded_matches_jax_and_single(field, lg, worlds):
    """Forward: the 2-rank world against the JAX package's ntt_sharded on
    a 2-device mesh; both worlds against the port's single-device NTT.
    Inverse: against the single-device inverse, and the round trip."""
    from sppark_tpu.parallel import local_mesh, ntt_sharded
    x = words(field, ntt_input(field, lg))
    want = to_jax(field, tntt.base_dev(field, x, lg))
    jx = ntt_sharded(field, to_jax(field, x), lg, local_mesh(2))
    assert np.array_equal(np.asarray(jx), np.asarray(want))
    single = tntt.base_dev(field, x, lg)
    single_inv = tntt.base_dev(field, x, lg,
                               direction=tntt.Direction.inverse)
    for D in WORLDS:
        w = worlds.get(D)
        assert torch.equal(gather(w, (field, lg, "fwd")), single), D
        assert torch.equal(gather(w, (field, lg, "inv")), single_inv), D
        assert torch.equal(gather(w, (field, lg, "back")), x), D


def test_ntt_matrix_layout(worlds):
    """Matrix form: D[k1, k2] == X[k1 + N1 k2], row shards, against the
    port's single-device NTT."""
    field, lg = MATRIX_CASE
    n1, n2 = 1 << (lg // 2), 1 << (lg - lg // 2)
    x = words(field, ntt_input(field, lg))
    want = tntt.base_dev(field, x, lg).reshape(n2, n1).T
    for D in WORLDS:
        got = torch.cat([r["matrix"] for r in worlds.get(D)], dim=0)
        assert torch.equal(got, want), D


def test_ntt_sharded_long_columns(worlds):
    """The route of columns longer than the column kernel takes (its
    limit lowered to 2^2 in the workers): forward and inverse against the
    single-device NTT, Goldilocks and BN254 Fr."""
    for field, lg in (MATRIX_CASE, WIDE_CASE):
        x = words(field, ntt_input(field, lg))
        single = tntt.base_dev(field, x, lg)
        single_inv = tntt.base_dev(field, x, lg,
                                   direction=tntt.Direction.inverse)
        for D in WORLDS:
            got = [r[(field, lg, "long columns")] for r in worlds.get(D)]
            assert torch.equal(torch.cat([g[0] for g in got], -1), single)
            assert torch.equal(torch.cat([g[1] for g in got], -1),
                               single_inv)


def test_ntt_sharded_wide(worlds):
    """A wide field (BN254 Fr, lg 6, (n32, n) words): forward, inverse and
    the round trip against the port's single-device NTT."""
    field, lg = WIDE_CASE
    x = words(field, ntt_input(field, lg))
    single = tntt.base_dev(field, x, lg)
    single_inv = tntt.base_dev(field, x, lg,
                               direction=tntt.Direction.inverse)
    assert elem_ops(field).lead == 1
    for D in WORLDS:
        w = worlds.get(D)
        assert torch.equal(gather(w, (field, lg, "fwd")), single), D
        assert torch.equal(gather(w, (field, lg, "inv")), single_inv), D
        assert torch.equal(gather(w, (field, lg, "back")), x), D


def test_msm_sharded_256(worlds):
    """Pallas at 10-bit windows in the 2-rank world against msm_naive (no
    256-bit JAX compile)."""
    cp = get_curve("pallas")
    pts, sc = msm_input("pallas", 64, 2)
    want = msm_naive(cp, pts, sc)
    for out in worlds.get(2):
        got = out["msm_pallas"]
        assert (got.x, got.y, got.inf) == (want.x, want.y, want.inf)


def test_dryrun_and_local_mesh(worlds):
    """The dry run in the 4-rank world; local_mesh refuses more ranks
    than the world has, in both."""
    w4 = worlds.get(4)
    assert [r["dryrun"].split(":")[0] for r in w4] == [
        f"dryrun rank {r} of 4" for r in range(4)]
    assert all(r.get("local_mesh_refused") for D in WORLDS
               for r in worlds.get(D))


def test_destroy_drops_twiddle_shards(worlds):
    """The sharded NTT keeps its twiddle shards in the NTT parameters'
    tables while the group lives; destroy() frees them."""
    for D in WORLDS:
        assert all(r["shards"][0] > 0 and r["shards"][1] == 0
                   for r in worlds.get(D)), D


def test_refusals(monkeypatch):
    """n % D raises before any collective; without a card a rank refuses
    to start unless it was given the CPU."""
    from sppark_tpu_torch.parallel import (Mesh, init_distributed,
                                           msm_sharded, ntt_sharded,
                                           rank_device)
    mesh = Mesh(None, 2, 0, torch.device("cpu"))
    pts, sc = msm_input("test_gl64", 63, 1)
    with pytest.raises(ValueError):
        msm_sharded("test_gl64", pts, sc, mesh)
    with pytest.raises(ValueError):
        ntt_sharded("goldilocks", gl64.from_ints([1] * 16), 4, mesh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SpparkError):
        init_distributed()
    with pytest.raises(SpparkError):
        rank_device("cuda:0")
    assert rank_device("cpu") == torch.device("cpu")
