"""The sharded paths' dry run, the port's counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`: on every rank of a mesh, a Goldilocks
NTT round trip through `ntt_sharded` (equal to the input) and the sharded
MSM on the test curves test_gl64 and test_bm64 (a one-word and a
multi-limb coordinate field), equal to `msm_naive`, with a planted
infinity and a zero scalar.

    torchrun --nproc-per-node=N -m sppark_tpu_torch.parallel
    python3 -m sppark_tpu_torch.parallel --cpu   # a world of one

Each rank prints its line; any mismatch raises."""

from __future__ import annotations

import random

import numpy as np

from ..ff import gl64
from ..oracle.ec import AffinePoint, get_oracle
from ..oracle.msm import msm_naive
from ..params import GOLDILOCKS, get_curve
from .mesh import Mesh
from .msm import msm_sharded
from .ntt import ntt_sharded


def dryrun(mesh: Mesh, lg: int = 9) -> str:
    """The dry run on `mesh`; returns this rank's summary line."""
    n, D, r = 1 << lg, mesh.size, mesh.rank
    vals = np.random.default_rng(3).integers(0, GOLDILOCKS.modulus, size=n,
                                             dtype=np.uint64)
    mine = vals[r * n // D:(r + 1) * n // D]
    x = gl64.from_wire(mine, mesh.device)
    fwd = ntt_sharded("goldilocks", x, lg, mesh)
    back = ntt_sharded("goldilocks", fwd, lg, mesh, inverse=True)
    if not np.array_equal(gl64.to_wire(back), mine):
        raise AssertionError("sharded NTT round trip failed")
    rr = random.Random(5)
    for name in ("test_gl64", "test_bm64"):
        curve = get_curve(name)
        o = get_oracle(curve)
        npts = 8 * D
        pts = [o.random_point(rr) for _ in range(npts)]
        pts[3] = AffinePoint(0, 0, True)
        scalars = [rr.randrange(curve.scalar.modulus) for _ in range(npts)]
        scalars[0] = 0
        got = msm_sharded(name, pts, scalars, mesh, wbits=4)
        want = msm_naive(curve, pts, scalars)
        if (got.x, got.y, got.inf) != (want.x, want.y, want.inf):
            raise AssertionError(f"sharded MSM mismatch on {name}")
    return (f"dryrun rank {r} of {D}: sharded NTT 2^{lg} round trip + "
            f"sharded MSM (test_gl64, test_bm64) == msm_naive on "
            f"{mesh.device}")
