"""multi_scalar_mult over a chosen curve, as sppark's poc/msm-cuda drives
it (src/lib.rs:18-84), with the reference's planted edge cases: a base
set replicated to size and an infinity at index 3 (src/util.rs:13-38).
A G1 curve with a4 == 0 is held against the native host MSM.

    python3 -m sppark_tpu_torch.examples.msm_example [curve] [lg] [--cpu]

Defaults: test_gl64, lg 10.  On the CUDA card unless --cpu.
"""

from __future__ import annotations

import random
import sys
import time

from ..ffi import cpu_available, cpu_msm
from ..msm import mult_pippenger
from ..oracle.ec import AffinePoint, get_oracle
from ..params import get_curve
from ..runtime import resolve


def main(argv=None) -> dict:
    """Run the example; returns its "points", "scalars", the MSM's
    "result" and "host", the native MSM's equal result (None where it was
    not run), and their wall seconds "device_s" and "host_s"."""
    args = sys.argv[1:] if argv is None else list(argv)
    device = resolve("cpu" if "--cpu" in args else None)
    args = [a for a in args if a != "--cpu"]
    curve = args[0] if args else "test_gl64"
    lg = int(args[1]) if len(args) > 1 else 10
    n = 1 << lg
    cp = get_curve(curve)
    o = get_oracle(cp)
    rng = random.Random(42)

    base = [o.random_point(rng) for _ in range(1 << min(lg, 11))]
    points = [base[i % len(base)] for i in range(n)]
    if n > 3:
        points[3] = AffinePoint(0, 0, True)
    scalars = [rng.randrange(cp.scalar.modulus) for _ in range(n)]

    t0 = time.time()
    res = mult_pippenger(curve, points, scalars, device=device)
    device_s = time.time() - t0
    print(f"device MSM({curve}, 2^{lg}) = ({res.x}, {res.y}) "
          f"[{device_s:.2f}s incl. build]")

    host, host_s = None, None
    if cpu_available() and cp.fp2 is None and not cp.a4:
        t0 = time.time()
        host = cpu_msm(curve, points, scalars)
        host_s = time.time() - t0
        assert (host.x, host.y, host.inf) == (res.x, res.y, res.inf)
        print(f"native CPU MSM agrees [{host_s:.2f}s]")
    return {"points": points, "scalars": scalars, "result": res,
            "host": host, "device_s": device_s, "host_s": host_s}


if __name__ == "__main__":
    main()
