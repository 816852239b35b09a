"""The NTT facade on host arrays, driven as sppark's Rust wrappers drive
it (poc/ntt-cuda/src/lib.rs:20-118): NTT then iNTT, the coset pair, and an
LDE with blowup 4.

    python3 -m sppark_tpu_torch.examples.ntt_example [field] [lg] [--cpu]

Defaults: goldilocks, lg 12.  Only the narrow fields (Goldilocks and the
31-bit ones): a wide field is refused.  On the CUDA card unless --cpu.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import ntt
from ..params import get_field
from ..runtime import resolve


def main(argv=None) -> dict:
    """Run the example; returns the input and the three transforms' host
    arrays ("data", "ntt", "coset_ntt", "lde") after checking both round
    trips exactly."""
    args = sys.argv[1:] if argv is None else list(argv)
    device = resolve("cpu" if "--cpu" in args else None)
    args = [a for a in args if a != "--cpu"]
    field = args[0] if args else "goldilocks"
    lg = int(args[1]) if len(args) > 1 else 12
    params = get_field(field)
    n = 1 << lg
    rng = np.random.default_rng(1)

    if field == "goldilocks":
        data = rng.integers(0, params.modulus, size=n, dtype=np.uint64)
    elif params.bits <= 32:
        data = rng.integers(0, params.modulus, size=n,
                            dtype=np.int64).astype(np.uint32)
    else:
        raise SystemExit("use a narrow field for this example")

    fwd = ntt.ntt(field, data, lg, device=device)            # NN forward
    back = ntt.intt(field, fwd, lg, device=device)           # NN inverse
    assert np.array_equal(back, data)
    print(f"{field} 2^{lg}: iNTT(NTT(x)) == x")

    cf = ntt.coset_ntt(field, data, lg, device=device)
    cb = ntt.coset_intt(field, cf, lg, device=device)
    assert np.array_equal(cb, data)
    print(f"{field} 2^{lg}: coset round-trip OK")

    ext = ntt.lde(field, data, lg, 2, device=device)         # blowup 4x
    print(f"LDE: {n} evaluations -> {len(ext)} over the shifted coset")
    return {"data": data, "ntt": fwd, "coset_ntt": cf, "lde": ext}


if __name__ == "__main__":
    main()
