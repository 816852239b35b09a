"""ntt_roofline: the least time the traced transforms need (their radix-2
operations over the INT32 peak, or their input and output bytes over HBM:
core/roofline.py) as a share of the device time of the program's own NTT
kernels (rows, columns, middle twiddles)."""

import re

from benchmark.core.roofline import bound_ms

NTT_KERNELS = re.compile(r"\b(rows|cols|mid)_kernel\b")


def read(run):
    t = run.trace
    if t is None or "ntt" not in t.work:
        return None
    ms = t.device_ms(lambda e: not e.in_aten and NTT_KERNELS.search(e.name))
    if not ms:
        return None
    ops, nbytes = t.work["ntt"]
    return 100 * bound_ms(nbytes, ops)[0] / ms
