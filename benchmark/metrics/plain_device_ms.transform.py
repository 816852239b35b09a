"""plain_device_ms.transform: device ms per call of the work launched from
inside a PyTorch op (aten::), not by one of the program's own kernels: the
coset shift, the padding, the transposes, the copies.  None where the
calls launch no such work (the NTT alone)."""

from benchmark.core.trace import CALL


def read(run):
    t = run.trace
    if t is None or not t.calls or CALL not in t.ranges:
        return None
    ms = t.device_ms(lambda e: e.in_aten, within=CALL)
    return ms / t.calls if ms else None
