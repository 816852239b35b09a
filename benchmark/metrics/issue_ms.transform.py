"""issue_ms.transform: host ms from a facade call to its return, per call
(the harness's own `bench.call` span): dispatch, not device time."""

from benchmark.core.trace import CALL


def read(run):
    t = run.trace
    if t is None or not t.calls:
        return None
    ms = t.range_host_ms(CALL)
    return None if ms is None else ms / t.calls
