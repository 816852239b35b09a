"""msm_host_ms.integrate: host ms an invoke inside the program's
`msm.integrate` range."""


def read(run):
    t = run.trace
    if t is None or not t.calls:
        return None
    ms = t.range_host_ms("msm.integrate")
    return None if ms is None else ms / t.calls
