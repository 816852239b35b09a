"""msm_ms: the window's wall time over the MSM invokes it completed."""


def read(run):
    return run.window_s / run.calls * 1e3 if run.calls else None
