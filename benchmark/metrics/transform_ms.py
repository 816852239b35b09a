"""transform_ms: the window's wall time over the transforms it completed,
each ending in the closing synchronise of its batch."""


def read(run):
    return run.window_s / run.calls * 1e3 if run.calls else None
