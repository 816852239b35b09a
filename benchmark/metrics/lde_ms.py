"""lde_ms: the window's wall time over the LDEs it completed, each ending
in the closing synchronise of its batch: transform_ms of the LDE cells,
under a bound of its own that their steadier runs allow."""


def read(run):
    return run.window_s / run.calls * 1e3 if run.calls else None
