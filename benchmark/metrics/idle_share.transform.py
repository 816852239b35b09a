"""The device's idle share of the traced stretch: 1 - busy / wall, in %."""


def read(run):
    t = run.trace
    if t is None or not t.window_s:
        return None
    return 100 * (1 - t.busy_s / t.window_s)
