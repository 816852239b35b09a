"""msm_p90_ms: the 90th percentile (nearest rank) of every invoke's
latency in the window, on the host clock from the call to its returned
point."""

import math


def read(run):
    lat = sorted(run.latencies_s)
    if not lat:
        return None
    return lat[math.ceil(0.9 * len(lat)) - 1] * 1e3
