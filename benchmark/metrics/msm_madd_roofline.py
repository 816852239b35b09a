"""msm_madd_roofline: the least time the traced invokes' madds need (the
madds these scalars need, each 8 products and 2 squarings, over the INT32
peak, or their bytes over HBM: core/roofline.py) as a share of the device
time of the `ec_xyzz_madd` kernel."""

from benchmark.core.roofline import bound_ms


def read(run):
    t = run.trace
    if t is None or "msm_madd" not in t.work:
        return None
    ms = t.device_ms(lambda e: e.group == "ec_xyzz_madd")
    if not ms:
        return None
    ops, nbytes = t.work["msm_madd"]
    return 100 * bound_ms(nbytes, ops)[0] / ms
