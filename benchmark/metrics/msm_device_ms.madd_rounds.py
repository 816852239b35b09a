"""msm_device_ms.madd_rounds: device ms an invoke of the kernels launched
inside the program's `msm.madd_rounds` range."""


def read(run):
    t = run.trace
    if t is None or not t.calls or "msm.madd_rounds" not in t.ranges:
        return None
    return t.device_ms(within="msm.madd_rounds") / t.calls
