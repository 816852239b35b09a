"""msm_device_ms.schedule: device ms an invoke of the kernels launched
inside the program's `msm.schedule` range."""


def read(run):
    t = run.trace
    if t is None or not t.calls or "msm.schedule" not in t.ranges:
        return None
    return t.device_ms(within="msm.schedule") / t.calls
