"""What a traced window read from `torch.profiler`: the device's events,
each tied to the host ranges it was launched in, the device's busy time,
and the breakdown of device time and idle gaps.

The tie follows chip_smoke.py's `profile_breakdown` (:748-804 at the commit
that added this benchmark): a device event belongs to the host ranges
whose interval holds the runtime call that launched it, matched by CUPTI
correlation id, because the port's kernels launch through ctypes and carry
no link to a torch op.  Beside the ranges, each device event records
whether its launch came from inside an `aten::` op (a plain PyTorch
kernel, named by that op) or from outside any (one of the port's own
kernels, named by `kernel_group`, chip_smoke.py's :735-745 unchanged).
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: the point kernels by their template's op number (csrc/ec_kernel.cuh)
EC_OPS = ("xyzz_madd", "xyzz_add", "xyzz_dbl", "pair_prep", "pair_finish")
#: the point kernels' elements (csrc/mont.cuh, csrc/mont_cc.cuh), longest
#: name first
EC_ELEMS = "Fp2PairCC|Fp2Pair|Fp2CC|FpCC|Fp2|Fp"


def kernel_group(name: str) -> str:
    """A device event's name, the point and field kernels by their op."""
    m = re.search(r"ec_kernel<mont::(" + EC_ELEMS + r")<\d+>, ?(\d)[,>]",
                  name)
    if m:
        return ("ec_" if m.group(1) in ("Fp", "FpCC") else "ec_fp2_") + \
            EC_OPS[int(m.group(2))]
    for kernel in ("ew_kernel", "pow_kernel", "inv_up", "inv_down"):
        if f"{kernel}<" in name:
            return "bigmont_" + kernel.replace("_kernel", "")
    return name[:60]


@dataclass
class DeviceEvent:
    name: str
    group: str
    start_ns: int
    dur_ns: int
    launched_ns: Optional[int]
    in_aten: bool


def _innermost(spans, starts, t: int, skip: str = "") -> Optional[str]:
    """The name of the latest-starting span of `spans` ((lo, hi, name),
    sorted by lo; `starts` their lo) open at t, other than `skip`."""
    j = bisect.bisect_right(starts, t) - 1
    for k in range(j, max(-1, j - 4096), -1):
        if spans[k][1] > t and spans[k][2] != skip:
            return spans[k][2]
    return None


class _Intervals:
    """Sorted, merged host intervals with a membership test."""

    def __init__(self, spans: List[Tuple[int, int]]):
        merged: List[List[int]] = []
        for lo, hi in sorted(spans):
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        self.lo = [a for a, _ in merged]
        self.hi = [b for _, b in merged]
        self.total_ns = sum(b - a for a, b in merged)

    def holds(self, t: Optional[int]) -> bool:
        if t is None:
            return False
        j = bisect.bisect_right(self.lo, t) - 1
        return j >= 0 and t < self.hi[j]


@dataclass
class TraceView:
    """One traced stretch: `calls` program calls in `window_s` seconds."""

    calls: int
    window_s: float
    device: List[DeviceEvent]
    ranges: Dict[str, _Intervals]
    busy_s: float
    gaps: List[Tuple[float, str]]
    #: what the cell's calls need, from its traffic (core/roofline.py)
    work: Dict[str, Tuple[float, float]] = field(default_factory=dict)

    def range_host_ms(self, name: str) -> Optional[float]:
        r = self.ranges.get(name)
        return None if r is None else r.total_ns / 1e6

    def device_ms(self, pred=lambda e: True,
                  within: Optional[str] = None) -> float:
        """Device ms of the events that satisfy `pred`, launched inside the
        host range `within` where given."""
        r = self.ranges.get(within) if within else None
        if within and r is None:
            return 0.0
        return sum(e.dur_ns for e in self.device
                   if pred(e) and (r is None or r.holds(e.launched_ns))) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        by: Dict[str, float] = defaultdict(float)
        for e in self.device:
            by[e.group] += e.dur_ns / 1e9
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps: Dict[str, float] = defaultdict(float)
        for sec, label in self.gaps:
            gaps[label] += sec
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


#: the harness's host range around each step of a traced stretch
STEP = "bench.step"
#: the harness's host range around each call into the program
CALL = "bench.call"


def read_profile(prof, calls: int) -> TraceView:
    """A TraceView of a profile whose steps are STEP ranges holding `calls`
    program calls: the stretch runs from the first step's start to the
    last one's end, on the profiler's own clock."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    launched_at: Dict[int, int] = {}
    host: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    dev_raw = []
    for e in events:
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev_raw.append(e)
            continue
        name = e.name()
        lo = e.start_ns()
        if name.startswith("cu"):           # a CUDA API call (cuda*, cu*)
            launched_at[e.correlation_id()] = lo
        host[name].append((lo, lo + e.duration_ns()))
    steps = host.get(STEP) or [(0, 0)]
    t0_ns, t1_ns = min(lo for lo, _ in steps), max(hi for _, hi in steps)
    aten = sorted(((lo, hi, k) for k, v in host.items()
                   if k.startswith("aten::") for lo, hi in v))
    aten_starts = [a[0] for a in aten]
    device = []
    for e in dev_raw:
        at = launched_at.get(e.correlation_id())
        op = _innermost(aten, aten_starts, at) if at is not None else None
        # a plain PyTorch kernel is named by the aten op that launched it
        device.append(DeviceEvent(e.name(), op or kernel_group(e.name()),
                                  e.start_ns(), e.duration_ns(), at,
                                  op is not None))
    device.sort(key=lambda d: d.start_ns)
    ranges = {k: _Intervals(v) for k, v in host.items()
              if not k.startswith("aten::") and not k.startswith("cu")}
    # device busy: the union of the events' intervals inside the stretch,
    # and the idle gaps between them, named by the innermost host span
    # (range, op or runtime call) open at the gap's middle
    busy_ns, gaps, edge = 0, [], t0_ns
    for d in device:
        lo, hi = max(d.start_ns, edge), min(d.start_ns + d.dur_ns, t1_ns)
        if d.start_ns > edge and d.start_ns < t1_ns:
            gaps.append((edge, min(d.start_ns, t1_ns)))
        if hi > lo:
            busy_ns += hi - lo
        edge = max(edge, d.start_ns + d.dur_ns)
    if edge < t1_ns:
        gaps.append((edge, t1_ns))
    spans = sorted(((lo, hi, k) for k, v in host.items() for lo, hi in v),
                   key=lambda s: s[0])
    starts = [s[0] for s in spans]
    named = [((hi - lo) / 1e9,
              _innermost(spans, starts, (lo + hi) // 2, STEP) or "host")
             for lo, hi in gaps]
    return TraceView(calls, (t1_ns - t0_ns) / 1e9, device, ranges,
                     busy_ns / 1e9, named)
