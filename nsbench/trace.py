"""The traced stretch: ``torch.profiler`` over a few steps of the loop,
exported as a Chrome trace and reduced to the record that the per-layer
readers take.

Each graph replay runs inside a ``torch.profiler.record_function`` span of
the harness's own (``SPANS``), so every device operation is charged to
the replay that launched it: a kernel, copy or memset carries the
correlation id of the runtime call that launched it (for a replay,
``cudaGraphLaunch``), and that call runs inside one span on the host.
"""

from __future__ import annotations

import collections

SPANS = ("move", "zsort", "step", "tally")
TOP = 10
NAME = 120   # characters of a kernel name kept in the breakdown


def busy_ms(events) -> tuple:
    """(busy ms, window ms) of the union of device event intervals.

    Frozen copy of ``chip_profile.py::busy_ms`` (``chip_profile.py:61-72``
    at the commit that added this benchmark)."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (cs, ce) = 0.0, iv[0]
    for s, e in iv[1:]:
        if s > ce:
            busy += ce - cs
            cs, ce = s, e
        else:
            ce = max(ce, e)
    busy += ce - cs
    return busy / 1e3, (iv[-1][1] - iv[0][0]) / 1e3


def _gaps(events) -> list:
    """(start us, length us) of each idle interval between device events."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events)
    out, end = [], iv[0][1]
    for s, e in iv[1:]:
        if s > end:
            out.append((end, s - end))
        end = max(end, e)
    return out


def _host_names(starts: list, cpu_events: list) -> list:
    """The innermost CPU event of the harness's thread running at each of
    the ascending times ``starts`` (us), by name ("none" between them)."""
    evs = sorted(cpu_events, key=lambda e: (e.time_range.start,
                                            -e.time_range.end))
    stack, i, out = [], 0, []
    for t in starts:
        while i < len(evs) and evs[i].time_range.start <= t:
            while stack and stack[-1].time_range.end <= evs[i].time_range.start:
                stack.pop()
            stack.append(evs[i])
            i += 1
        while stack and stack[-1].time_range.end <= t:
            stack.pop()
        out.append(stack[-1].name if stack else "none")
    return out


DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = ("cuda_runtime", "cuda_driver")


class _Interval:
    """A trace event as ``busy_ms`` and ``_gaps`` read it (us)."""

    def __init__(self, event: dict):
        self.name = event["name"]
        start = float(event["ts"])
        self.time_range = _Range(start, start + float(event.get("dur", 0)))


class _Range:
    def __init__(self, start: float, end: float):
        self.start, self.end = start, end


def reduce_profile(chrome: dict) -> dict:
    """The record of a traced stretch from its Chrome trace: device ms by
    span and by operation name within each span, the busy and window ms,
    the top device operations and the idle time by what the host was
    doing."""
    import bisect
    events = [e for e in chrome["traceEvents"] if e.get("ph") == "X"]
    ops = [e for e in events if e.get("cat") in DEVICE]
    if not ops:
        raise RuntimeError("the profiler saw no device operation")
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"] in SPANS), key=lambda e: e["ts"])
    thread = spans[0]["tid"] if spans else None
    starts = [float(e["ts"]) for e in spans]
    launched = {}
    for e in events:
        if e.get("cat") in LAUNCH and "correlation" in e.get("args", {}):
            launched[e["args"]["correlation"]] = float(e["ts"])
    kernel_ms = collections.defaultdict(collections.Counter)
    unlinked = 0
    for e in ops:
        t = launched.get(e.get("args", {}).get("correlation"))
        k = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if k >= 0 and t <= starts[k] + float(spans[k].get("dur", 0)):
            span = spans[k]["name"]
        else:
            unlinked += 1
            span = "other"
        kernel_ms[span][e["name"]] += float(e.get("dur", 0)) / 1e3
    intervals = [_Interval(e) for e in ops]
    busy, window = busy_ms(intervals)
    per_name = collections.Counter()
    for e in ops:
        per_name[e["name"]] += float(e.get("dur", 0)) / 1e6
    gaps = _gaps(intervals)
    host = [_Interval(e) for e in events
            if e.get("tid") == thread and e.get("cat") not in DEVICE]
    names = _host_names([s for s, _ in gaps], host)
    idle = collections.Counter()
    for name, (_, length) in zip(names, gaps):
        idle[name] += length / 1e6
    return {"kernel_ms": {k: dict(v) for k, v in kernel_ms.items()},
            "span_ms": {k: sum(v.values()) for k, v in kernel_ms.items()},
            "busy_ms": busy, "window_ms": window, "unlinked": unlinked,
            "device_ops": [[k[:NAME], v]
                           for k, v in per_name.most_common(TOP)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(TOP)]}
