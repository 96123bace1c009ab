"""The device's side of one traced job: a frozen copy of chip_smoke.py's
`profiled` (torch.profiler over the card; busy time as the union of its
kernel and copy intervals, so an interval that overlaps another counts
once), without its cProfile half, and with the idle gaps between the
intervals put to the host stage that was running."""
import time

MARK = "discobench.job"


def traced(fn):
    """fn() under torch.profiler (host and card).  Returns (fn's result,
    {wall_s, busy_s, ops: {name: (count, seconds)}, gaps: [(start, end)]
    idle inside the job in wall-clock seconds})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(MARK):
            t0 = time.time()
            out = fn()
            torch.cuda.synchronize()
            t1 = time.time()
    spans, ops, mark = [], {}, None
    for ev in prof.events():
        if ev.name == MARK:
            # the marker's host range aligns the clocks; its mirror on the
            # card is an annotation, not work
            if ev.device_type == DeviceType.CPU:
                mark = ev.time_range.start
            continue
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        n, us = ops.get(ev.name, (0, 0.0))
        ops[ev.name] = (n + 1, us + ev.time_range.elapsed_us())
    # profiler microseconds -> wall-clock seconds, through the marker
    shift = t0 - (mark if mark is not None else 0) / 1e6
    busy, reach, gaps = 0.0, None, []
    for lo, hi in sorted(spans):
        if reach is None or lo > reach:
            gaps.append((reach, lo))
        if reach is None or hi > reach:
            busy += hi - (lo if reach is None else max(lo, reach))
            reach = hi
    wall_gaps = []
    for lo, hi in gaps + [(reach, None)]:
        a = t0 if lo is None else lo / 1e6 + shift
        b = t1 if hi is None else hi / 1e6 + shift
        if b > a:
            wall_gaps.append((a, b))
    return out, {"wall_s": t1 - t0, "busy_s": busy / 1e6,
                 "ops": {k: (n, us / 1e6) for k, (n, us) in ops.items()},
                 "gaps": wall_gaps}


def gaps_by_stage(gaps, stages, top=10):
    """[[stage, idle seconds]] of the longest idle time by the host stage
    that overlaps it (`stages`: (name, seconds, wall-clock end)); idle time
    in no stage goes to `between stages`."""
    by = {}
    for a, b in gaps:
        left = b - a
        for name, secs, end in stages:
            o = min(b, end) - max(a, end - secs)
            if o > 0:
                by[name] = by.get(name, 0.0) + o
                left -= o
        if left > 0:
            by["between stages"] = by.get("between stages", 0.0) + left
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            [:top]]
