"""The program's span recorder as the per-layer readers see it
(disco_tpu_torch/utils/logging.py's RECORDER): the recorder's jobs matched
to the window's jobs by their intervals, both on perf_counter; the traced
job, the recorder's first job after the last window job; a span placed on
the wall clock through its job's anchor pair; and the idle gaps of a
traced job set against spans.  Against a program that has no recorder
every reader gets None, and nothing raises."""


def recorder():
    """The program's recorder, or None where the program has none."""
    try:
        from disco_tpu_torch.utils import logging as program_logging
    except ImportError:
        return None
    return getattr(program_logging, "RECORDER", None)


def _ended(rec):
    return [j for j in rec.jobs() if j["t1"] is not None]


def window_jobs(run):
    """The recorder's job of each of the window's jobs, in order: the one
    whose interval lies inside the window job's (t0, t1).  None without
    the recorder, or when a window job holds no recorder job or several."""
    rec = recorder()
    if rec is None:
        return None
    ended, out = _ended(rec), []
    for w in run.jobs:
        lo, hi = w["t0"] * 1e9, w["t1"] * 1e9
        inside = [j for j in ended if j["t0"] >= lo and j["t1"] <= hi]
        if len(inside) != 1:
            return None
        out.append(inside[0])
    return out or None


def traced_job(run):
    """The recorder's first job after the last window job (the traced
    one), or None."""
    rec = recorder()
    if rec is None or not run.jobs:
        return None
    last = run.jobs[-1]["t1"] * 1e9
    after = [j for j in _ended(rec) if j["t0"] > last]
    return after[0] if after else None


def mean_seconds(run, names, self_time=False):
    """Seconds a window job spends in the spans `names` (their self seconds
    with `self_time`), averaged over the window's jobs; None when no job
    recorded one of them."""
    jobs = window_jobs(run)
    if not jobs or not any(n in j["totals"] for j in jobs for n in names):
        return None
    field = 2 if self_time else 1
    return sum(j["totals"][n][field] for j in jobs for n in names
               if n in j["totals"]) / len(jobs)


def counter_ratio(run, num, den):
    """100 * the sum of counter `num` over the sum of counter `den`, over
    the window's jobs; None when `den` sums to 0."""
    jobs = window_jobs(run)
    if not jobs:
        return None
    top = sum(j["counters"].get(num, 0) for j in jobs)
    bottom = sum(j["counters"].get(den, 0) for j in jobs)
    return 100.0 * top / bottom if bottom else None


def wall(job, t_ns):
    """A time of `job` on perf_counter (ns) as wall-clock seconds, through
    the job's anchor pair."""
    wall_ns, perf_ns = job["anchor"]
    return (wall_ns + (t_ns - perf_ns)) / 1e9


def covered(a, b, gaps):
    """Seconds of [a, b] that the intervals `gaps` cover (the gaps do not
    overlap one another)."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for lo, hi in gaps)


def busy_share(intervals, gaps):
    """The share, in percent, of the intervals (wall-clock seconds) that no
    idle gap covers; None for intervals of no length."""
    total = sum(b - a for a, b in intervals)
    if total <= 0:
        return None
    idle = sum(covered(a, b, gaps) for a, b in intervals)
    return 100.0 * (1.0 - idle / total)


def span_busy_share(run, name):
    """busy_share of the traced job's spans `name` against the trace's idle
    gaps; None without a trace, the recorder or such a span."""
    if run.trace is None:
        return None
    job = traced_job(run)
    if job is None:
        return None
    spans = recorder().spans(job["id"]) or []
    intervals = [(wall(job, s["t0"]), wall(job, s["t1"])) for s in spans
                 if s["name"] == name]
    if not intervals:
        return None
    return busy_share(intervals, run.trace["gaps"])


def setup_seconds(run, names):
    """Seconds in the spans `names` that ended before the window's first
    job: the process's own spans and the totals of the jobs before it (the
    warm-up); None without the recorder."""
    rec = recorder()
    if rec is None or not run.jobs:
        return None
    first = run.jobs[0]["t0"] * 1e9
    secs = sum((s["t1"] - s["t0"]) / 1e9 for s in rec.spans(0) or []
               if s["name"] in names and s["t1"] <= first)
    secs += sum(j["totals"][n][1] for j in _ended(rec) if j["t1"] <= first
                for n in names if n in j["totals"])
    return secs
