"""simplify.driver_self_s: seconds of a job's fullsimplify span that none of
its stages owns (simplify.driver: the phase dumps and checkpoint writes
between the stages), averaged over the window's jobs."""
from discobench.lib.spans import mean_seconds


def read(run):
    return mean_seconds(run, ("fullsimplify",), self_time=True)
