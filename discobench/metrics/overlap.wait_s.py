"""overlap.wait_s: seconds a job's overlap relation spends waiting for the
card and pulling from it (overlap.relation and overlap.device: the spans
relation.wait, the chunk's counts, which wait for its kernels, and
relation.pull, its rows), averaged over the window's jobs."""
from discobench.lib.spans import mean_seconds

SPANS = ("relation.wait", "relation.pull")


def read(run):
    return mean_seconds(run, SPANS)
