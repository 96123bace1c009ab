"""ranks.overhead_s: seconds a job of one process a rank (`buildg -n N
-procs`: dist.ranks) spends on the ranks themselves, not the build: the
spans ranks.launch (the rank processes started, until each is up),
ranks.group (the process group formed and a warm-up collective: NCCL's
communicator), ranks.gather (the ranks' spans and counters brought to rank
0) and ranks.exit (the group destroyed, the ranks waited for), averaged
over the window's jobs.  None where no job recorded them."""
from discobench.lib.spans import mean_seconds

SPANS = ("ranks.launch", "ranks.group", "ranks.gather", "ranks.exit")


def read(run):
    return mean_seconds(run, SPANS)
