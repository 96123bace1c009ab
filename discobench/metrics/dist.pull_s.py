"""dist.pull_s: seconds a job's sharded relation (dist.relation) spends in
the span dist.pull: every shard's count read, which waits for the shards'
superstep, and their kept rows gathered to the host, averaged over the
window's jobs."""
from discobench.lib.spans import mean_seconds


def read(run):
    return mean_seconds(run, ("dist.pull",))
