"""dist.fallback_share: the share, in percent, of the sharded relation's
chunks that were re-run exactly on the host path because a hit, route or
fetch cap overflowed (dist.relation: the counters dist.fallback_chunks
over dist.chunks), over the window's jobs."""
from discobench.lib.spans import counter_ratio


def read(run):
    return counter_ratio(run, "dist.fallback_chunks", "dist.chunks")
