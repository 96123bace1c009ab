"""dist.host_s: seconds a job's sharded relation (dist.relation:
dist/builder.py::_relation, buildg -n N) spends on the host's own work: the
spans dist.build (the chunk plan and the engine, its table shards and
payload put on the devices), dist.marked (the contained-read mask),
dist.windows (the shards' windows enqueued), dist.step (the superstep and
its compaction enqueued), dist.order (the pulled rows decoded and put in
relation order), dist.replay (the containment replay), dist.fallback (a
chunk re-run exactly) and dist.join (the columns joined), averaged over the
window's jobs."""
from discobench.lib.spans import mean_seconds

SPANS = ("dist.build", "dist.marked", "dist.windows", "dist.step",
         "dist.order", "dist.replay", "dist.fallback", "dist.join")


def read(run):
    return mean_seconds(run, SPANS)
