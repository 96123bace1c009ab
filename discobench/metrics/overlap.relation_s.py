"""overlap.relation_s: seconds a job spends on the overlap relation, the
chunks of windows looked up and checked on the card and ordered on the host
(overlap.relation and overlap.device; the `clock` stage overlapRelation),
averaged over the window's jobs."""


def read(run):
    return run.stage_mean(("overlapRelation",))
