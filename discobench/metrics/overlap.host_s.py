"""overlap.host_s: seconds a job's overlap relation spends on the host's
own work (overlap.relation and overlap.device: the spans relation.upload,
relation.windows, relation.step, relation.decode, relation.order,
relation.fallback and relation.join), averaged over the window's jobs.  A
pageable copy in relation.step that waits behind the card counts here."""
from discobench.lib.spans import mean_seconds

SPANS = ("relation.upload", "relation.windows", "relation.step",
         "relation.decode", "relation.order", "relation.fallback",
         "relation.join")


def read(run):
    return mean_seconds(run, SPANS)
