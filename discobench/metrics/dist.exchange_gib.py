"""dist.exchange_gib: GiB a job's sharded relation sends through its
all_to_all exchanges (dist.exchange: the counters dist.route_bytes, the
key-owner lookup's codes out and answers back, and dist.fetch_bytes, the
payload fetch's requests and rows; the padded buffers as sent), averaged
over the window's jobs.  None where no window job counted either."""
from discobench.lib.spans import window_jobs

COUNTERS = ("dist.route_bytes", "dist.fetch_bytes")


def read(run):
    jobs = window_jobs(run)
    if not jobs or not any(c in j["counters"] for j in jobs
                           for c in COUNTERS):
        return None
    total = sum(j["counters"].get(c, 0) for j in jobs for c in COUNTERS)
    return total / len(jobs) / float(1 << 30)
