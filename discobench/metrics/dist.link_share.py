"""dist.link_share: the exchange's share of its roofline, in percent: the
least time of the bytes rank 0's card sends to its peers in the traced job
(lib/links.py: its own dist.route_bytes, dist.fetch_bytes and
dist.gather_bytes, from the job's `ranks`, times (n - 1) / n) over the
card's NVLink peak, divided by the device seconds of rank 0's collectives
(dist.collective_s).  None without a trace, a job of several ranks, or
a collective kernel."""
from discobench.lib.links import NCCL_KERNELS, least_seconds, sent_bytes
from discobench.lib.spans import traced_job


def read(run):
    seconds = run.kernel_seconds(NCCL_KERNELS)
    job = traced_job(run)
    if not seconds or job is None or not job.get("ranks"):
        return None
    ranks = job["ranks"]
    return 100.0 * least_seconds(
        sent_bytes(ranks[0]["counters"], len(ranks))) / seconds
