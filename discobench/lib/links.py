"""The links between the cards of a cell that spans them: what one rank's
card sends to its peers in a job, and the link's peak, for the roofline
of the exchange (dist.link_share).

The bytes come from the program's counters of that rank (utils/logging.py:
a multi-rank job's `ranks`), each counted from shapes: dist.route_bytes and
dist.fetch_bytes, the all_to_all tensors as sent, and dist.gather_bytes,
the all_gathers' results as given.  Of each, the rank's own block never
leaves its card: (n - 1) / n of it crosses the links, in an all_to_all (n
blocks, n - 1 to peers) as in an all_gather (the rank's block to each of
n - 1 peers, or n - 1 blocks forwarded round a ring).

PEAK_BYTES_S is one card's NVLink bandwidth each way.  H100 SXM5: 18
NVLink 4 links, 900 GB/s both ways, 450 GB/s each way (NVIDIA's H100
datasheet).  Checked on the four-card machine the benchmark runs on (its
`nvidia-smi topo -m` and `nvidia-smi nvlink -s`): see PERF.md section 4."""

PEAK_BYTES_S = 450e9
COUNTERS = ("dist.route_bytes", "dist.fetch_bytes", "dist.gather_bytes")
# NCCL's kernels (ncclDevKernel_SendRecv, ncclDevKernel_AllGather_RING_LL,
# ...; ncclKernel_* in older NCCL), not the profiler's "nccl:all_to_all"
# ranges on the card's track, which span the same work and would count it
# twice
NCCL_KERNELS = ("ncclDevKernel", "ncclKernel")


def sent_bytes(counters: dict, n: int) -> float:
    """Bytes a rank's card sends to its n - 1 peers, from that rank's
    counters."""
    return sum(counters.get(c, 0) for c in COUNTERS) * (n - 1) / n


def least_seconds(nbytes: float) -> float:
    """The least time `nbytes` take over the card's links."""
    return nbytes / PEAK_BYTES_S
