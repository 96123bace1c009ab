"""dist.collective_s: device seconds of the traced job's collectives on
rank 0's card (dist.exchange across cards: NCCL's kernels, lib/links.py's
NCCL_KERNELS, its all_to_all and all_gather; their wait for the slowest
peer included).  None without a trace or such a kernel: a job in one
process runs none."""
from discobench.lib.links import NCCL_KERNELS


def read(run):
    return run.kernel_seconds(NCCL_KERNELS)
