"""kernel.dual_check_slot_use: the share, in percent, of the dual check's
candidate slots that held a candidate (kernels: the counters
relation.candidates over relation.slots, cand_cap a chunk), over the
window's jobs."""
from discobench.lib.spans import counter_ratio


def read(run):
    return counter_ratio(run, "relation.candidates", "relation.slots")
