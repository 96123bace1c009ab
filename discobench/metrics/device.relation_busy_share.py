"""device.relation_busy_share: the share, in percent, of the traced job's
overlapRelation span, placed on the wall clock through its job's anchor,
that no idle gap of the card covers (device); None without a trace."""
from discobench.lib.spans import span_busy_share


def read(run):
    return span_busy_share(run, "overlapRelation")
