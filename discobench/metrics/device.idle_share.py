"""device.idle_share: the share of the traced job's wall, in percent, in
which no kernel or copy ran on the card (1 - the union of the card's
intervals over the wall)."""


def read(run):
    if run.trace is None or run.trace["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["wall_s"])
