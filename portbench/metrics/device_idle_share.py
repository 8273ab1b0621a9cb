"""The share of the traced requests' time in which the device ran nothing:
1 less the union of its events' spans over that time, in %."""


def read(run):
    if run.trace is None or run.traced_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.traced_s)
