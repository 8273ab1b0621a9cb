"""Device operations (kernels, copies, sets) of the traced requests over
their center steps: one step opens a center in every lane, k steps a
request."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    steps = run.shapes["k"] * len(run.traced)
    return run.trace.device_events / steps
