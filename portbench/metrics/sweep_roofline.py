"""The multi-tree sweeps' share of their roofline, in %: the least time in
which the card moves the bytes of the traced requests' center steps
(`portbench.counts.center_step_bytes`: every tree's codes, each lane's
weights read and written once, its tile sums written), over the device
time of the kernels named in `KERNELS`.  Nothing to read where none of
them ran."""

from portbench import counts

KERNELS = ("sweep_kernel", "sweep_tiles_kernel")


def read(run):
    if run.trace is None or not run.traced:
        return None
    seconds, launches = run.trace.kernel(KERNELS)
    if launches == 0 or seconds <= 0:
        return None
    s = run.shapes
    steps = s["k"] * len(run.traced)
    step = counts.center_step_bytes(s["n_pad"], s["levels"], s["trees"],
                                    s["lanes"], s["tile"])
    return 100.0 * counts.bound_seconds(steps * step) / seconds
