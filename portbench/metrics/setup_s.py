"""Set-up seconds (host clock): from the start of the process to the
window's start: imports, the points, the plan, the prepare, the kernels'
build or load and the warm-up requests."""


def read(run):
    return run.setup_s
