"""The device's peak of allocated memory over the window
(`torch.cuda.max_memory_allocated` after a reset at its start), in GiB."""

GIB = float(1 << 30)


def read(run):
    return run.peak_bytes / GIB if run.peak_bytes > 0 else None
