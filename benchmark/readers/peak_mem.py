"""Peak device memory of the window (GiB, ``torch.cuda.max_memory_allocated``)."""


def read(run):
    return run.memory_peak_bytes / 2**30 if run.memory_peak_bytes else None
