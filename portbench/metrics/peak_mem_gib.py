"""The device's peak allocation over the window, weights resident, in GiB
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
the window's start)."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
