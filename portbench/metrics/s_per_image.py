"""Seconds an image: the window's start to the end of its last request,
over the images its requests completed (all the work over all the time)."""


def read(run):
    return run.window_s / run.images if run.images else None
