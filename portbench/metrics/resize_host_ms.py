"""The resizes' host time: the ``resize`` spans (``ops/resize.py:resize``,
the weight matrices built on the device and the products launched) of the
profiled requests, summed, in ms an image."""

from portbench.metrics import _request_spans


def read(run):
    return _request_spans.ms_per_image(run, "resize")
