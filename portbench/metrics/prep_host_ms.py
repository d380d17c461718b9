"""The HED detector's host preparation a picture: its ``hed.prepare`` span
(``models/hed.py:detect_edges``: uint8 to float32, the edge padding, the
pageable copy to the device) in the profiled requests, in ms an image."""

from portbench.metrics import _request_spans


def read(run):
    return _request_spans.ms_per_image(run, "hed.prepare")
