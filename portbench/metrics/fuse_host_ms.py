"""The HED detector's numpy tail: the self time of its ``hed.fuse`` span
(``models/hed.py:detect_edges``: the side maps stacked, their mean, the
sigmoid, the crop and the three-channel stack) in the profiled requests,
in ms an image."""

from portbench.metrics import _request_spans


def read(run):
    return _request_spans.ms_per_image(run, "hed.fuse", self_time=True)
