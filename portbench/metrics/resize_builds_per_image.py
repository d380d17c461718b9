"""Resize weight matrices built a picture: the counter
``resize.weights_built`` (``ops/resize.py:_weights``) of the ``resize``
spans of the profiled requests, over their images."""

from portbench.metrics import _request_spans


def read(run):
    return _request_spans.counter_per_image(run, "resize",
                                            "resize.weights_built")
