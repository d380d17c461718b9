"""The host's wait for results: the ``to_host`` spans
(``models/_nets.py:to_host``: the host blocked on the device's queued
work, then the pageable copy) of the profiled requests, summed, in ms an
image."""

from portbench.metrics import _request_spans


def read(run):
    return _request_spans.ms_per_image(run, "to_host")
