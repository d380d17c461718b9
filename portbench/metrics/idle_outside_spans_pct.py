"""What the program's spans leave unexplained: of the device's idle time
within the profiled requests' root spans, the share during which none of
the roots' child spans was open on the host."""

from portbench.metrics import _request_spans


def read(run):
    idle, outside = _request_spans.idle_ns(run)
    return 100.0 * outside / idle if idle > 0 else None
