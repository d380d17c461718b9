"""HED's side-output tail kernel launched a picture: the counter
``hed.tail_kernel`` (``ops/kernels/hed_fuse.py:hed_tail_kernel``) of the
``hed.fuse`` spans of the profiled requests, over their images. It says
whether the tail ran on the card (1 a picture) or as the plain version
or numpy (0)."""

from portbench.metrics import _request_spans


def read(run):
    return _request_spans.counter_per_image(run, "hed.fuse",
                                            "hed.tail_kernel")
