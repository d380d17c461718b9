"""The whole request's share of the chip's dense peak for the type the
configuration is served in (``peaks.json``): the window's requests' model
operations (``flops.py``: convolutions, linear layers, attention's QK^T
and PV), over the window's wall seconds times the peak."""

from portbench import flops


def read(run):
    if not run.requests or not run.request_ops:
        return None
    per_request = sum(flops.flops(op) for op in run.request_ops)
    done = sum(1 for r in run.requests if r["images"])
    return 100.0 * done * per_request / (
        run.window_s * run.peaks["flops_per_s"][run.dtype])
