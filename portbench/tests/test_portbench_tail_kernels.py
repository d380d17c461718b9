"""The reader of the HED tail kernel's counter on hand-made spans and
device events (CPU): one a picture where each ``hed.fuse`` span counted
its launch, 0 where the span counted none, nothing where there is no
``hed.fuse`` span or no profiled request."""

import pytest

from diffusionspatialcontrol_tpu_torch.utils import profiling
from portbench.harness import Run
from portbench.metrics import tail_kernels_per_image

US = 1_000  # ns


def _span(name, start, end, sid, parent, root, **counters):
    rec = profiling.SpanRecord(name, sid, parent, root)
    rec.start_ns, rec.end_ns, rec.counters = start * US, end * US, counters
    return rec


def _request(root_id, t0, **fuse_counters):
    """A request's spans from ``t0`` µs, children first as they end:
    prepare, net, the tail (``hed.fuse``) and one copy."""
    r, t = root_id, t0
    return [
        _span("hed.prepare", t, t + 10, r + 1, r, r),
        _span("hed.net", t + 10, t + 20, r + 2, r, r),
        _span("hed.fuse", t + 20, t + 21, r + 3, r, r, **fuse_counters),
        _span("to_host", t + 21, t + 40, r + 4, r, r),
        _span("preprocess", t, t + 50, r, None, r),
    ]


def _run(events, images=1, requests=1):
    return Run(profile={"events": events, "wall_s": 1e-4, "images": images,
                        "requests": requests, "gaps": []})


@pytest.mark.parametrize("launched,want", [(1, 1.0), (0, 0.0)],
                         ids=["kernel", "plain_or_numpy"])
def test_tail_kernels_are_read_per_image(monkeypatch, launched, want):
    counters = {"hed.tail_kernel": launched} if launched else {}
    recorded = _request(100, 1_000, **counters) + _request(
        200, 2_000, **counters)
    monkeypatch.setattr(profiling, "recorded_spans", lambda: recorded)
    run = _run([("k", 1_015 * US, 1_030 * US), ("k", 2_015 * US,
                                                  2_030 * US)],
               images=2, requests=2)
    assert tail_kernels_per_image.read(run) == want


@pytest.mark.parametrize("case", ["no_hed_fuse", "no_request_holds_them",
                                  "no_profile"])
def test_nothing_to_read_reads_nothing(monkeypatch, case):
    recorded = _request(100, 1_000, **{"hed.tail_kernel": 1})
    run = _run([("k", 1_015 * US, 1_030 * US)])
    if case == "no_hed_fuse":
        recorded = [s for s in recorded if s.name != "hed.fuse"]
    elif case == "no_request_holds_them":
        run = _run([("k", 9_000 * US, 9_010 * US)])
    else:
        run = Run(profile=None)
    monkeypatch.setattr(profiling, "recorded_spans", lambda: recorded)
    assert tail_kernels_per_image.read(run) is None
