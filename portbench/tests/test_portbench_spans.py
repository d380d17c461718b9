"""The readers of the program's spans and counters on hand-made spans and
device events (CPU): which requests they take, the sums, the self time,
the idle share no span explains, and nothing where there is nothing to
read."""

import pytest

from diffusionspatialcontrol_tpu_torch.utils import profiling
from portbench.harness import Run
from portbench.metrics import (fuse_host_ms, idle_outside_spans_pct,
                               prep_host_ms, resize_builds_per_image,
                               resize_host_ms, to_host_ms)

READERS = (prep_host_ms, resize_host_ms, to_host_ms, fuse_host_ms,
           resize_builds_per_image, idle_outside_spans_pct)
US = 1_000  # ns


def _span(name, start, end, sid, parent, root, **counters):
    rec = profiling.SpanRecord(name, sid, parent, root)
    rec.start_ns, rec.end_ns, rec.counters = start * US, end * US, counters
    return rec


def _request(root_id, t0):
    """A request's spans (children first, as they end) from ``t0`` µs:
    prepare 10, net 10, two resizes 5 each (the second built 2 matrices),
    two copies 10 each, fuse 30 with a child of 10, then 20 under no
    child span."""
    r, t = root_id, t0
    return [
        _span("hed.prepare", t, t + 10, r + 1, r, r),
        _span("hed.net", t + 10, t + 20, r + 2, r, r),
        _span("resize", t + 20, t + 25, r + 3, r, r),
        _span("to_host", t + 25, t + 35, r + 4, r, r),
        _span("resize", t + 35, t + 40, r + 5, r, r,
              **{"resize.weights_built": 2}),
        _span("to_host", t + 40, t + 50, r + 6, r, r),
        _span("other", t + 60, t + 70, r + 8, r + 7, r),
        _span("hed.fuse", t + 50, t + 80, r + 7, r, r),
        _span("preprocess", t, t + 100, r, None, r),
    ]


def _run(events, images=1, requests=1):
    return Run(profile={"events": events, "wall_s": 1e-4, "images": images,
                        "requests": requests, "gaps": []})


@pytest.fixture
def spans(monkeypatch):
    # request 100 was profiled kernels only (the device events below lie in
    # it); request 200 with the host's ops, whose device events the run
    # does not keep
    recorded = _request(100, 1_000) + _request(200, 5_000)
    monkeypatch.setattr(profiling, "recorded_spans", lambda: recorded)
    return recorded


def test_the_readers_sum_the_profiled_requests_spans(spans):
    run = _run([("k", 1_015 * US, 1_030 * US), ("c", 1_030 * US,
                                                  1_045 * US)])
    assert prep_host_ms.read(run) == pytest.approx(0.010)
    assert resize_host_ms.read(run) == pytest.approx(0.010)
    assert to_host_ms.read(run) == pytest.approx(0.020)
    assert fuse_host_ms.read(run) == pytest.approx(0.020)  # self time
    assert resize_builds_per_image.read(run) == 2.0
    # idle within the root: 100 - 30 busy = 70 µs; of it no child span
    # covers the last 20
    assert idle_outside_spans_pct.read(run) == pytest.approx(100 * 20 / 70)


def test_two_profiled_requests_are_read_per_image(spans):
    run = _run([("k", 1_015 * US, 1_030 * US), ("k", 5_015 * US,
                                                  5_030 * US)],
               images=4, requests=2)
    assert prep_host_ms.read(run) == pytest.approx(0.020 / 4)
    assert resize_builds_per_image.read(run) == 1.0


def test_a_request_that_counted_no_build_reads_zero(monkeypatch):
    recorded = [s for s in _request(100, 0) if s.counters == {}]
    monkeypatch.setattr(profiling, "recorded_spans", lambda: recorded)
    run = _run([("k", 15 * US, 30 * US)])
    assert resize_builds_per_image.read(run) == 0.0


@pytest.mark.parametrize("case", ["no_profile", "no_device_events",
                                  "no_request_holds_them",
                                  "program_without_spans",
                                  "root_not_preprocess"])
def test_nothing_to_read_reads_nothing(spans, monkeypatch, case):
    run = _run([("k", 9_000 * US, 9_010 * US)])  # after both requests
    if case == "no_profile":
        run = Run(profile=None)
    elif case == "no_device_events":
        run = _run([])
    elif case == "program_without_spans":
        run = _run([("k", 1_015 * US, 1_030 * US)])
        monkeypatch.delattr(profiling, "recorded_spans")
    elif case == "root_not_preprocess":
        # an ``inference()`` request: its phase ``to_host`` and a mask's
        # ``resize`` are other work under the readers' names
        recorded = _request(100, 1_000)
        recorded[-1].name = "inference"
        monkeypatch.setattr(profiling, "recorded_spans", lambda: recorded)
        run = _run([("k", 1_015 * US, 1_030 * US)])
    for reader in READERS:
        assert reader.read(run) is None, reader.__name__
