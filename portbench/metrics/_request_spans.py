"""The program's own spans (``utils/profiling.py``) of the profiled
requests, for the readers of ``program_span`` and ``program_counter``
metrics.

A request is a root span ``preprocess`` (``app/api.py``, a detector's
call) whose interval holds a device operation of the kernels-only profile
(``run.profile["events"]``): the spans and the profile share one clock, so
the match is by time and not by order. Other roots (``inference``, whose
phase ``to_host`` and masks' ``resize`` are other work under the same
names) are not read. Where the program records no spans, or the run has
no device trace, there is no request and the readers report nothing.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from portbench import profiles


def requests(run) -> List[Tuple[object, list]]:
    """[(root ``preprocess`` span, every span of its request)], in the
    roots' order."""
    p = run.profile
    if not p or not p["events"]:
        return []
    try:
        from diffusionspatialcontrol_tpu_torch.utils import profiling
    except ImportError:
        return []
    recorded = getattr(profiling, "recorded_spans", None)
    if recorded is None:
        return []
    spans = recorded()
    starts = [s for _, s, _ in p["events"]]
    by_root: Dict[int, list] = {}
    for s in spans:
        by_root.setdefault(s.root, []).append(s)
    out = []
    for root in (s for s in spans
                 if s.parent is None and s.name == "preprocess"):
        i = bisect.bisect_left(starts, root.start_ns)
        if i < len(starts) and starts[i] <= root.end_ns:
            out.append((root, by_root[root.id]))
    return out


def images(run, n_requests: int) -> float:
    """The images of ``n_requests`` of the profiled requests."""
    p = run.profile
    return n_requests * p["images"] / p["requests"]


def union_ns(intervals, lo: int, hi: int) -> int:
    """The length of the union of ``intervals`` ((start, end) pairs)
    within [lo, hi]."""
    total, reach = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            total += e - s
            reach = e
    return total


def self_ns(span, spans) -> int:
    """A span's duration less the part its child spans cover."""
    children = [(c.start_ns, c.end_ns) for c in spans if c.parent == span.id]
    return (span.end_ns - span.start_ns) - union_ns(
        children, span.start_ns, span.end_ns)


def ms_per_image(run, name: str, self_time: bool = False
                 ) -> Optional[float]:
    """The spans named ``name`` of the profiled requests, summed (their
    self time with ``self_time``), in ms an image; None where the requests
    have none."""
    reqs = requests(run)
    total, found = 0, False
    for _, spans in reqs:
        for s in spans:
            if s.name == name:
                found = True
                total += (self_ns(s, spans) if self_time
                          else s.end_ns - s.start_ns)
    return total / 1e6 / images(run, len(reqs)) if found else None


def counter_per_image(run, span_name: str, counter: str
                      ) -> Optional[float]:
    """The counter ``counter`` of the spans named ``span_name`` of the
    profiled requests, summed, an image (0 where such spans counted none);
    None where the requests have no such span."""
    reqs = requests(run)
    total, found = 0, False
    for _, spans in reqs:
        for s in spans:
            if s.name == span_name:
                found = True
                total += s.counters.get(counter, 0)
    return total / images(run, len(reqs)) if found else None


def idle_ns(run) -> Tuple[int, int]:
    """(the device's idle ns within the profiled requests' root spans,
    the part of it during which none of the roots' child spans was open);
    (0, 0) where there is no request."""
    reqs = requests(run)
    if not reqs:
        return 0, 0
    busy = profiles.busy_intervals(run.profile["events"])
    idle = outside = 0
    for root, spans in reqs:
        lo, hi = root.start_ns, root.end_ns
        children = [(c.start_ns, c.end_ns) for c in spans
                    if c.parent == root.id]
        idle += (hi - lo) - union_ns(busy, lo, hi)
        outside += (hi - lo) - union_ns(busy + children, lo, hi)
    return idle, outside
