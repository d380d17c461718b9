"""Phase timing, spans and counters, the request watchdog and device memory
(port of ``utils/profiling.py``).

``PhaseTimer`` collects wall seconds per named phase and renders them, with
the card's memory, as the JSON line ``inference()`` returns in ``timings``.
On the card a phase synchronizes the device when it ends, so that it times
the work its kernels do and not only their launches.

Spans and counters mark a request's host work at the program's layer
boundaries: ``with SPAN:`` for a ``Span`` made once, ``count(name, n)``
added to the innermost open span. They are recorded only while a
``torch.profiler`` profile is active on the calling thread; otherwise a
span costs one flag check and allocates nothing. A recorded span is
stamped with ``time.time_ns()``, the clock on which the profiler reports
its host and device events, so the device's work can be put against the
span that was open on the host. The spans stay out of the profile itself:
a ``record_function`` range would reach the device trace as a range of
its own and hide the idle time under it. Finished spans stay in a bounded
buffer (the newest 65,536), which ``recorded_spans()`` returns without
draining. ``PhaseTimer``'s phases are spans too.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import threading
import time
from typing import Dict, List, Optional

import torch

_profiling = torch._C._autograd._profiler_enabled


class SpanRecord:
    """A finished (or still open) span: its name, start and end on
    ``time.time_ns()``, its id, its parent's id (None for a root) and its
    root's id, which every span of one request shares; and the counters
    added while it was the innermost open span."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "root",
                 "counters")

    def __init__(self, name, span_id, parent, root):
        self.name = name
        self.id, self.parent, self.root = span_id, parent, root
        self.counters: Dict[str, int] = {}
        self.end_ns = 0
        self.start_ns = time.time_ns()


class _OpenSpans(threading.local):
    """A thread's open spans as (Span, SpanRecord), innermost last."""

    def __init__(self):
        self.stack = []


_OPEN = _OpenSpans()
_DONE = collections.deque(maxlen=65536)
_IDS = itertools.count(1)


class Span:
    """A named span, made once and entered as often as wanted: ``with
    span:`` around a block, or ``@span`` around a function."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _profiling():
            stack = _OPEN.stack
            parent = stack[-1][1] if stack else None
            span_id = next(_IDS)
            stack.append((self, SpanRecord(
                self.name, span_id, parent.id if parent else None,
                parent.root if parent else span_id)))
        return self

    def __exit__(self, exc_type, exc, tb):
        # a span entered while nothing was recorded has no record to end
        stack = _OPEN.stack
        if stack and stack[-1][0] is self:
            rec = stack.pop()[1]
            rec.end_ns = time.time_ns()
            _DONE.append(rec)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            with self:
                return fn(*args, **kw)

        return run


def count(name: str, n: int = 1):
    """Adds ``n`` to the counter ``name`` of the innermost open span;
    nothing when no span is recorded."""
    stack = _OPEN.stack
    if stack:
        counters = stack[-1][1].counters
        counters[name] = counters.get(name, 0) + n


def recorded_spans() -> List[SpanRecord]:
    """The finished spans, oldest first (children before their parents);
    the buffer keeps them."""
    return list(_DONE)


_PHASE_SPANS: Dict[str, Span] = {}


class PhaseTimer:
    """Collects wall-clock seconds per named phase; renders the
    reference-style perf summary line."""

    def __init__(self):
        self.phases: Dict[str, float] = {}
        self._start = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        """Times the block, as a span of the same name when recorded."""
        span = _PHASE_SPANS.get(name)
        if span is None:
            span = _PHASE_SPANS[name] = Span(name)
        t0 = time.perf_counter()
        with span:
            try:
                yield
            finally:
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                self.phases[name] = self.phases.get(name, 0.0) + (
                    time.perf_counter() - t0
                )

    @property
    def total(self) -> float:
        return time.perf_counter() - self._start

    def summary(self, **extra) -> str:
        rec = {
            "total_s": round(self.total, 4),
            **{f"{k}_s": round(v, 4) for k, v in self.phases.items()},
            **extra,
        }
        mem = device_memory_stats()
        if mem:
            rec.update(mem)
        return json.dumps(rec)


def device_memory_stats() -> Optional[Dict[str, float]]:
    """Device memory of the current card in MiB: what this process's tensors
    take and the card's total, under the JAX package's keys. None when no
    card has been used."""
    if not torch.cuda.is_initialized():
        return None
    _, total = torch.cuda.mem_get_info()
    return {
        "hbm_in_use_mb": round(torch.cuda.memory_allocated() / 2**20, 1),
        "hbm_limit_mb": round(total / 2**20, 1),
    }


class Watchdog:
    """Per-generation timeout (reference: a 360 s assert inside model_fn,
    model_k_diffusion.py:1094-1095; timeout at app.py:261), checked at the
    phase boundaries and, on the chunked path, between chunks."""

    def __init__(self, timeout_s: float = 360.0):
        self.timeout_s = timeout_s
        self.start = time.time()

    def check(self):
        if self.timeout_s > 0 and time.time() - self.start > self.timeout_s:
            raise TimeoutError(
                f"inference exceeded {self.timeout_s}s watchdog"
            )
