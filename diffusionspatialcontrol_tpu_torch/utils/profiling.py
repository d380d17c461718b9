"""Phase timing, the request watchdog, device memory and profiler traces
(port of ``utils/profiling.py``).

``PhaseTimer`` collects wall seconds per named phase and renders them, with
the card's memory, as the JSON line ``inference()`` returns in ``timings``.
On the card a phase synchronizes the device when it ends, so that it times
the work its kernels do and not only their launches.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Collects wall-clock seconds per named phase; renders the
    reference-style perf summary line."""

    def __init__(self):
        self.phases: Dict[str, float] = {}
        self._start = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
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


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Optional ``torch.profiler`` trace around a generation: host ops and,
    when a card is there, its kernels, written to ``log_dir`` as a
    Chrome trace. No caller in the package yet: the port's benchmark
    (ROADMAP item 10) is where a traced generation belongs."""
    if not log_dir:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
