"""Reading a ``torch.profiler`` trace of whole requests: the device's
operations with their times, grouped by kernel name; the union of their
intervals (busy time); and the host op under each idle gap.

``KERNEL_GROUPS`` and the raw-trace reading (the kineto events, without
``key_averages``, which builds the host-side event tree first: seconds for
a request's 50,000 launches) are copies of ``chip_smoke.py``'s. The
groups are tested in order on the lower-cased kernel name.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

KERNEL_GROUPS = (
    # both attention bodies carry HAS_BIAS among their template arguments
    ("K1", lambda n: "dsc::attention" in n and "true" in n),
    ("K2", lambda n: "dsc::attention" in n and "false" in n),
    ("K4", lambda n: "conv_mma_kernel" in n or "conv_direct_kernel" in n),
    ("K5", lambda n: "conv_wgmma_kernel" in n or "conv_igemm_kernel" in n),
    ("conv", lambda n: "conv" in n or "fprop" in n or "dgrad" in n),
    ("gemm", lambda n: "gemm" in n or "nvjet" in n or "cutlass" in n),
    ("norm", lambda n: "norm" in n),
    ("other", lambda n: True),
)

# PyTorch's scaled_dot_product_attention kernels (flash, memory-efficient,
# cuDNN), so that the attention roofline follows the work whatever runs it
_SDPA = ("flash_fwd", "fmha", "attentionkernel", "sdpa")


def group_of(name: str) -> str:
    n = name.lower()
    return next(g for g, test in KERNEL_GROUPS if test(n))


def is_attention(name: str) -> bool:
    n = name.lower()
    return group_of(name) in ("K1", "K2") or any(s in n for s in _SDPA)


def is_conv(name: str) -> bool:
    return group_of(name) in ("K4", "K5", "conv")


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of every device operation (kernels, copies,
    sets) of a finished profiler run, in start order."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_hidden_event() or \
                e.name() in ("[memory]", "[OutOfMemory]"):
            continue
        out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    out.sort(key=lambda t: t[1])
    return out


def host_ops(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of the host's ops, in start order."""
    from torch.autograd import DeviceType

    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CPU]
    out.sort(key=lambda t: t[1])
    return out


def busy_intervals(events) -> List[Tuple[int, int]]:
    """The union of the events' intervals, merged, in order."""
    merged: List[List[int]] = []
    for _, s, e in events:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_ns(events) -> int:
    return sum(e - s for s, e in busy_intervals(events))


def by_kernel(events) -> Dict[str, List[float]]:
    """{name: [device seconds, launches]} of the kernels."""
    out: Dict[str, List[float]] = {}
    for name, s, e in events:
        if is_kernel(name):
            k = out.setdefault(name, [0.0, 0])
            k[0] += (e - s) / 1e9
            k[1] += 1
    return out


def by_group(kernels: Dict[str, List[float]]) -> Dict[str, float]:
    out = {g: 0.0 for g, _ in KERNEL_GROUPS}
    for name, (sec, _) in kernels.items():
        out[group_of(name)] += sec
    return out


def idle_gaps(dev, host, top: int = 10, min_ns: int = 0
              ) -> List[Tuple[str, float]]:
    """The idle gaps between the device's busy intervals, summed by the
    innermost host op that was running when each gap began, longest
    first: [(op, seconds)]."""
    busy = busy_intervals(dev)
    starts = [h[1] for h in host]
    sums: Dict[str, float] = {}
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        gap = nxt - end
        if gap <= min_ns:
            continue
        name = _innermost(host, starts, end) or "(no host op)"
        sums[name] = sums.get(name, 0.0) + gap / 1e9
    return sorted(sums.items(), key=lambda kv: -kv[1])[:top]


def _innermost(host, starts, t) -> Optional[str]:
    """The innermost host op whose interval holds ``t``: of nested ops the
    one that began last, so the first found looking back from ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 4000, -1), -1):
        name, s, e = host[j]
        if s <= t <= e:
            return name
    return None
