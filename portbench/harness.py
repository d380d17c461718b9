"""One run of one cell: set-up, a measured window of a closed loop, with
``--trace 1`` profiled requests after it, then the output check.

Set-up (``setup_s``, from the start of the process): imports, the
weights made on the device from the seed, the program's conversion of
them, and one warm-up request of the cell's own shape, which builds and
loads the program's kernels (cached under the checkout's
``build/torch_kernels``, so only a checkout's first run compiles).

The window: request after request through the program, each sent when
the last one's images are on the host, until ``--seconds`` have passed;
the request in flight then finishes and counts. Each request's wall time
is taken on the host's clock around the call; its ``timings`` phases come
from the program. The device's peak allocation is read over the window,
after ``reset_peak_memory_stats`` at its start, with the weights resident.

With ``--trace 1`` the window is timed the same way, without the profiler;
then requests at the end are profiled, kernels only (the counts, shares
and breakdown), and one more with the host's ops (the idle gaps by host
op). Nothing is timed after a profiler has run: it leaves the host slower.

The output check runs after the window and the profiles, once the peak is
read and the program is freed: the weights are made again from the seed
(their bits checked against set-up's), and the plain reference computes a
sample of the window's requests, drawn from the seed as they complete, in
float32 with TF32 off; each request's answer is compared with the
program's by every comparison the cell's limits file names
(``check.py``) and held to its limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
import traceback
from typing import Dict, List, Optional

from . import check, flops, profiles, spec, traffic, weights

FORBIDDEN = ("jax", "jaxlib", "flax", "diffusionspatialcontrol_tpu")
PROFILED_REQUESTS = 1


class Device:
    """The few calls the harness makes of its device; on the CPU (the tests)
    they do nothing."""

    def __init__(self, device):
        import torch

        self.torch, self.device = torch, torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        return (self.torch.cuda.max_memory_allocated(self.device)
                if self.cuda else 0)

    def free(self):
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()

    def info(self, chips: int, peak: int) -> dict:
        return {"platform": "gpu" if self.cuda else "cpu",
                "kind": (self.torch.cuda.get_device_name(self.device)
                         if self.cuda else "cpu"),
                "count": chips, "memory_peak_bytes": peak}


class Run:
    """What the metric readers read (``metrics/<name>.py``, ``read(run)``).

    ``requests``: the window's requests in order, each a dict with
    ``latency_s`` (host clock, call to images on the host), ``phases``
    (the program's ``timings``, seconds by phase) and ``images`` (count).
    ``window_s``: the window's start to its last request's end.
    ``request_ops``: one request's counted operations (``flops.py``);
    ``dtype``: the configuration's type, which picks its peak.
    ``profile``: None, or the profiled requests' ``events`` (device
    operations: name, start ns, end ns), ``wall_s`` (host clock around
    them), ``requests`` and ``images``."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _window(program, mix, seed, seconds, err):
    records: List[dict] = []
    images: Dict[int, object] = {}  # the answers the check may compare
    sample = traffic.CheckSample(mix, seed)
    failed = 0
    t0 = time.perf_counter()
    i = 0
    while True:
        req = traffic.request(mix, seed, i)
        ts = time.perf_counter()
        try:
            out, phases = program.run(req)
        except Exception:  # a failed request counts, and the loop goes on
            traceback.print_exc(file=err)
            failed += 1
            out, phases = None, {}
        te = time.perf_counter()
        records.append({"index": i, "latency_s": te - ts, "phases": phases,
                        "images": 0 if out is None else int(out.shape[0])})
        if out is not None:
            keep, dropped = sample.offer(i)
            if keep:
                images[i] = out
            images.pop(dropped, None)
        i += 1
        if te - t0 >= seconds:
            return records, images, failed, te - t0


def _profile(program, mix, seed, start, dev):
    """Kernels-only profile of ``PROFILED_REQUESTS`` requests, then one
    request with the host's ops for the idle gaps."""
    from torch.profiler import ProfilerActivity, profile

    reqs = [traffic.request(mix, seed, start + k)
            for k in range(PROFILED_REQUESTS + 1)]
    dev.sync()
    # the CPU (the tests) has no device activity to record
    kernels_only = [ProfilerActivity.CUDA if dev.cuda
                    else ProfilerActivity.CPU]
    with profile(activities=kernels_only) as prof:
        t0 = time.perf_counter()
        n_images = 0
        for req in reqs[:-1]:
            out, _ = program.run(req)
            n_images += int(out.shape[0])
        wall = time.perf_counter() - t0
    events = profiles.device_events(prof)
    del prof
    with profile(activities=[ProfilerActivity.CPU]
                 + kernels_only * dev.cuda) as prof:
        program.run(reqs[-1])
    gaps = profiles.idle_gaps(profiles.device_events(prof),
                              profiles.host_ops(prof))
    del prof
    return {"events": events, "wall_s": wall, "requests": len(reqs) - 1,
            "images": n_images, "gaps": gaps}


def _breakdown(profile: dict) -> dict:
    kernels = profiles.by_kernel(profile["events"])
    groups = sorted(((f"group {g}", s) for g, s in
                     profiles.by_group(kernels).items() if s > 0),
                    key=lambda kv: -kv[1])[:5]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    ops = groups + [(n[:160], s) for n, (s, _) in top[:10 - len(groups)]]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in profile["gaps"]]}


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, out=None, err=None) -> int:
    """The run; prints the result line and returns the exit code."""
    import torch

    out = out or sys.stdout
    err = err or sys.stderr
    cfg = cell.config
    mix = cell.traffic()
    dev = Device(device)
    reference = cell.module("reference", cfg["reference"])
    program_mod = cell.module("programs", cfg["program"])

    w, flat = weights.make(cfg, seed, dev.device)
    made = weights.checksum(flat)
    program = program_mod.Program(cfg, w, dev.device, weights.dtype_of(cfg))
    del w, flat
    dev.free()
    program.run(traffic.request(mix, seed, 0, traffic.WARMUP))
    dev.sync()
    setup_s = time.perf_counter() - t_start

    dev.reset_peak()
    records, images, failed, window_s = _window(program, mix, seed, seconds,
                                                err)
    peak = dev.peak()
    profile = (_profile(program, mix, seed, len(records), dev)
               if traced else None)
    run_rec = Run(
        requests=records, window_s=window_s, setup_s=setup_s,
        peak_bytes=peak, images=sum(r["images"] for r in records),
        request_ops=list(flops.request_ops(
            cfg, traffic.request(mix, seed, 0))),
        profile=profile, peaks=cell.peaks, dtype=cfg["dtype"])
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = cell.reader(m)(run_rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    del program
    dev.free()

    # the output check
    t_check = time.perf_counter()
    sample = sorted(images)
    w, flat = weights.make(cfg, seed, dev.device)
    same_weights = weights.checksum(flat) == made
    limits = {n: float(v["limit"]) for n, v in cell.limits.items()}
    worst = {n: 0.0 for n in limits}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for i in sample:
            want = reference.generate(w, cfg, traffic.request(mix, seed, i),
                                      "fp32", dev.device)
            for n in limits:
                worst[n] = max(worst[n], getattr(check, n)(images[i], want))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    del w, flat
    t_check = time.perf_counter() - t_check
    correct = (bool(sample) and same_weights and failed == 0
               and all(math.isfinite(worst[n]) and worst[n] <= limits[n]
                       for n in limits))

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}; the "
              f"benchmark measures the PyTorch port alone", file=err)
        return 3

    checks = {n: {"value": worst[n], "limit": limits[n]} for n in limits}
    checks.update({
        "failed_requests": {"value": failed, "limit": 0},
        "weights_remade_equal": {"value": int(same_weights), "limit": 1},
        "requests_checked": {"value": len(sample), "limit": 1},
    })
    result = {"correct": correct, "attempted": len(records),
              "failed": failed, "metrics": metrics,
              "device": dev.info(cell.chips, peak)}
    if profile is not None:
        result["device"]["busy_s"] = profiles.busy_ns(profile["events"]) / 1e9
        result["device"]["window_s"] = profile["wall_s"]
        result["breakdown"] = _breakdown(profile)
    result["checks"] = checks
    print(f"portbench: {cell.name} seed {seed}: {len(records)} requests "
          f"in {window_s:.3f} s, set-up {setup_s:.3f} s, checked requests "
          f"{sample} in {t_check:.1f} s; request seconds "
          f"{[round(r['latency_s'], 4) for r in records]}", file=err)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="The port's benchmark: one cell "
                                "of BENCHMARK.json, one seed, one window.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None,
         t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    cell = spec.Cell(spec.load(spec.ROOT), args.workload, spec.HERE,
                     spec.ROOT)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {found}", file=sys.stderr)
        return 2
    return run(cell, args.seed, args.seconds, bool(args.trace),
               torch.device("cuda"), t_start)
