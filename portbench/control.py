"""The readings a cell's output-check limit is set from, at the cell's own
size, on the card (the benchmark's runs never run this):

    python3 portbench/control.py --workload <name> --seeds 1,2,... \\
        --control-seeds 1,2,3

For each seed, in one process: the weights made from the seed, the
program driven as a run drives it (one warm-up request, then the cell's
first ``check_requests`` requests back to back: the cell's own load, a
closed loop of one client), then the plain reference in float32 on the
same requests; each comparison of the cell's limits file (``check.py``)
of the program against it is a lower reading. For each control seed the
reference is also computed in the configuration's ``control`` precision,
the one below the type it states (``fp8`` below bfloat16: every operand
of a matrix product or convolution rounded to float8 e4m3; ``tf32``
below float32: rounded to TF32), and compared with the float32
reference the same way: an upper reading. With ``--faults``, each fault
of ``faults.py`` for the cell's program (a step fault at the first step
and at the middle one) is planted for the first request of each control
seed, and its answer is read against the same float32 reference. One
JSON line a seed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import check, harness, spec, traffic, weights  # noqa: E402
from portbench.faults import FAULTS  # noqa: E402


def _compare(cell, got, want) -> dict:
    """Each comparison of the cell's limits file, the worst over the
    requests."""
    return {n: max(getattr(check, n)(g, w) for g, w in zip(got, want))
            for n in cell.limits}


def readings(cell, seed, control: bool, faults: bool, dev) -> dict:
    import torch

    cfg, mix = cell.config, cell.traffic()
    reference = cell.module("reference", cfg["reference"])
    program_mod = cell.module("programs", cfg["program"])
    reqs = [traffic.request(mix, seed, i)
            for i in range(int(mix["check_requests"]))]
    w, flat = weights.make(cfg, seed, dev.device)
    program = program_mod.Program(cfg, w, dev.device, weights.dtype_of(cfg))
    program.run(traffic.request(mix, seed, 0, traffic.WARMUP))
    t0 = time.perf_counter()
    got = [program.run(r)[0] for r in reqs]
    t_prog = time.perf_counter() - t0
    planted = {}
    if control and faults:
        variants = []
        for name in FAULTS[cfg["program"]]:
            if name == "step_left_unchanged":
                variants += [(name, {"step": 0}),
                             (name, {"step": reqs[0]["steps"] // 2})]
            else:
                variants.append((name, {}))
        for name, kw in variants:
            with FAULTS[cfg["program"]][name](**kw):
                key = name + "".join(f"_{k}{v}" for k, v in kw.items())
                planted[key] = program.run(reqs[0])[0]
    del program
    dev.free()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"seed": seed, "requests": len(reqs), "program_s": t_prog}
    t0 = time.perf_counter()
    want = [reference.generate(w, cfg, r, "fp32", dev.device) for r in reqs]
    out["reference_s"] = time.perf_counter() - t0
    out["program_vs_reference"] = _compare(cell, got, want)
    for key, answer in planted.items():
        out[f"fault_{key}_vs_reference"] = _compare(cell, [answer], want[:1])
    if control:
        t0 = time.perf_counter()
        low = [reference.generate(w, cfg, r, cfg["control"], dev.device)
               for r in reqs]
        out["control_s"] = time.perf_counter() - t0
        out[f"{cfg['control']}_control_vs_reference"] = _compare(cell, low,
                                                                 want)
    del w, flat
    dev.free()
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", action="store_true")
    args = p.parse_args()
    import torch

    cell = spec.Cell(spec.load(spec.ROOT), args.workload, spec.HERE,
                     spec.ROOT)
    dev = harness.Device("cuda")
    control = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    seeds += [s for s in sorted(control) if s not in seeds]
    for s in seeds:
        r = readings(cell, s, s in control, args.faults, dev)
        r["workload"] = cell.name
        r["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
