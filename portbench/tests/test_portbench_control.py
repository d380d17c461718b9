"""The output check's control and faults at a size a test run can hold
(CPU, tiny cells; the card's readings at each cell's own size come from
``control.py``): the reference computed in the precision below the
configuration's (TF32 below HED's float32, fp8 below Stable Diffusion's
bfloat16) must fail the limit the cell holds the program to; so must a run
whose timed path is broken underneath, once for each fault a cell of one
chip can have. A cell of one chip has no exchange between chips to leave
out.

The Stable Diffusion cases run the tiny configuration at the program's
downsample padding (0, 1), not the published (1, 1): at the published one
the program fails every comparison (``test_portbench_run.py``), and these
cases keep the Stable Diffusion check itself, its control and its faults,
tested until the program pads as published and its cells come back."""

import io
import json
import time

import numpy as np
import pytest
import torch

from portbench import check, harness, spec, traffic, weights
from portbench.faults import FAULTS
from portbench.programs import hed_preprocess, sd_inference
from portbench.reference import hed as hed_ref
from portbench.reference import stable_diffusion as sd_ref
from portbench.tests import helpers

torch.set_num_threads(2)

HED_LIMIT = json.loads((spec.HERE / "limits" / "hed_photo_1024x768.json")
                       .read_text())["map_max_abs"]["limit"]
SD_LIMIT = 0.05


def _hed():
    mix = {**helpers.tiny_hed_traffic(), "_name": "tiny_mix"}
    return (helpers.tiny_hed_config(), mix, hed_preprocess, hed_ref,
            check.map_max_abs, HED_LIMIT)


def _sd():
    cfg = helpers.tiny_config()
    cfg["unet"]["downsample_padding"] = 0
    mix = {**helpers.tiny_traffic(), "_name": "tiny_mix",
           "_vocab": traffic.load_mix("b4_spatial_768")["_vocab"]}
    return cfg, mix, sd_inference, sd_ref, check.image_rms_rel, SD_LIMIT


KINDS = {"hed": _hed, "sd": _sd}


def _bench(kind, tmp_path):
    if kind == "hed":
        return helpers.tiny_bench(tmp_path)
    return helpers.tiny_sd_bench(tmp_path, 0, SD_LIMIT)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 3, 4_000_000_007])
def test_the_control_fails_where_the_program_passes(kind, seed):
    cfg, mix, program_mod, ref, compare, limit = KINDS[kind]()
    req = traffic.request(mix, seed, 0)
    w, _ = weights.make(cfg, seed, "cpu")
    program = program_mod.Program(cfg, w, torch.device("cpu"),
                                  weights.dtype_of(cfg))
    got, _ = program.run(req)
    want = ref.generate(w, cfg, req, "fp32", "cpu")
    control = ref.generate(w, cfg, req, cfg["control"], "cpu")
    assert compare(got, want) < limit
    assert compare(control, want) > limit


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -1.0 - 2 ** -12, 3.0e-3], dtype=torch.float32)
    got = hed_ref.to_tf32(x)
    assert got.tolist()[:5] == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9,
                                -1.0]
    assert abs(float(got[5]) / 3.0e-3 - 1.0) <= 2 ** -11


@pytest.mark.parametrize("kind,fault", [
    (kind, fault) for kind, program in (("hed", "hed_preprocess"),
                                        ("sd", "sd_inference"))
    for fault in sorted(FAULTS[program])])
def test_a_broken_timed_path_is_not_correct(kind, fault, tmp_path):
    bench, bench_dir, root = _bench(kind, tmp_path)
    cell = spec.Cell(bench, helpers.TINY_CELL, bench_dir, root)
    program = cell.config["program"]
    out, err = io.StringIO(), io.StringIO()
    with FAULTS[program][fault]():
        rc = harness.run(cell, 2 ** 31 + 17, 0.5, False, "cpu",
                         time.perf_counter(), out, err)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0
    assert res["correct"] is False, err.getvalue()[-500:]
    name, limit = next(iter(cell.limits)), KINDS[kind]()[5]
    assert res["checks"][name]["value"] > limit


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_the_same_run_unbroken_is_correct(kind, tmp_path):
    bench, bench_dir, root = _bench(kind, tmp_path)
    cell = spec.Cell(bench, helpers.TINY_CELL, bench_dir, root)
    out = io.StringIO()
    harness.run(cell, 2 ** 31 + 17, 0.5, False, "cpu", time.perf_counter(),
                out, io.StringIO())
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True
    assert all(np.isfinite(c["value"]) for c in res["checks"].values())
