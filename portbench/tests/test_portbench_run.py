"""A whole run of a throwaway tiny cell on the CPU (the harness's look for a
card skipped): the result line and the checks printed last, the runs that
must end without a result, and a tiny Stable Diffusion cell, which reads
the program's downsample padding (CPU)."""

import io
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, spec
from portbench.tests import helpers

torch.set_num_threads(2)

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_tiny(tmp_path, traced=False, seed=2 ** 31 + 99, seconds=1.0,
             make=helpers.tiny_bench, **kw):
    bench, bench_dir, root = make(tmp_path, **kw)
    cell = spec.Cell(bench, helpers.TINY_CELL, bench_dir, root)
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(cell, seed, seconds, traced, "cpu", time.perf_counter(),
                     out, err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def test_result_line_holds_the_contract_keys_then_the_checks(tmp_path):
    rc, res, err = run_tiny(tmp_path)
    assert rc == 0
    assert list(res) == RESULT_KEYS + ["checks"]
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"}
        assert m["value"] > 0, name
    assert {"s_per_image", "latency_p90_s", "setup_s"} <= set(res["metrics"])
    checks = res["checks"]
    assert set(checks) == {"map_max_abs", "failed_requests",
                           "weights_remade_equal", "requests_checked"}
    assert all(set(c) == {"value", "limit"} for c in checks.values())
    last = err.strip().splitlines()[-len(checks):]
    assert [ln.split()[1] for ln in last] == list(checks)
    assert all(ln.startswith("check ") for ln in last)


def test_traced_run_reports_the_per_layer_metrics_it_can(tmp_path):
    rc, res, _ = run_tiny(tmp_path, traced=True)
    assert rc == 0 and res["correct"] is True
    assert list(res)[:5] == RESULT_KEYS and list(res)[-1] == "checks"
    assert "breakdown" in res
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    per_layer = {m["name"] for m in spec.load()["per_layer"]}
    assert set(res["metrics"]) <= per_layer
    # the CPU has no device trace: the readers that need one find nothing
    # to read and report nothing, never a 0
    for name in ("conv_roofline", "launches_per_image", "device_idle_pct"):
        assert name not in res["metrics"]
    assert set(res["metrics"]) == {"mfu_pct"}
    assert 0 < res["metrics"]["mfu_pct"]["value"] < 100


@pytest.mark.parametrize("padding,correct", [(1, False), (0, True)])
def test_an_sd_cell_is_correct_only_at_the_programs_padding(
        tmp_path, padding, correct):
    """The Stable Diffusion cells are out of BENCHMARK.json: the program
    pads its UNet's stride-2 downsample convs (0, 1), the published UNet
    (and the reference, as the configuration states it) (1, 1). At the
    published padding the images differ far past the limit; the reference
    at the program's padding agrees within it: the padding is the whole
    difference."""
    rc, res, err = run_tiny(tmp_path, seconds=0.5,
                            make=helpers.tiny_sd_bench,
                            downsample_padding=padding)
    assert rc == 0
    assert res["correct"] is correct, err[-500:]
    reading = res["checks"]["image_rms_rel"]["value"]
    assert (reading > 0.1) if padding == 1 else (reading < 0.05)


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "hed_photo_1024x768", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out.strip() == ""
    assert "needs 1 CUDA device" in out.err


def test_a_directory_of_the_benchmark_alone_ends_without_a_result(tmp_path):
    """With only BENCHMARK.json and the benchmark's files, the program
    cannot be imported: the run fails and prints no result."""
    helpers.tiny_bench(tmp_path)
    code = ("import sys, time; sys.path[0] = '.'\n"
            "from portbench import harness, spec\n"
            f"cell = spec.Cell(spec.load(spec.ROOT), '{helpers.TINY_CELL}', "
            "spec.HERE, spec.ROOT)\n"
            "sys.exit(harness.run(cell, 1, 1.0, False, 'cpu', "
            "time.perf_counter()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "diffusionspatialcontrol_tpu_torch" in p.stderr
    assert p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    """One short run of the first cell, as the benchmark is started."""
    root = spec.ROOT
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "hed_photo_1024x768",
         "--seed", str(2 ** 31 + 5), "--seconds", "5", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
