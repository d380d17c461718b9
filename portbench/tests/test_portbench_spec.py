"""BENCHMARK.json against the benchmark's contract, and every cell resolved
to its files by name (CPU, no card)."""

import json
import re

import pytest
import torch

from portbench import check, spec
from portbench.tests import helpers

torch.set_num_threads(2)

BENCH = spec.load()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells (2 + 14 runs a cell, each with 60 s and
    # each cell 180 s more to compile, 1200 s spare) fits 43200 s
    n = 24
    assert ((2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90
            + 1200) <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("group", sorted(ENTRY_KEYS))
def test_entries_have_just_the_contract_keys(group):
    for e in BENCH[group]:
        extra = set(e) - ENTRY_KEYS[group] - {"workloads"}
        assert not extra, (group, e["name"], extra)
        assert ENTRY_KEYS[group] <= set(e), (group, e["name"])
        if "workloads" in e:
            assert group in ("end_to_end", "per_layer")


def test_names_units_and_texts():
    assert spec.problems(BENCH) == []
    for group in ENTRY_KEYS:
        for e in BENCH[group]:
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end":
                    assert TEXT.match(e[key]), (group, e["name"], key)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        if m["name"] != "setup_s":
            assert m["bound"] >= 0.01
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_every_cell_reports_what_the_contract_asks():
    names = {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in names
    four_chip = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four_chip <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        cell = spec.Cell(BENCH, w["name"], spec.HERE, spec.ROOT)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
    # a share of a roofline or of a peak is named as the contract says
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_resolves_to_its_files(workload):
    cell = spec.Cell(BENCH, workload, spec.HERE, spec.ROOT)
    cfg = cell.config
    assert cfg["name"] == cell.entry["config"]
    assert callable(cell.module("reference", cfg["reference"]).generate)
    assert hasattr(cell.module("programs", cfg["program"]), "Program")
    mix = cell.traffic()
    assert mix.get("kind", "txt2img") in ("txt2img", "image")
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m))
    for name, lim in cell.limits.items():
        assert callable(getattr(check, name))
        assert lim["lower"] < lim["limit"] < lim["upper"]
    assert cell.peaks["flops_per_s"][cfg["dtype"]] in (989e12, 67e12)
    assert cfg["control"] in ("fp8", "tf32")


def test_config_files_state_their_source_and_cuts():
    for c in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert "assumed" in cfg


def test_the_stable_diffusion_configs_state_the_published_model():
    """sd15.json and sd21v.json wait in the tree for their cells (out of
    BENCHMARK.json while the program pads its downsample convs (0, 1)):
    each states the published checkpoint's padding and no cut."""
    for name in ("sd15", "sd21v"):
        cfg = json.loads((spec.HERE / "configs" / f"{name}.json")
                         .read_text())
        assert cfg["reduced"] == []
        assert cfg["unet"]["downsample_padding"] == 1
        assert "changed" not in cfg


def test_a_throwaway_cell_from_new_files_alone_resolves(tmp_path):
    bench, bench_dir, root = helpers.tiny_bench(tmp_path)
    assert spec.problems(bench, bench_dir, root) == []
    cell = spec.Cell(bench, helpers.TINY_CELL, bench_dir, root)
    assert cell.config["name"] == "tiny"
    assert cell.traffic()["height"] == 96
    assert [m["name"] for m in cell.end_to_end] == [
        m["name"] for m in BENCH["end_to_end"]]
    # and a broken entry is named
    bench["workloads"][-1]["traffic"] = "no_such_mix"
    assert any("no_such_mix" in p
               for p in spec.problems(bench, bench_dir, root))
