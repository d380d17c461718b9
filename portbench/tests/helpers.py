"""Tiny cells for the CPU tests: a copy of the benchmark's directory with a
throwaway configuration, traffic mix and limits added as new files."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from portbench import spec

TINY_CELL = "tiny_cell"


def tiny_config() -> dict:
    """sd15.json with every width cut (a test's configuration only)."""
    cfg = json.loads((spec.HERE / "configs" / "sd15.json").read_text())
    cfg["name"] = "tiny"
    cfg["text_encoder"].update({"hidden_size": 64, "intermediate_size": 128,
                                "num_hidden_layers": 3,
                                "num_attention_heads": 4})
    cfg["unet"].update({"block_out_channels": [32, 64, 128, 128],
                        "attention_head_dim": 2, "cross_attention_dim": 64,
                        "norm_num_groups": 8})
    cfg["vae"].update({"block_out_channels": [16, 32, 32, 32],
                       "norm_num_groups": 4})
    return cfg


def tiny_traffic(height=64, width=64, batch=2, region=True) -> dict:
    mix = json.loads((spec.HERE / "traffic" / "b4_spatial_768.json")
                     .read_text())
    mix.update({"height": height, "width": width,
                "num_images_per_prompt": batch, "region_map": region,
                "steps": 6, "check_requests": 1})
    return mix


def tiny_hed_config() -> dict:
    """hed.json with its widths cut (a test's configuration only)."""
    cfg = json.loads((spec.HERE / "configs" / "hed.json").read_text())
    cfg["name"] = "tiny"
    cfg["hed"]["widths"] = [8, 16, 16, 32, 32]
    return cfg


def tiny_hed_traffic(height=96, width=128) -> dict:
    mix = json.loads((spec.HERE / "traffic" / "photo_1024x768.json")
                     .read_text())
    mix.update({"height": height, "width": width, "pool": 3})
    return mix


def tiny_bench(tmp: Path, cfg=None, mix=None, limits=None):
    """(BENCHMARK dict, benchmark dir, root) of a checkout copy in ``tmp``
    whose BENCHMARK.json has one more cell, ``TINY_CELL``, made of new
    files alone: by default the HED configuration at tiny widths on small
    pictures, held to the HED cell's limits."""
    root = Path(tmp)
    bench_dir = root / "portbench"
    shutil.copytree(spec.HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench_dir / "configs" / "tiny.json").write_text(
        json.dumps(cfg or tiny_hed_config()))
    (bench_dir / "traffic" / "tiny_mix.json").write_text(
        json.dumps(mix or tiny_hed_traffic()))
    if limits is None:
        limits = json.loads((spec.HERE / "limits" / "hed_photo_1024x768.json")
                            .read_text())
    (bench_dir / "limits" / f"{TINY_CELL}.json").write_text(
        json.dumps(limits))
    bench = copy.deepcopy(spec.load())
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": TINY_CELL, "config": "tiny",
                               "traffic": "tiny_mix", "chips": 1,
                               "why": "CPU tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench, bench_dir, root


def tiny_sd_bench(tmp: Path, downsample_padding: int, limit: float = 0.05):
    """``tiny_bench`` with a tiny Stable Diffusion cell (two 64 x 64 images
    a request, six steps, a region map), its UNet padded as given."""
    cfg = tiny_config()
    cfg["unet"]["downsample_padding"] = downsample_padding
    return tiny_bench(tmp, cfg, tiny_traffic(),
                      {"image_rms_rel": {"limit": limit}})
