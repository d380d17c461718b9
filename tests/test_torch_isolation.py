"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points run on the card unless the caller names a device.

The import checks run in a subprocess, because this test process has JAX
loaded already (tests/conftest.py).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from diffusionspatialcontrol_tpu_torch import resolve_device, tiny_config
from diffusionspatialcontrol_tpu_torch.convert.from_jax import params_from_jax
from diffusionspatialcontrol_tpu_torch.models.factory import (
    init_pipeline_params,
)
from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
    StableDiffusionTorch,
)

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "diffusionspatialcontrol_tpu_torch"
# the app layer's modules, each with its own copy of what it needs from the
# JAX package's JAX-free modules (registry, region_ui, native,
# preprocess.resize_nearest)
APP_LAYER = tuple(f"diffusionspatialcontrol_tpu_torch.{m}" for m in (
    "registry", "utils.profiling", "runtime.native", "app.api",
    "parallel.batched", "utils.region_ui", "app.server"))
# data parallelism: the mesh and the explicit-SPMD sampler
PARALLEL = tuple(f"diffusionspatialcontrol_tpu_torch.parallel.{m}"
                 for m in ("mesh", "spmd"))
# the ControlNet and T2I-Adapter models
UNITS = tuple(f"diffusionspatialcontrol_tpu_torch.models.{m}"
              for m in ("controlnet", "t2i_adapter"))
# IP-Adapter, its image tower and the FaceID face models, each with its own
# copy of what it needs from the JAX package's numpy-only modules
IP_ADAPTER = tuple(f"diffusionspatialcontrol_tpu_torch.{m}" for m in (
    "models.ip_adapter", "models.clip_vision", "models.arcface",
    "models.face_detect", "ops.face_embed"))
# weights from disk: the port's own safetensors reader and writer is its
# only way to the format (the card's machine has no safetensors package)
CONVERT = tuple(f"diffusionspatialcontrol_tpu_torch.convert.{m}" for m in (
    "safetensors", "hf", "lora", "textual_inversion", "cache"))
# DAAM heatmaps (the speed modes live in modules the probe already loads)
INTROSPECT = ("diffusionspatialcontrol_tpu_torch.introspect",
              "diffusionspatialcontrol_tpu_torch.introspect.daam")
# the control preprocessors, their networks and the Gradio UI (which imports
# gradio only when it builds the UI)
PREPROCESS = tuple(f"diffusionspatialcontrol_tpu_torch.{m}" for m in (
    "ops.preprocess", "ops.cv", "models._nets", "models.hed",
    "models.pidinet", "models.lineart", "models.lineart_anime",
    "models.mlsd", "models.dpt", "models.openpose", "models.upernet",
    "models.normalbae", "models.zoedepth", "app.gradio_ui"))
# the two demos, run as modules
EXAMPLES = tuple(f"diffusionspatialcontrol_tpu_torch.examples.{m}" for m in (
    "spatial_control_demo", "controlnet_hires_demo"))
# what the card's machine does not have: none of it at import time
ABSENT_ON_THE_CARD = ("cv2", "PIL", "transformers", "gradio")

_PROBE = """
import importlib, json, pkgutil, sys
import diffusionspatialcontrol_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names, "loaded": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "diffusionspatialcontrol_tpu",
                           "safetensors")), "absent": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("cv2", "PIL", "transformers", "gradio"))}))
"""


@pytest.fixture(scope="module")
def probe():
    """Every port module imported in a fresh interpreter: their names and
    the modules of the packages that must stay out."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_importing_every_port_module_loads_no_jax(probe):
    result = probe
    assert len(result["modules"]) >= 20
    assert set(APP_LAYER + PARALLEL + UNITS + IP_ADAPTER + CONVERT
               + INTROSPECT + PREPROCESS + EXAMPLES) <= set(result["modules"])
    assert result["loaded"] == []


def test_importing_every_port_module_loads_no_cv2_pil_transformers_gradio(
        probe):
    """The card's machine has none of them; the Gradio UI and base64 image
    inputs import theirs at first use."""
    assert probe["absent"] == []


# A rank started with the spawn method (as chip_smoke.py starts its ranks)
# on a one-rank gloo mesh: the modules of JAX and of the JAX package it has
# loaded after an all-reduce.
_RANK_PROBE = """
import json, multiprocessing, sys


def rank(queue, path):
    import torch
    from diffusionspatialcontrol_tpu_torch.app import api, server  # noqa
    from diffusionspatialcontrol_tpu_torch.parallel import batched, mesh, spmd

    m = mesh.init_data_parallel(device="cpu", init_method=f"file://{path}",
                                rank=0, world_size=1)
    m.all_reduce(torch.ones(3))
    torch.distributed.destroy_process_group()
    queue.put(sorted(k for k in sys.modules if k.split(".")[0] in (
        "jax", "jaxlib", "diffusionspatialcontrol_tpu")))


if __name__ == "__main__":
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=rank, args=(queue, sys.argv[1]))
    proc.start()
    print(json.dumps(queue.get(timeout=100)))
    proc.join(timeout=30)
"""


def test_a_spawned_rank_loads_no_jax(tmp_path):
    script = tmp_path / "rank_probe.py"
    script.write_text(_RANK_PROBE)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, str(script), str(tmp_path / "s")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(
    [ROOT / "chip_smoke.py", *PACKAGE.rglob("*.py")], key=str),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "diffusionspatialcontrol_tpu"}, roots


@pytest.mark.parametrize("path", sorted(
    [ROOT / "chip_smoke.py", *PACKAGE.rglob("*.py")], key=str),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_does_not_import_the_safetensors_package(path):
    assert "safetensors" not in _imported_roots(path)


def _module_level_roots(path: Path):
    """The top-level packages a module imports when it is imported: its
    module-level statements (and the bodies of module-level ``try``/``if``),
    not its functions'."""
    roots = set()
    todo = list(ast.parse(path.read_text(), str(path)).body)
    while todo:
        node = todo.pop()
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, (ast.Try, ast.If)):
            todo += node.body + node.orelse + getattr(node, "finalbody", [])
            todo += [s for h in getattr(node, "handlers", []) for s in h.body]
    return roots


@pytest.mark.parametrize("path", sorted(
    [ROOT / "chip_smoke.py", *PACKAGE.rglob("*.py")], key=str),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_package_the_card_lacks_at_import_time(path):
    """cv2 and transformers nowhere; PIL and gradio only inside the
    functions that need them."""
    assert not _module_level_roots(path) & set(ABSENT_ON_THE_CARD)
    assert not _imported_roots(path) & {"cv2", "transformers"}


def test_chip_smoke_without_a_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tiny_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_pipeline_params(0, cfg, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        StableDiffusionTorch(cfg, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"kernel": [[0.0]]})
    assert resolve_device("cpu") == torch.device("cpu")


def test_app_entry_points_default_to_cuda_and_raise_without_it():
    from diffusionspatialcontrol_tpu_torch.app import api, server

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.ModelManager()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    args = server.parse_args(["--random-model", "m:tiny"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server.build_manager_from_args(args)
    assert api.ModelManager(device="cpu").device == torch.device("cpu")


def test_ip_adapter_entry_points_default_to_cuda_and_raise_without_it():
    from diffusionspatialcontrol_tpu_torch.models import ip_adapter

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tiny_config().unet
    sd = ip_adapter.random_state_dict(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ip_adapter.load_ip_adapter({}, cfg, [sd])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ip_adapter.convert_image_proj(sd["image_proj"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ip_adapter.install_ip_adapter_weights({}, cfg, [sd["ip_adapter"]])


def test_convert_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    from diffusionspatialcontrol_tpu_torch.convert import cache, hf

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tiny_config()
    sd = hf.StateDict({})
    for call in (lambda: hf.load_pipeline_params(str(tmp_path), cfg),
                 lambda: hf.convert_unet(sd, cfg.unet),
                 lambda: hf.convert_clip(sd, cfg.clip),
                 lambda: cache.load_params(str(tmp_path / "x"))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
