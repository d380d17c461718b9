"""The port's JSON HTTP server on the CPU, and its payload parsing against
the JAX package's.

The server runs ``serve(manager, port=0, block=False)`` with the tiny model
on the CPU: identical POSTs return identical PNGs, equal to the native
codec's encoding of a direct ``inference()`` call; the job queue reports
progress, runs to done and cancels a queued job; ``/warmup`` returns one
record per config; ControlNet, T2I-Adapter and IP-Adapter units run;
errors answer 400 (a caller's mistake), 404 or 500, never 200 (501, for a
path not ported yet, answers none of these requests any more); a server
started with ``--model`` and ``--zoo`` serves a checkpoint directory.
``_inference_kwargs`` of both packages turn the same JSON payloads into
equal keyword arguments (no JAX program runs).
"""

import base64
import dataclasses
import io
import json
import os
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu.app import api as japi
from diffusionspatialcontrol_tpu.app import server as jserver
from diffusionspatialcontrol_tpu_torch import tiny_config
from diffusionspatialcontrol_tpu_torch.app import api as tapi
from diffusionspatialcontrol_tpu_torch.app import server as tserver
from diffusionspatialcontrol_tpu_torch.runtime import native

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

BASE = {"prompt": "a red cat sitting on a wooden bench", "model": "tiny",
        "steps": 3, "width": 64, "height": 64, "seed": 7,
        "sampler": "Euler a", "encoding_mode": "short"}


def _state_json():
    m = np.zeros((64, 64), int)
    m[:, :32] = 1
    return {"red cat": {"mask": m.tolist(), "weight": 0.8,
                        "mask_outsides": 0.2}}


@pytest.fixture(scope="module")
def server():
    m = tapi.ModelManager(dtype=torch.float32, device="cpu")
    m.register_random("tiny", tiny_config(), seed=0)
    srv = tserver.serve(m, port=0, block=False)
    yield srv, m
    srv.shutdown()
    srv.server_close()


def _call(srv, path, payload=None, raw=None):
    port = srv.server_address[1]
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as f:
            return f.status, json.loads(f.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_generate_is_deterministic_and_equals_inference(server):
    srv, m = server
    payload = {**BASE, "region_state": _state_json()}
    s1, a = _call(srv, "/generate", payload)
    s2, b = _call(srv, "/generate", payload)
    assert (s1, s2) == (200, 200)
    assert a["images"] == b["images"] and len(a["images"]) == 1
    direct = tapi.inference(m, **tserver._inference_kwargs(payload))
    assert base64.b64decode(a["images"][0]) == \
        native.encode_png(direct["images"][0])
    timings = json.loads(a["timings"])
    assert timings["model"] == "tiny" and timings["steps"] == 3
    assert "sample_s" in timings and "hbm_in_use_mb" not in timings


def test_generate_grid_and_previews(server):
    srv, m = server
    grid = {**BASE, "prompt": ["a red cat", "a dog"], "seed": [1, 2]}
    status, out = _call(srv, "/generate", grid)
    assert status == 200 and len(out["images"]) == 4
    direct = tapi.inference(m, **tserver._inference_kwargs(grid))
    assert [base64.b64decode(s) for s in out["images"]] == \
        [native.encode_png(im) for im in direct["images"]]
    status, out = _call(srv, "/generate", {**BASE, "latent_preview": True})
    assert status == 200 and len(out["previews"]) == 3  # one a step
    assert all(len(p) == 1 for p in out["previews"])


def test_jobs_progress_done_and_cancel_while_queued(server):
    srv, _ = server
    lock = srv.RequestHandlerClass.lock
    with lock:  # hold the device: both jobs wait
        s1, j1 = _call(srv, "/jobs", {**BASE, "steps": 4,
                                      "cancel_check_steps": 2})
        s2, j2 = _call(srv, "/jobs", BASE)
        assert (s1, s2) == (202, 202)
        status, c = _call(srv, f"/jobs/{j2['job_id']}/cancel", {})
        assert status == 200 and c["status"] == "cancelled"
        status, listing = _call(srv, "/jobs")
        ids = [j["job_id"] for j in listing["jobs"]]
        assert j1["job_id"] in ids and j2["job_id"] in ids
    seen = []
    for _ in range(600):
        status, r = _call(srv, f"/jobs/{j1['job_id']}")
        seen.append(r["progress"]["done"])
        if r["status"] == "done":
            break
        import time

        time.sleep(0.02)
    assert r["status"] == "done", r
    assert r["progress"] == {"done": 4, "total": 4}
    assert len(r["images"]) == 1 and "timings" in r
    assert seen == sorted(seen)
    _, r2 = _call(srv, f"/jobs/{j2['job_id']}")
    assert r2["status"] == "cancelled"
    assert _call(srv, "/jobs/job-999")[0] == 404
    assert _call(srv, "/jobs/job-999/cancel", {})[0] == 404


def test_a_failed_job_reports_its_error(server):
    srv, _ = server
    _, job = _call(srv, "/jobs", {**BASE, "sampler": "Euler b"})
    for _ in range(600):
        _, r = _call(srv, f"/jobs/{job['job_id']}")
        if r["status"] in ("done", "error"):
            break
    assert r["status"] == "error" and "unknown sampler" in r["error"]
    assert _call(srv, "/jobs", {"model": "tiny"})[0] == 400  # no prompt


def test_warmup_returns_one_record_per_config(server):
    srv, _ = server
    configs = [{k: v for k, v in BASE.items() if k != "prompt"},
               {**BASE, "region_state": _state_json(), "steps": 2}]
    status, out = _call(srv, "/warmup", {"configs": configs})
    assert status == 200 and len(out["results"]) == 2
    assert out["results"][1]["config"]["steps"] == 2
    assert _call(srv, "/warmup", {"model": "nope"})[0] == 400


@pytest.mark.parametrize("case", [
    ("unknown model", {**BASE, "model": "nope"}, 400,
     "KeyError: \"model 'nope' not registered\""),
    ("unknown sampler", {**BASE, "sampler": "Euler b"}, 400,
     "available: ['DDPM', 'DDPM Exponential'"),
    ("missing prompt", {"model": "tiny"}, 400, "KeyError: 'prompt'"),
    ("bad combination", {**BASE, "latent_preview": "all"}, 400,
     "latent_preview must be bool"),
    ("controlnet unit", {**BASE, "controlnet_units": [
        {"model": "Canny", "image": np.zeros((8, 8, 3)).tolist(),
         "preprocessor": "Cany"}]}, 400, "unknown preprocessor 'Cany'"),
    ("ip-adapter unit", {**BASE, "ip_adapter_units": [
        {"model": os.path.abspath(__file__), "image_embeds": [0.0] * 8}]},
     500, "UnpicklingError"),
    # a speed mode runs (test_generate_speed_modes_equal_inference); with a
    # solver it does not take it is a caller's mistake
    ("speed mode", {**BASE, "deepcache_interval": 3}, 400,
     "deepcache supports ['dpmpp_2m', 'euler'], not 'euler_ancestral'"),
], ids=lambda c: c[0])
def test_generate_errors(server, case):
    srv, _ = server
    _, payload, code, text = case
    status, out = _call(srv, "/generate", payload)
    assert status == code and text in out["error"], out



@pytest.mark.parametrize("mode", [
    {"cfg_tail_frac": 0.5}, {"deepcache_interval": 2},
    {"bottleneck_low_scale": 0.5, "width": 128, "height": 128},
    {"tgate_gate_frac": 0.5}], ids=lambda m: next(iter(m)))
def test_generate_speed_modes_equal_inference(server, mode):
    """A speed-mode POST answers 200 with the PNG of a direct
    ``inference()`` call, another image than the plain request's."""
    srv, m = server
    payload = {**BASE, "sampler": "Euler", "steps": 4,
               "region_state": _state_json(), **mode}
    if "width" in mode:
        payload["region_state"] = {"red cat": {
            "mask": np.kron(np.asarray(_state_json()["red cat"]["mask"]),
                            np.ones((2, 2), int)).tolist(),
            "weight": 0.8, "mask_outsides": 0.2}}
    status, out = _call(srv, "/generate", payload)
    assert status == 200, out
    direct = tapi.inference(m, **tserver._inference_kwargs(payload))
    assert base64.b64decode(out["images"][0]) == \
        native.encode_png(direct["images"][0])
    plain = {k: v for k, v in payload.items() if k not in mode
             or k in ("width", "height")}
    assert _call(srv, "/generate", plain)[1]["images"] != out["images"]

def test_generate_with_units_equals_inference(server):
    """ControlNet and T2I-Adapter units over HTTP (the unit images as nested
    lists, uint8, smaller than the request) give the PNG of a direct
    ``inference()`` call; a ControlNet with zero heads gives the PNG of the
    request without it."""
    srv, m = server
    img = (np.arange(48 * 48 * 3).reshape(48, 48, 3) % 251).astype(np.uint8)
    cn = {**BASE, "controlnet_units": [{"model": "Canny",
                                        "image": img.tolist()}]}
    both = {**cn, "t2i_units": [{"model": "Sketch", "image": img.tolist(),
                                 "scale": 0.8}]}
    plain = _call(srv, "/generate", BASE)[1]["images"]
    for payload in (cn, both):
        status, out = _call(srv, "/generate", payload)
        assert status == 200, out
        direct = tapi.inference(m, **tserver._inference_kwargs(payload))
        assert base64.b64decode(out["images"][0]) == \
            native.encode_png(direct["images"][0])
    assert _call(srv, "/generate", cn)[1]["images"] == plain
    assert _call(srv, "/generate", both)[1]["images"] != plain


def test_generate_with_ip_unit_equals_inference(server):
    """An IP-Adapter unit over HTTP (the reference image and the mask as
    nested lists) gives the PNG of a direct ``inference()`` call; at scale
    0 it gives the PNG of the request without it (``out + 0 * ip_out`` is
    exact)."""
    from diffusionspatialcontrol_tpu_torch.models.clip_vision import (
        CLIPVisionConfig,
    )

    srv, m = server
    m.register_image_encoder(cfg=CLIPVisionConfig(
        image_size=28, patch_size=14, hidden_size=32, intermediate_size=64,
        num_layers=2, num_heads=2, projection_dim=16))
    img = (np.arange(40 * 40 * 3).reshape(40, 40, 3) % 253).astype(np.uint8)
    mask = np.zeros((64, 64), int)
    mask[:, 32:] = 1
    unit = {"model": "IP-Adapter Plus", "image": img.tolist(),
            "mask": mask.tolist(), "scale": 0.8}
    payload = {**BASE, "region_state": _state_json(),
               "ip_adapter_units": [unit]}
    status, out = _call(srv, "/generate", payload)
    assert status == 200, out
    direct = tapi.inference(m, **tserver._inference_kwargs(payload))
    assert base64.b64decode(out["images"][0]) == \
        native.encode_png(direct["images"][0])
    plain = _call(srv, "/generate", {**BASE, "region_state":
                                     _state_json()})[1]["images"]
    assert out["images"] != plain
    zero = {**payload, "ip_adapter_units": [{**unit, "scale": 0.0}]}
    assert _call(srv, "/generate", zero)[1]["images"] == plain


def test_other_endpoints(server):
    srv, _ = server
    assert _call(srv, "/generate", raw=b"{not json")[0] == 400
    assert _call(srv, "/health") == (200, {"ok": True})
    assert _call(srv, "/models") == (200, {"models": ["tiny"]})
    status, out = _call(srv, "/samplers")
    assert status == 200 and len(out["samplers"]) == 82
    assert "DPM++ 2M Karras" in out["samplers"]
    status, out = _call(srv, "/preprocessors")
    assert status == 200 and "Canny" in out["pure_image"]
    status, out = _call(srv, "/preprocess", {})
    assert status == 400 and out["error"] == "KeyError: 'image'"
    assert _call(srv, "/nowhere")[0] == 404
    assert _call(srv, "/nowhere", {})[0] == 404


# -- payload parsing ---------------------------------------------------------

def _png_b64(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.asarray(arr, np.uint8)).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _payloads():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)
    gray = np.full((16, 16), 255, np.uint8)
    gray[4:10, 2:12] = 30
    mask255 = np.zeros((16, 16), int)
    mask255[:, 8:] = 255
    state = {"red cat": {"mask": _png_b64(gray), "weight": 0.5},
             "bird": {"mask": (gray < 255).astype(int).tolist()}}
    return [
        ("lists", {**BASE, "region_state": _state_json(),
                   "init_image": rgb.tolist(), "inpaint_mask": (
                       mask255 // 255).tolist(), "invert_mask": True,
                   "hires_scale": 2, "hires_region": False}),
        ("base64", {**BASE, "init_image": _png_b64(rgb),
                    "inpaint_mask": _png_b64(mask255),
                    "region_state": state}),
        ("inpaint 0..255 lists", {**BASE, "inpaint_mask": mask255.tolist(),
                                  "init_image": rgb.astype(float).tolist()}),
        ("rgb mask", {**BASE, "inpaint_mask": np.stack(
            [mask255] * 3, -1).tolist(), "init_image": _png_b64(rgb)}),
        ("grid per-prompt lists", {**BASE, "prompt": ["a", "b"],
                                   "init_image": [rgb.tolist(),
                                                  (255 - rgb).tolist()],
                                   "region_state": [state, None]}),
        ("grid per-prompt base64", {**BASE, "prompt": ["a", "b"],
                                    "init_image": [_png_b64(rgb),
                                                   _png_b64(255 - rgb)]}),
        ("units and variants", {
            **BASE, "loras": ["a.safetensors", ["b.safetensors", 0.5]],
            "ti_embeddings": ["emb.pt"],
            "controlnet_units": [{"model": "Canny", "image": _png_b64(rgb),
                                  "scale": 0.5, "guidance_end": 0.8,
                                  "preprocessor": "Canny",
                                  "preprocessor_options": {"low": 10}}],
            "t2i_units": [{"model": "Color", "image": (rgb / 255).tolist(),
                           "conditioning_factor": 0.5}],
            "ip_adapter_units": [{"model": "IP-Adapter Plus",
                                  "image": _png_b64(rgb),
                                  "mask": _png_b64(gray),
                                  "invert_mask": True, "scale": 0.7}]}),
        ("every scalar", {**BASE, "neg_prompt": "n", "cfg_scale": 1.0,
                          "num_images_per_prompt": 2, "clip_skip": 1,
                          "guidance_rescale": 0.3, "strength": 0.4,
                          "hires_strength": 0.5, "hires_mode":
                          "Latent (nearest)", "hires_steps": 2,
                          "hires_sampler": "Heun", "eta": 0.2,
                          "cancel_check_steps": 2, "timeout": 30,
                          "latent_preview": "base", "cfg_tail_frac": 0.1,
                          "deepcache_interval": 2,
                          "bottleneck_low_scale": 0.5,
                          "tgate_gate_frac": 0.5, "unknown_key": 1}),
    ]


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
        assert list(fa) == list(fb)
        for k in fa:
            _same(getattr(a, k), getattr(b, k))
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("case", _payloads(), ids=lambda c: c[0])
def test_inference_kwargs_equal_jax(case):
    _, payload = case
    _same(tserver._inference_kwargs(json.loads(json.dumps(payload))),
          jserver._inference_kwargs(json.loads(json.dumps(payload))))


def test_result_payload_and_warmup_configs_equal_jax():
    rng = np.random.default_rng(1)
    result = {"images": rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8),
              "timings": "{}",
              "previews": [rng.integers(0, 256, (1, 8, 8, 3),
                                        dtype=np.uint8)]}
    assert tserver._result_payload(result) == jserver._result_payload(result)
    got = tapi.default_warmup_configs("m", steps=5, sampler="Euler")
    want = japi.default_warmup_configs("m", steps=5, sampler="Euler")
    _same(got, want)


def test_cli_builds_a_cpu_manager_and_refuses_unported_flags(monkeypatch):
    """The CLI builds a CPU manager; ``--preprocessor`` registers weights
    and ``--gradio`` without ``gradio`` raises the JAX package's
    ImportError (no flag is unported any more)."""
    args = tserver.parse_args(["--random-model", "t:tiny:3", "--device",
                               "cpu", "--dtype", "f32"])
    m = tserver.build_manager_from_args(args)
    assert list(m._dirs) == ["t"] and m.device == torch.device("cpu")
    assert m.dtype == torch.float32
    assert m._dirs["t"][1].name == "tiny"
    defaults = tserver.parse_args([])
    assert defaults.device == "cuda" and defaults.port == 7860
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserver.build_manager_from_args(tserver.parse_args(
                ["--random-model", "t:tiny"]))
    # checkpoints and weight files register (they load at first use);
    # a bad --model or an empty --zoo stops the CLI with the JAX messages
    m = tserver.build_manager_from_args(tserver.parse_args([
        "--model", "sd15=/models/sd15", "--image-encoder", "clip.safetensors",
        "--face-embedder", "arcface.pth", "--device", "cpu"]))
    assert m._dirs["sd15"][0] == "/models/sd15"
    assert m._dirs["sd15"][1].name == "sd15" and m.dtype == torch.bfloat16
    assert m._image_encoder_path == "clip.safetensors"
    assert m._face_path == "arcface.pth"
    for flags, text in ((["--model", "nodir"], "expects NAME=DIR"),
                        (["--zoo", "/models"], "no zoo checkpoints")):
        with pytest.raises(SystemExit, match=text):
            tserver.build_manager_from_args(tserver.parse_args(
                ["--random-model", "t:tiny", "--device", "cpu", *flags]))
    m = tserver.build_manager_from_args(tserver.parse_args(
        ["--random-model", "t:tiny", "--device", "cpu",
         "--preprocessor", "Depth=dpt.safetensors"]))
    assert m._preproc_spec == {"Depth": ("dpt.safetensors", None, 368)}
    with pytest.raises(SystemExit, match="expects NAME=WEIGHTS"):
        tserver.build_manager_from_args(tserver.parse_args(
            ["--random-model", "t:tiny", "--device", "cpu",
             "--preprocessor", "Depth"]))
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio is not installed; use "
                       "app.server.serve"):
        tserver.main(["--gradio", "--random-model", "t:tiny",
                      "--device", "cpu"])
    for bad in (["--random-model", "t:sdxl", "--device", "cpu"],
                ["--device", "cpu"]):
        with pytest.raises(SystemExit):
            tserver.build_manager_from_args(tserver.parse_args(bad))


def test_server_serves_a_checkpoint_directory(tmp_path):
    """``--model NAME=DIR`` and ``--zoo ROOT`` register a tiny diffusers
    directory (the SD1.5 preset the flags register is swapped for the tiny
    one before the first request); its POST equals a direct ``inference()``
    and both equal the image of the tree the directory was written from."""
    from tests.test_torch_convert import randomized, write_checkpoint

    from diffusionspatialcontrol_tpu_torch.models import factory

    tree = randomized(factory.init_pipeline_params(
        0, tiny_config(), torch.float32, device="cpu"), 12)
    ckpt = write_checkpoint(tmp_path / "ckpt", tree, "fp32")
    (tmp_path / "zoo").mkdir()
    os.symlink(ckpt, tmp_path / "zoo" / "stable-diffusion-v1-5")
    m = tserver.build_manager_from_args(tserver.parse_args(
        ["--model", f"disk={ckpt}", "--zoo", str(tmp_path / "zoo"),
         "--device", "cpu", "--dtype", "f32"]))
    names = japi.ModelManager().register_zoo(str(tmp_path / "zoo"))
    assert len(names) == 1 and sorted(m._dirs) == sorted(["disk"] + names)
    for name, (path, _) in list(m._dirs.items()):
        m._dirs[name] = (path, tiny_config())
    ref = tapi.ModelManager(dtype=torch.float32, device="cpu")
    ref.register_random("ref", tiny_config())
    ref._cache["ref"] = tree
    srv = tserver.serve(m, port=0, block=False)
    try:
        assert sorted(_call(srv, "/models")[1]["models"]) == sorted(m._dirs)
        payload = {**BASE, "model": "disk", "region_state": _state_json()}
        status, out = _call(srv, "/generate", payload)
        assert status == 200
        want = tapi.inference(ref, **tserver._inference_kwargs(
            {**payload, "model": "ref"}))["images"][0]
        assert base64.b64decode(out["images"][0]) == native.encode_png(want)
        assert _call(srv, "/generate", {**payload, "model": names[0]})[0] \
            == 200
    finally:
        srv.shutdown()
        srv.server_close()
