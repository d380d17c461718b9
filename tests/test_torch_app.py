"""The port's app layer against the JAX package's, on the CPU.

* ``registry.py``, ``utils/region_ui.py`` and the native codec binding equal
  the JAX package's, item by item and byte for byte;
* routing parity: ``inference()`` of both packages, with the pipeline class
  replaced by a recorder in each (so no JAX program is compiled), makes the
  same pipeline calls with the same arguments in the same order on a table
  of requests, or raises the same exception with the same message;
* port-only invariants on the tiny model: ``inference`` is ``txt2img`` plus
  ``to_uint8`` bit for bit, a grid sample draws its single request's noise
  and matches its image, the watchdog and a raising ``progress_cb`` stop a
  run, an IP-Adapter request leaves the manager's UNet as it was, and what
  is not ported yet raises naming its ROADMAP item.
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu import registry as jregistry
from diffusionspatialcontrol_tpu.app import api as japi
from diffusionspatialcontrol_tpu.models import clip_vision as jclip_vision
from diffusionspatialcontrol_tpu.models import ip_adapter as jipa
from diffusionspatialcontrol_tpu.ops import face_embed as jface_embed
from diffusionspatialcontrol_tpu.runtime import native as jnative
from diffusionspatialcontrol_tpu.utils import profiling as jprofiling
from diffusionspatialcontrol_tpu.utils import region_ui as jregion_ui
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch import registry as tregistry
from diffusionspatialcontrol_tpu_torch.app import api as tapi
from diffusionspatialcontrol_tpu_torch.models import arcface as tarcface
from diffusionspatialcontrol_tpu_torch.models import clip_vision as tclip_vision
from diffusionspatialcontrol_tpu_torch.models import factory as tfactory
from diffusionspatialcontrol_tpu_torch.models import face_detect as tface_detect
from diffusionspatialcontrol_tpu_torch.ops import face_embed as tface_embed
from diffusionspatialcontrol_tpu_torch.parallel import mesh as tmesh
from diffusionspatialcontrol_tpu_torch.parallel.batched import generate_grid
from diffusionspatialcontrol_tpu_torch.pipeline import pipeline as tpipeline
from diffusionspatialcontrol_tpu_torch.runtime import native as tnative
from diffusionspatialcontrol_tpu_torch.utils import profiling as tprofiling
from diffusionspatialcontrol_tpu_torch.utils import region_ui as tregion_ui

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

PROMPT = "a red cat sitting on a wooden bench, a blue bird flying"


def _state(side):
    m1 = np.zeros((side, side), np.float32)
    m1[:, : side // 2] = 1.0
    m2 = np.zeros((side, side), np.float32)
    m2[: side // 3, side // 2:] = 1.0
    return {"red cat": {"mask": m1, "weight": 0.8, "mask_outsides": 0.2},
            "blue bird": {"mask": m2, "weight": 0.7, "mask_outsides": 0.1}}


# -- tables ----------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "IP_ADAPTER_MODELS", "CONTROLNET_MODELS", "T2I_ADAPTER_MODELS",
    "MODEL_ZOO", "SD2_MODELS", "INFERENCE_TIMEOUT_S", "DEFAULT_SAMPLER",
    "ENCODING_MODES"])
def test_registry_tables_equal_jax(name):
    got, want = getattr(tregistry, name), getattr(jregistry, name)
    if name == "INFERENCE_TIMEOUT_S":
        # tests/conftest.py raises the JAX package's for its slow tests;
        # compare with the value in its source
        import ast
        import inspect

        tree = ast.parse(inspect.getsource(jregistry))
        want = next(ast.literal_eval(n.value) for n in tree.body
                    if isinstance(n, ast.Assign)
                    and n.targets[0].id == name)
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got.items()) == list(want.items())
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g == w
    else:
        assert got == want
    if name == "MODEL_ZOO":
        assert len(got) == 52


def test_resolve_sampler_equals_jax():
    for name in jregistry.SAMPLERS:
        assert dataclasses.asdict(tregistry.resolve_sampler(name)) == \
            dataclasses.asdict(jregistry.resolve_sampler(name))
    with pytest.raises(KeyError) as t:
        tregistry.resolve_sampler("Euler b")
    with pytest.raises(KeyError) as j:
        jregistry.resolve_sampler("Euler b")
    assert str(t.value) == str(j.value)


def test_model_families_equal_jax():
    assert list(tcfg.MODEL_FAMILIES) == list(jcfg.MODEL_FAMILIES)
    for name, fn in tcfg.MODEL_FAMILIES.items():
        got, want = fn(), jcfg.MODEL_FAMILIES[name]()
        for part in ("clip", "unet", "vae"):
            assert dataclasses.asdict(getattr(got, part)) == \
                dataclasses.asdict(getattr(want, part))
        assert (got.name, got.prediction_type) == \
            (want.name, want.prediction_type)


def _colour_map(seed):
    """A (48, 40, 3) uint8 colour map: four flat regions (one pure black),
    a noisy border and a few stray pixels."""
    rng = np.random.default_rng(seed)
    img = np.zeros((48, 40, 3), np.uint8)
    img[:24, :20] = (255, 0, 0)
    img[:24, 20:] = (0, 0, 255)
    img[24:, :20] = (10, 200, 30)
    img[24:, 20:] = (0, 0, 0)
    img[:, 18:22] = rng.integers(0, 256, (48, 4, 3), dtype=np.uint8)
    img[rng.integers(0, 48, 9), rng.integers(0, 40, 9)] = (250, 250, 250)
    return img


@pytest.mark.parametrize("seed", [0, 1])
def test_region_ui_equals_jax(seed):
    img = _colour_map(seed)
    gray = img.mean(-1)
    gray[gray > 200] = 255
    assert np.array_equal(tregion_ui.mask_from_grayscale_map(gray),
                          jregion_ui.mask_from_grayscale_map(gray))
    for thr in (0.01, 0.1):
        assert tregion_ui.unique_colors(img, thr) == \
            jregion_ui.unique_colors(img, thr)
    for colour in ((255, 0, 0), (3, 3, 3), (10, 200, 30)):
        assert np.array_equal(tregion_ui.color_mask(img, colour),
                              jregion_ui.color_mask(img, colour))
    got = tregion_ui.extract_color_masks(img, max_colors=3)
    want = jregion_ui.extract_color_masks(img, max_colors=3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    for gray_map in (img[..., 0], img):
        for g, w in zip(tregion_ui.extract_color_masks(gray_map),
                        jregion_ui.extract_color_masks(gray_map)):
            assert np.array_equal(g, w)
    phrases = [" red cat", "blue bird "]
    st = tregion_ui.build_region_state(phrases, got[:2], [0.5, 1.5], [0.2, 0])
    sj = jregion_ui.build_region_state(phrases, want[:2], [0.5, 1.5], [0.2, 0])
    assert list(st) == list(sj) == ["red cat", "blue bird"]
    for k in st:
        assert np.array_equal(st[k]["mask"], sj[k]["mask"])
        assert (st[k]["weight"], st[k]["mask_outsides"]) == \
            (sj[k]["weight"], sj[k]["mask_outsides"])
    for size, sel in (((40, 48), "red cat"), ((33, 21), ""), ((96, 80), "x")):
        assert np.array_equal(
            tregion_ui.create_mixed_img(st, *size, selected=sel),
            jregion_ui.create_mixed_img(sj, *size, selected=sel))
    for shape in ((48, 40), (48, 40, 3)):
        a = np.arange(np.prod(shape)).reshape(shape)
        for h, w in ((17, 13), (96, 80), (48, 40)):
            from diffusionspatialcontrol_tpu.ops.preprocess import (
                resize_nearest,
            )
            assert np.array_equal(tregion_ui.resize_nearest(a, h, w),
                                  resize_nearest(a, h, w))


def test_native_codec_bytes_equal_jax():
    """PNG bytes at compression 0, 6 and 9, grids and the uint8 conversion
    of the port's binding equal the JAX package's binding's."""
    assert tnative.available() and jnative.available()
    rng = np.random.default_rng(0)
    for shape in ((1, 1, 3), (17, 23, 3), (64, 48, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        for level in (0, 6, 9):
            assert tnative.encode_png(img, level) == \
                jnative.encode_png(img, level)
    imgs = rng.integers(0, 256, (5, 9, 7, 3), dtype=np.uint8)
    for cols in (1, 2, 4):
        assert np.array_equal(tnative.make_grid(imgs, cols),
                              jnative.make_grid(imgs, cols))
    x = np.concatenate([rng.uniform(-1.2, 1.2, 4096),
                        [-1.0, 1.0, 0.0, -0.49411765, np.nan]]).astype(
                            np.float32).reshape(1, -1, 1, 1)
    x = x[:, :4100]
    assert np.array_equal(tnative.tensor_to_u8(x), jnative.tensor_to_u8(x))
    with pytest.raises(ValueError):
        tnative.encode_png(np.zeros((4, 4, 4), np.uint8))


def test_native_build_failure_raises_with_compiler_output(monkeypatch,
                                                          tmp_path):
    """No fallback: a codec that does not build raises with the
    compiler's output."""
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    assert not tnative.available()
    with pytest.raises(RuntimeError, match="building the image codec "
                       "failed.*broken.cc"):
        tnative.encode_png(np.zeros((2, 2, 3), np.uint8))


def test_profiling_matches_jax():
    t, j = tprofiling.PhaseTimer(), jprofiling.PhaseTimer()
    for timer in (t, j):
        with timer.phase("encode"):
            pass
        with timer.phase("encode"):
            pass
        with pytest.raises(ZeroDivisionError):
            with timer.phase("sample"):
                1 / 0
    assert list(t.phases) == list(j.phases) == ["encode", "sample"]
    import json

    got = json.loads(t.summary(model="m", steps=4))
    want = json.loads(j.summary(model="m", steps=4))
    for rec in (got, want):
        rec.pop("hbm_in_use_mb", None)
        rec.pop("hbm_limit_mb", None)
    assert list(got) == list(want)
    assert (got["model"], got["steps"]) == ("m", 4)
    assert tprofiling.device_memory_stats() is None  # no card used here
    for wd in (tprofiling.Watchdog(1e-9), jprofiling.Watchdog(1e-9)):
        import time

        time.sleep(1e-3)
        with pytest.raises(TimeoutError, match="1e-09s watchdog"):
            wd.check()
    tprofiling.Watchdog(0).check()  # 0 turns it off


# -- routing parity -------------------------------------------------------

def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return jnp.dtype(dt).name


def _summ(x):
    """Arrays by (shape, dtype, sum); GenerationConfig and DenoiseExtras by
    fields; callables by kind; containers recursively."""
    if isinstance(x, torch.Tensor):
        return ("array", tuple(x.shape), _dtype_name(x.dtype),
                round(x.double().sum().item(), 3))
    if isinstance(x, (np.ndarray, jax.Array)):
        return ("array", tuple(x.shape), _dtype_name(x.dtype),
                round(float(np.asarray(x, np.float64).sum()), 3))
    if isinstance(x, (jcfg.GenerationConfig, tcfg.GenerationConfig)):
        return ("GenerationConfig", {
            f.name: (_dtype_name(getattr(x, f.name)) if f.name == "dtype"
                     else getattr(x, f.name))
            for f in dataclasses.fields(x)})
    if isinstance(x, (japi.DenoiseExtras, tapi.DenoiseExtras)):
        return ("DenoiseExtras", {f.name: _summ(getattr(x, f.name))
                                  for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _summ(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_summ(v) for v in x]
    if callable(x):
        return "callable"
    return x


def _recorder(log, xp, arrays):
    """A stand-in for the pipeline class that logs each call and returns
    placeholders of the right shapes (numpy for JAX, torch for the port);
    the unit images its extras builders get go to ``arrays`` whole, and
    the hires pass's ``rebuild_extras`` is called with the pass's config."""
    zeros = ((lambda s, dt="float32": np.zeros(s, dt)) if xp is np else
             (lambda s, dt="float32": torch.zeros(s, dtype=getattr(
                 torch, dt))))

    def n_of(seed, default):
        return len(seed) if isinstance(seed, (list, tuple)) else default

    class Recorder:
        def __init__(self, model_cfg, params, tokenizer=None, **kwargs):
            self.model_cfg = model_cfg

        def _log(self, name, args, kwargs):
            log.append((name, _summ(list(args)), _summ(kwargs)))

        def encode_prompt(self, prompts, negs, **kw):
            self._log("encode_prompt", (prompts, negs), kw)
            n = len(prompts) * kw.get("num_images_per_prompt", 1)
            return zeros((2 * n, 77, 64)), [[49406, 7 + i, 49407]
                                            for i in range(len(prompts))]

        def encode_region(self, states, ids, **kw):
            self._log("encode_region", (states, ids), kw)
            return tuple(zeros((1, 4)) for _ in range(4))

        def _images(self, b, gen, kw, scale=1.0):
            h, w = int(gen.height * scale), int(gen.width * scale)
            img = zeros((b, h, w, 3), "uint8" if kw.get("uint8_output")
                        else "float32")
            if not kw.get("return_history"):
                return img
            hist = zeros((gen.num_inference_steps, b, gen.height // 8,
                          gen.width // 8, 4))
            if kw.get("hires"):
                return img, [hist, zeros((2, b, h // 8, w // 8, 4))]
            return img, hist

        def txt2img(self, context, gen, **kw):
            self._log("txt2img", (context, gen), kw)
            hires = kw.get("hires")
            if hires and hires.get("rebuild_extras"):
                scale = float(hires["scale"])
                hires["rebuild_extras"](dataclasses.replace(
                    gen, height=int(gen.height * scale) // 8 * 8,
                    width=int(gen.width * scale) // 8 * 8,
                    num_inference_steps=hires.get("steps")
                    or gen.num_inference_steps))
            return self._images(n_of(kw.get("seed"), kw.get("batch_size", 1)),
                                gen, kw, hires["scale"] if hires else 1.0)

        def img2img(self, context, latents, gen, **kw):
            self._log("img2img", (context, latents, gen), kw)
            return self._images(latents.shape[0], gen, kw)

        def inpaint(self, context, image, mask, gen, **kw):
            self._log("inpaint", (context, image, mask, gen), kw)
            return self._images(image.shape[0], gen, kw)

        def encode_image(self, images, **kw):
            self._log("encode_image", (images,), kw)
            b, h, w, _ = images.shape
            return zeros((b, h // 8, w // 8, 4))

        def sample_chunked(self, context, gen, **kw):
            self._log("sample_chunked", (context, gen), kw)
            total = gen.num_inference_steps
            for done in range(kw["chunk_steps"], total + kw["chunk_steps"],
                              kw["chunk_steps"]):
                kw["on_chunk"](min(done, total), total)
            return zeros((kw.get("batch_size", 1), gen.height, gen.width, 3),
                         "uint8")

        def decode_latents(self, latents):
            self._log("decode_latents", (latents,), {})
            b, h, w, _ = latents.shape
            return zeros((b, 8 * h, 8 * w, 3))

        def _turbo(name):
            def run(self, context, gen, *args, **kw):
                self._log(name, (context, gen) + args, kw)
                return zeros((kw.get("batch_size", 1), gen.height, gen.width,
                              3), "uint8")
            return run

        txt2img_cfg_tail = _turbo("txt2img_cfg_tail")
        txt2img_deepcache = _turbo("txt2img_deepcache")
        txt2img_tgate = _turbo("txt2img_tgate")
        txt2img_bottleneck = _turbo("txt2img_bottleneck")

        @staticmethod
        def to_uint8(images):
            log.append(("to_uint8", _summ([images]), {}))
            if xp is np:
                return np.asarray(images).astype(np.uint8)
            return images.to(torch.uint8)

        def _unit_images(self, name, gen, params, imgs, kw):
            """Logs the images' shapes and dtypes; their values go to
            ``arrays`` (a resize differs by rounding between packages).
            Returns the package's extras with a name in place of the
            models."""
            self._log(name, (gen, params, [(tuple(i.shape),
                                            _dtype_name(i.dtype))
                                           for i in imgs]), kw)
            arrays.extend(np.asarray(i, np.float64) for i in imgs)
            extras = japi.DenoiseExtras if xp is np else tapi.DenoiseExtras
            return extras(controlnet_params=[f"{name} {len(arrays)}"])

        def build_controlnet_extras(self, gen, params, imgs, **kw):
            return self._unit_images("build_controlnet_extras", gen, params,
                                     imgs, kw)

        def build_t2i_extras(self, gen, params, imgs, **kw):
            return self._unit_images("build_t2i_extras", gen, params, imgs,
                                     kw)

        def build_ip_extras(self, adapters, embeds, **kw):
            """Logs the adapters by (variant, tokens) and the embeds, masks
            and scales; returns the package's extras with the scales and
            masks and a name in place of each adapter's tokens."""
            self._log("build_ip_extras", (
                [(a.variant, a.num_tokens) for a in adapters], embeds), kw)
            extras = japi.DenoiseExtras if xp is np else tapi.DenoiseExtras
            masks = kw.get("masks")
            return extras(
                ip_tokens=tuple(f"tokens {i}" for i in range(len(adapters))),
                ip_scales=tuple(kw["scales"]),
                ip_masks=None if masks is None else tuple(masks))

    return Recorder


_CFG = jcfg.tiny_config()
_MASK = np.zeros((64, 64), np.float32)
_MASK[20:40, 10:50] = 1.0
_INIT = np.random.default_rng(0).integers(0, 256, (64, 64, 3)).astype(
    np.uint8)
_TURBO = ("cfg_tail_frac", 0.3), ("deepcache_interval", 3), (
    "bottleneck_low_scale", 0.5), ("tgate_gate_frac", 0.5)
_UNIT = np.random.default_rng(1).random((64, 64, 3)).astype(np.float32)
_BIG = np.random.default_rng(2).random((96, 96, 3)).astype(np.float32)
_CN = {"kind": "ControlNetUnit", "model": "Canny", "image": _UNIT,
       "scale": 0.8, "guidance_end": 0.6}
_T2I = {"kind": "T2IAdapterUnit", "model": "Sketch", "image": _UNIT,
        "scale": 0.9, "conditioning_factor": 0.5}
_IP = {"kind": "IPAdapterUnit", "model": "IP-Adapter", "image": _INIT,
       "scale": 0.7, "mask": _MASK}
_VCFG = dict(image_size=28, patch_size=14, hidden_size=32,
             intermediate_size=64, num_layers=2, num_heads=2,
             projection_dim=16)
_EMB = np.random.default_rng(3).standard_normal((2, 16)).astype(np.float32)
_HIDDEN = np.random.default_rng(4).standard_normal((2, 5, 32)).astype(
    np.float32)

# (id, inference keyword arguments) on top of a tiny 64^2, 4-step request
REQUESTS = [
    ("txt2img", {}),
    ("txt2img_map", {"region_state": _state(64)}),
    ("cfg_off_map", {"cfg_scale": 1.0, "region_state": _state(64)}),
    ("nipp2", {"num_images_per_prompt": 2, "region_state": _state(64)}),
    ("seed_list", {"num_images_per_prompt": 2, "seed": [3, 11]}),
    ("prompt_list_of_one", {"prompt": [PROMPT],
                            "region_state": [_state(64)]}),
    ("sampler_and_mode", {"sampler": "Euler a Exponential",
                          "encoding_mode": "short", "clip_skip": 1,
                          "guidance_rescale": 0.7, "eta": 0.5}),
    ("hires_region", {"hires_scale": 2.0, "hires_sampler": "Heun",
                      "hires_steps": 3, "hires_mode": "Latent (bicubic "
                      "antialiased)", "region_state": _state(64)}),
    ("hires_no_region", {"hires_scale": 1.5, "hires_region": False,
                         "hires_strength": 0.4, "region_state": _state(64)}),
    ("img2img", {"init_image": _INIT, "strength": 0.5,
                 "region_state": _state(64)}),
    ("img2img_float", {"init_image": [_INIT.astype(np.float32) / 255.0]}),
    ("inpaint", {"init_image": _INIT, "inpaint_mask": _MASK}),
    ("inpaint_invert", {"init_image": _INIT, "inpaint_mask": _MASK,
                        "invert_mask": True, "strength": 0.75}),
    ("chunked", {"cancel_check_steps": 3, "region_state": _state(64)}),
    ("chunked_hires_runs_plain", {"cancel_check_steps": 3,
                                  "hires_scale": 2.0}),
    ("preview_true", {"latent_preview": True}),
    ("preview_base_img2img", {"latent_preview": "base",
                              "init_image": _INIT}),
    ("preview_hires", {"latent_preview": "hires", "hires_scale": 2.0}),
    ("preview_base_hires", {"latent_preview": "base", "hires_scale": 2.0}),
    ("preview_both", {"latent_preview": "both", "hires_scale": 2.0}),
    ("preview_bad", {"latent_preview": "all"}),
    ("preview_hires_without_hires", {"latent_preview": "hires"}),
    ("grid_2x2", {"prompt": [PROMPT, "a dog"], "seed": [4, 9],
                  "region_state": [_state(64), None]}),
    ("grid_3x1_cfg_off", {"prompt": ["a", "b", "c"], "cfg_scale": 1.0,
                          "region_state": _state(64)}),
    ("grid_img2img", {"prompt": ["a", "b"], "num_images_per_prompt": 2,
                      "init_image": _INIT}),
    ("grid_img2img_per_prompt", {"prompt": ["a", "b"],
                                 "init_image": [_INIT, 255 - _INIT]}),
    ("grid_hires", {"prompt": ["a", "b"], "hires_scale": 2.0}),
    ("grid_preview", {"prompt": ["a", "b"], "latent_preview": "base"}),
    ("grid_inpaint", {"prompt": ["a", "b"], "init_image": _INIT,
                      "inpaint_mask": _MASK}),
    ("grid_states", {"prompt": ["a", "b"], "region_state": [_state(64)]}),
    ("grid_inits", {"prompt": ["a", "b"], "init_image": [_INIT] * 3}),
    ("grid_cfg_tail", {"prompt": ["a", "b"], "cfg_tail_frac": 0.2}),
    # the JAX package's grid mode neither runs nor refuses TGATE: the
    # grid samples plainly
    ("grid_tgate", {"prompt": ["a", "b"], "tgate_gate_frac": 0.5}),
    ("unknown_sampler", {"sampler": "Euler b"}),
    ("unknown_hires_sampler", {"hires_scale": 2.0,
                               "hires_sampler": "Euler b"}),
    ("unknown_model", {"model": "missing"}),
    ("unknown_upscale_mode", {"hires_scale": 2.0, "hires_mode": "Pixel"}),
] + [
    (f"{a}+{b}", {a: va, b: vb})
    for i, (a, va) in enumerate(_TURBO) for b, vb in _TURBO[i + 1:]
] + [
    (f"{a}+init", {a: va, "init_image": _INIT}) for a, va in _TURBO
] + [
    (f"{a}+chunked", {a: va, "cancel_check_steps": 2}) for a, va in _TURBO
] + [
    (f"{a}+hires", {a: va, "hires_scale": 2.0}) for a, va in _TURBO
] + [
    (f"{a}+preview", {a: va, "latent_preview": True}) for a, va in _TURBO
] + [
    (a, {a: va, "region_state": _state(64)}) for a, va in _TURBO
] + [
    (f"{a}_nipp2_cfg_off", {a: va, "num_images_per_prompt": 2,
                            "cfg_scale": 1.0, "region_state": _state(64)})
    for a, va in _TURBO
] + [
    (f"{a}_t2i_ip", {a: va, "t2i_units": [_T2I], "ip_adapter_units": [_IP]})
    for a, va in _TURBO
] + [  # ControlNet and T2I-Adapter units: dicts made into each package's
    # unit dataclass by _run
    ("cn", {"controlnet_units": [_CN]}),
    ("t2i", {"t2i_units": [_T2I]}),
    ("cn_t2i_two_each", {
        "controlnet_units": [_CN, {**_CN, "model": "Depth", "scale": 0.5,
                                   "guidance_start": 0.25,
                                   "guidance_end": 0.75}],
        "t2i_units": [_T2I, {**_T2I, "model": "Color", "scale": 0.3,
                             "conditioning_factor": 0.25}],
        "region_state": _state(64)}),
    ("cn_guess_any", {"controlnet_units": [_CN, {**_CN, "guess_mode": True}]}),
    ("cn_cfg_off", {"controlnet_units": [_CN], "cfg_scale": 1.0}),
    ("cn_nipp2", {"controlnet_units": [_CN], "t2i_units": [_T2I],
                  "num_images_per_prompt": 2}),
    ("cn_grid", {"prompt": [PROMPT, "a dog"], "seed": [4, 9],
                 "controlnet_units": [_CN], "t2i_units": [_T2I]}),
    ("cn_grid_img2img", {"prompt": ["a", "b"], "init_image": _INIT,
                         "controlnet_units": [_CN]}),
    ("cn_hires", {"controlnet_units": [_CN], "t2i_units": [_T2I],
                  "hires_scale": 2.0, "hires_steps": 2,
                  "region_state": _state(64)}),
    ("cn_img2img", {"controlnet_units": [_CN], "init_image": _INIT,
                    "strength": 0.5}),
    ("cn_inpaint", {"t2i_units": [_T2I], "controlnet_units": [_CN],
                    "init_image": _INIT, "inpaint_mask": _MASK}),
    ("cn_chunked", {"controlnet_units": [_CN], "cancel_check_steps": 2}),
    ("unit_uint8_and_2d", {
        "controlnet_units": [{**_CN, "image": _INIT}],
        "t2i_units": [{**_T2I, "image": _UNIT[..., 0]}]}),
    ("unit_larger_than_request", {
        "controlnet_units": [{**_CN, "image": _BIG}],
        "t2i_units": [{**_T2I, "image": _BIG[:80, :72]}],
        "hires_scale": 1.5}),
    ("unit_preprocessor", {"controlnet_units": [
        _CN, {**_CN, "preprocessor": "Canny",
              "preprocessor_options": {"low": 100}}]}),
    ("unit_path", {"t2i_units": [{**_T2I, "model": __file__}]}),
] + [  # IP-Adapter units: the image tower and the face networks are stubs
    # (_stub_ip_models), the adapters' weights each package's by name
    (f"ip {name}", {"ip_adapter_units": [
        {"kind": "IPAdapterUnit", "model": name, "image": _INIT,
         "scale": 0.6, "mask": _MASK if i % 2 else None}]})
    for i, name in enumerate(jregistry.IP_ADAPTER_MODELS)
] + [
    ("ip_two_units_map", {"ip_adapter_units": [_IP, {
        **_IP, "model": "IP-Adapter Plus", "image": _UNIT, "mask": None,
        "scale": 1.0}], "region_state": _state(64)}),
    ("ip_image_embeds", {"ip_adapter_units": [
        {**_IP, "image": None, "image_embeds": _EMB[0]},
        {**_IP, "model": "IP-Adapter Plus Face", "image": None,
         "image_embeds": _HIDDEN[0], "uncond_image_embeds": _HIDDEN[1]},
        {**_IP, "model": "IP-Adapter Face", "image": None,
         "image_embeds": _EMB[:2], "uncond_image_embeds": _EMB[1]}],
        "num_images_per_prompt": 2}),
    ("ip_invert_mask", {"ip_adapter_units": [{**_IP, "invert_mask": True}]}),
    ("ip_nipp2", {"ip_adapter_units": [_IP, {
        **_IP, "model": "IP-Adapter FaceID", "mask": None}],
        "num_images_per_prompt": 2}),
    ("ip_faceid_detector", {"ip_adapter_units": [{
        **_IP, "model": "IP-Adapter FaceID", "image": _BIG}], "_faces": True}),
    ("ip_faceid_unit_embedder", {"ip_adapter_units": [{
        **_IP, "model": "IP-Adapter FaceID",
        "face_embedder": "unit"}], "_faces": True}),
    ("ip_cfg_off", {"ip_adapter_units": [_IP], "cfg_scale": 1.0}),
    ("ip_hires", {"ip_adapter_units": [_IP], "hires_scale": 2.0,
                  "region_state": _state(64)}),
    ("ip_t2i_hires", {"ip_adapter_units": [_IP], "t2i_units": [_T2I],
                      "hires_scale": 2.0}),
    ("ip_grid", {"prompt": [PROMPT, "a dog"], "seed": [4, 9],
                 "ip_adapter_units": [_IP]}),
    ("ip_img2img", {"ip_adapter_units": [_IP], "init_image": _INIT,
                    "strength": 0.5}),
    ("ip_inpaint", {"ip_adapter_units": [_IP], "init_image": _INIT,
                    "inpaint_mask": _MASK}),
    ("ip_chunked", {"ip_adapter_units": [_IP], "cancel_check_steps": 2}),
    ("ip_no_image", {"ip_adapter_units": [{**_IP, "image": None}]}),
]


def _face_embedder(xp):
    """A unit's own embedder: the package's stub on a flipped crop."""
    embed = jface_embed.embed_face if xp == "jax" else tface_embed.embed_face
    return lambda img: embed(np.asarray(img)[:, ::-1])


def _units(api, kwargs):
    """The unit dicts of a request as ``api``'s unit dataclasses."""
    out = dict(kwargs)
    out.pop("_faces", None)
    for key in ("controlnet_units", "t2i_units", "ip_adapter_units"):
        if key in out:
            out[key] = [getattr(api, u["kind"])(**{
                k: (_face_embedder("jax" if api is japi else "torch")
                    if k == "face_embedder" else v)
                for k, v in u.items() if k != "kind"}) for u in out[key]]
    return out


def _stub_unit_models(m, log, real):
    """Record the manager's unit-model and preprocessor calls and hand the
    pipeline a name in place of each model. With ``real``, the manager's
    own methods run first (the port: a random model, or its preprocessor);
    the JAX package's would build a random model, so its side only
    records. A model from a path is loaded in both packages."""
    def stub(name, what):
        own = getattr(m, name)

        def call(model, *args, **kwargs):
            log.append((name, model))
            if real or (name != "get_preprocessor"
                        and os.path.exists(model)):
                own(model, *args, **kwargs)
            return (lambda img, **kw: np.asarray(img, np.float32)) \
                if name == "get_preprocessor" else f"{what} {model}"
        setattr(m, name, call)

    stub("get_controlnet", "controlnet")
    stub("get_t2i_adapter", "adapter")
    stub("get_preprocessor", "preprocessor")


_UNETS = {}


def _tiny_unet(package):
    """The tiny UNet tree in ``package``'s layout: the IP-Adapter branch
    installs its weights into a copy of it."""
    if package not in _UNETS:
        tree = tfactory.init_pipeline_params(0, tcfg.tiny_config(),
                                             torch.float32, "cpu")["unet"]
        from tests.test_torch_controlnet import to_jax

        _UNETS["torch"], _UNETS["jax"] = tree, to_jax(tree)
    return _UNETS[package]


def _stub_ip_models(m, log, package, monkeypatch, faces):
    """The image tower as a stub in both packages (a tiny config; embeds
    of ones from an image, of zeros from zero pixels, so that the
    Resampler's uncond shows), the manager's calls recorded. With
    ``faces``, a registered detector and embedder: the port builds its
    tiny networks, then both packages get the same numpy stand-ins (a
    crop of the photo, the stub embedder)."""
    mod = jclip_vision if package == "jax" else tclip_vision
    cfg = mod.CLIPVisionConfig(**_VCFG)
    m.get_image_encoder = lambda: log.append(("get_image_encoder",)) or (
        cfg, "encoder")

    def tower(params, c, pixels, output_hidden_state=False):
        # the pixels by shape and dtype: their values differ by rounding
        # (tests/test_torch_clip_vision.py holds them to 1e-5)
        log.append(("clip_vision_apply", tuple(pixels.shape),
                    _dtype_name(pixels.dtype), output_hidden_state))
        b = pixels.shape[0]
        shape = ((b, c.num_patches + 1, c.hidden_size)
                 if output_hidden_state else (b, c.projection_dim))
        if package == "jax":
            return jnp.ones(shape) * float(jnp.abs(pixels).sum() > 0)
        return torch.ones(shape) * float(pixels.abs().sum() > 0)

    monkeypatch.setattr(mod, "clip_vision_apply", tower)
    own_aligner, own_embedder = m.get_face_aligner, m.get_face_embedder
    embed = (jface_embed if package == "jax" else tface_embed).embed_face
    if faces and package == "torch":
        m.register_face_detector(cfg=tface_detect.FACEDETECT_TINY,
                                 top1_fallback=True)
        m.register_face_embedder(cfg=dataclasses.replace(
            tarcface.ARCFACE_TINY, embed_dim=512))

    def aligner():
        log.append(("get_face_aligner",))
        if not faces:
            return own_aligner()
        if package == "torch":
            crop = own_aligner()(_BIG)
            assert crop.shape == (112, 112, 3)
        return lambda img: np.asarray(img, np.float32)[8:72, 4:68]

    def embedder():
        log.append(("get_face_embedder",))
        if faces and package == "torch":
            assert own_embedder()(_BIG).shape == (512,)
        return embed

    m.get_face_aligner, m.get_face_embedder = aligner, embedder


def _run(package, monkeypatch, kwargs, arrays=None):
    """(calls, outcome) of one inference() in ``package``; the unit images
    the pipeline's extras builders get are appended to ``arrays``."""
    log = []
    arrays = [] if arrays is None else arrays
    if package == "jax":
        api, m = japi, japi.ModelManager(dtype=jnp.float32)
        monkeypatch.setattr(api, "StableDiffusionTPU",
                            _recorder(log, np, arrays))
    else:
        api, m = tapi, tapi.ModelManager(dtype=torch.float32, device="cpu")
        monkeypatch.setattr(api, "StableDiffusionTorch",
                            _recorder(log, torch, arrays))
    m._dirs["tiny"] = ("", _CFG)
    m._cache["tiny"] = ({"unet": _tiny_unet(package)}
                        if "ip_adapter_units" in kwargs else {})
    m._tokenizers["tiny"] = None
    _stub_unit_models(m, log, real=package == "torch")
    _stub_ip_models(m, log, package, monkeypatch, kwargs.get("_faces"))
    ticks = []
    kw = {"prompt": PROMPT, "model": "tiny", "steps": 4, "width": 64,
          "height": 64, "progress_cb": lambda d, t: ticks.append((d, t)),
          **_units(api, kwargs)}
    if package == "jax":
        kw["dtype"] = jnp.float32
    else:
        kw["dtype"] = torch.float32
    try:
        out = api.inference(m, **kw)
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return log, ticks, (type(e).__name__, str(e))
    images = out["images"]
    assert isinstance(images, np.ndarray) and images.dtype == np.uint8
    previews = [p.shape for p in out.get("previews") or []]
    return log, ticks, ("ok", images.shape, previews)


@pytest.mark.parametrize("kwargs", [r[1] for r in REQUESTS],
                         ids=[r[0] for r in REQUESTS])
def test_inference_routes_as_jax(kwargs, monkeypatch):
    """Both packages' inference() make the same pipeline calls with the
    same arguments in the same order, and return images of the same shape
    or raise the same error; the speed modes route to the same pipeline
    method with the same arguments. A unit's preprocessor is fetched from
    the manager by both packages (the port builds it; both hand the
    pipeline the stub's image). A unit model from a path is
    loaded by both packages (a file that is no weight file raises the same
    error in both). The unit images the
    extras builders get (fitted to the request's size, or the hires pass's)
    are equal to 1e-6."""
    jarr, tarr = [], []
    jlog, jticks, jout = _run("jax", monkeypatch, kwargs, jarr)
    tlog, tticks, tout = _run("torch", monkeypatch, kwargs, tarr)
    assert tout == jout
    assert tlog == jlog
    assert tticks == jticks
    assert len(tarr) == len(jarr)
    for t, j in zip(tarr, jarr):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


# -- the port on the tiny model ---------------------------------------------

@pytest.fixture(scope="module")
def manager():
    m = tapi.ModelManager(dtype=torch.float32, device="cpu")
    m.register_random("tiny", tcfg.tiny_config(), seed=0)
    return m


def test_inference_is_txt2img_and_to_uint8(manager):
    state = _state(64)
    out = tapi.inference(manager, PROMPT, "tiny", steps=3, width=64,
                         height=64, seed=5, region_state=state,
                         encoding_mode="short", dtype=torch.float32)
    cfg, params, tok = manager.get("tiny")
    pipe = tpipeline.StableDiffusionTorch(cfg, params, tokenizer=tok,
                                          device="cpu")
    ctx, ids = pipe.encode_prompt([PROMPT], [tcfg.DEFAULT_NEGATIVE_PROMPT],
                                  clip_skip=2)
    rb = pipe.encode_region([state], ids, height=64, width=64)
    gen = tcfg.GenerationConfig(height=64, width=64, num_inference_steps=3,
                                dtype=torch.float32)
    want = tpipeline.to_uint8(pipe.txt2img(ctx, gen, seed=5,
                                           region_biases=rb)).numpy()
    assert out["images"].dtype == np.uint8
    assert np.array_equal(out["images"], want)
    import json

    timings = json.loads(out["timings"])
    assert {"total_s", "encode_s", "conditioning_s", "sample_s",
            "to_host_s"} <= set(timings)
    assert (timings["model"], timings["steps"]) == ("tiny", 3)


def test_grid_sample_is_its_single_request(manager, monkeypatch):
    """Sample (p, s) of a 2x2 grid draws the same latents and solver noise,
    bit for bit, as txt2img with prompt p and seed s alone. Where its
    prompt has no map, its image matches within the bound of
    tests/test_torch_pipeline.py's batched runs (rtol/atol 1e-3 before the
    uint8 step: the CPU's batched convolutions sum in another order). A
    mapped prompt's samples are coupled to the batch by design: the bias
    strength sigma * std(QK^T) takes its std over the whole batch, as the
    reference's ``qk.std()`` does (ops/attention.py), in both packages.
    inference() returns the grid's uint8."""
    cfg, params, tok = manager.get("tiny")
    pipe = tpipeline.StableDiffusionTorch(cfg, params, tokenizer=tok,
                                          device="cpu")
    draws = []
    noise, solver_noise = tpipeline.initial_noise, \
        tpipeline.StableDiffusionTorch._solver_noise

    def record_noise(seeds, shape, device):
        out = noise(seeds, shape, device)
        draws.append(("latents", list(seeds), out))
        return out

    def record_solver(self, seeds, *a, **k):
        out = solver_noise(self, seeds, *a, **k)
        draws.append(("solver", list(seeds), out))
        return out

    monkeypatch.setattr(tpipeline, "initial_noise", record_noise)
    monkeypatch.setattr(tpipeline.StableDiffusionTorch, "_solver_noise",
                        record_solver)
    prompts, seeds = [PROMPT, "a dog on the grass"], [4, 9]
    states = [_state(64), None]
    spec = tregistry.SAMPLERS["Euler a"]
    gen = tcfg.GenerationConfig(height=64, width=64, num_inference_steps=3,
                                sampler=spec.solver, schedule=spec.schedule,
                                dtype=torch.float32)
    neg = tcfg.DEFAULT_NEGATIVE_PROMPT
    grid = generate_grid(pipe, prompts, seeds, gen, negative_prompt=neg,
                         region_states=states, mesh="auto")
    grid_draws, draws[:] = list(draws), []
    assert [(k, s) for k, s, _ in grid_draws] == [
        ("latents", [4, 9, 4, 9]), ("solver", [4, 9, 4, 9])]
    for p, prompt in enumerate(prompts):
        ctx, ids = pipe.encode_prompt([prompt], [neg], clip_skip=2)
        rb = pipe.encode_region([states[p]], ids, height=64, width=64)
        for s, seed in enumerate(seeds):
            draws.clear()
            one = pipe.txt2img(ctx, gen, seed=seed, region_biases=rb)
            i = 2 * p + s
            for (kind, _, g), (_, _, o) in zip(grid_draws, draws):
                # the batch axis: (B, ...) latents, (steps, draws, B, ...)
                # solver noise
                assert torch.equal(g.narrow(kind == "solver" and 2 or 0, i,
                                            1), o)
            if states[p] is None:
                torch.testing.assert_close(grid[i:i + 1], one, rtol=1e-3,
                                           atol=1e-3)
            else:
                assert not torch.allclose(grid[i:i + 1], one, rtol=1e-3,
                                          atol=1e-3)
    out = tapi.inference(manager, prompts, "tiny", sampler="Euler a",
                         steps=3, width=64, height=64, seed=seeds,
                         region_state=states, encoding_mode="short",
                         dtype=torch.float32)
    assert np.array_equal(out["images"], tpipeline.to_uint8(grid).numpy())


def test_grid_img2img_encodes_each_sample_under_its_seed(manager):
    cfg, params, tok = manager.get("tiny")
    pipe = tpipeline.StableDiffusionTorch(cfg, params, tokenizer=tok,
                                          device="cpu")
    gen = tcfg.GenerationConfig(height=64, width=64, num_inference_steps=3,
                                dtype=torch.float32)
    inits = [torch.from_numpy(tapi._to_pm1(im)) for im in (_INIT, 255 - _INIT)]
    calls = []
    encode = pipe.encode_image

    def record(images, seed=0):
        calls.append((float(images.sum()), seed))
        return encode(images, seed=seed)

    pipe.encode_image = record
    out = generate_grid(pipe, ["a", "b"], [2, 3], gen, init_images=inits,
                        strength=0.5, decode=False)
    assert [s for _, s in calls] == [2, 3, 2, 3]
    assert calls[0][0] == calls[1][0] != calls[2][0] == calls[3][0]
    assert tuple(out.shape) == (4, 8, 8, 4)
    # a mesh now runs (tests/test_torch_parallel.py); "auto" without a
    # process group is one device, and a mesh whose ranks cannot split the
    # grid equally is refused
    calls.clear()
    auto = generate_grid(pipe, ["a", "b"], [2, 3], gen, init_images=inits,
                         strength=0.5, decode=False, mesh="auto")
    assert torch.equal(auto, out) and len(calls) == 4
    with pytest.raises(ValueError, match="equal shards"):
        generate_grid(pipe, ["a"], [0], gen, mesh=tmesh.Mesh(
            rank=0, world_size=2, device=torch.device("cpu"),
            backend="gloo"))


def test_watchdog_and_progress_cb_stop_a_run(manager):
    with pytest.raises(TimeoutError, match="watchdog"):
        tapi.inference(manager, PROMPT, "tiny", steps=2, width=64,
                       height=64, timeout=1e-9, dtype=torch.float32)
    ticks = []

    def cancel(done, total):
        ticks.append((done, total))
        raise RuntimeError("cancelled by the client")

    with chip_smoke.UNetCalls() as n, pytest.raises(RuntimeError,
                                               match="cancelled"):
        tapi.inference(manager, PROMPT, "tiny", steps=6, width=64, height=64,
                       cancel_check_steps=2, progress_cb=cancel,
                       dtype=torch.float32)
    assert ticks == [(2, 6)]
    assert n.n == 2  # the run stopped after its first chunk of 2 steps


def test_unported_paths_raise_naming_their_item(manager, tmp_path):
    """What is not ported raises naming its ROADMAP item (22, multi-GPU:
    tests/test_torch_app.py's grid test); a unit's preprocessor runs
    (tests/test_torch_preprocess.py) and no error names its item (20), nor
    do the speed modes' (18; tests/test_torch_speed_modes.py). Weights
    from a path load
    (tests/test_torch_convert.py, test_torch_lora_ti.py): a path that holds
    no weight file raises what the JAX package raises there, at the first
    use of what it names. A unit model by name runs, and so do the
    IP-Adapter getters (tests/test_torch_units.py and
    tests/test_torch_ip_adapter.py have the units' parity)."""
    base = dict(prompt=PROMPT, model="tiny", steps=2, width=64, height=64,
                dtype=torch.float32)
    img = np.zeros((64, 64, 3), np.float32)
    out = tapi.inference(manager, **{**base, "controlnet_units": [
        tapi.ControlNetUnit("Canny", img, preprocessor="Canny")]})
    assert out["images"].shape == (1, 64, 64, 3)
    out = tapi.inference(manager, **{**base, "tgate_gate_frac": 0.5,
                                     "sampler": "Euler"})
    assert out["images"].shape == (1, 64, 64, 3)
    for kwargs, error in (
            ({"t2i_units": [tapi.T2IAdapterUnit(str(tmp_path), img)]},
             FileNotFoundError),
            ({"ip_adapter_units": [tapi.IPAdapterUnit(__file__, img)]},
             pickle.UnpicklingError),
            ({"loras": [str(tmp_path / "style.safetensors")]},
             FileNotFoundError),
            ({"ti_embeddings": [str(tmp_path / "emb.pt")]},
             FileNotFoundError)):
        with pytest.raises(error):
            tapi.inference(manager, **{**base, **kwargs})
    unet = tcfg.tiny_config().unet
    disk = tapi.ModelManager(dtype=torch.float32, device="cpu")
    disk.register("on disk", str(tmp_path))
    for call in (lambda: disk.get("on disk"),
                 lambda: disk.get_controlnet(str(tmp_path), unet),
                 lambda: disk.get_t2i_adapter(str(tmp_path))):
        with pytest.raises(FileNotFoundError, match="no weight file"):
            call()
    with pytest.raises(pickle.UnpicklingError):
        disk.get_ip_adapter_state(__file__, unet)
    disk.register_image_encoder(str(tmp_path))
    disk.register_face_embedder(str(tmp_path / "backbone.pth"))
    disk.register_face_detector(str(tmp_path / "scrfd.pth"))
    for call in (disk.get_image_encoder, disk.get_face_embedder,
                 disk.get_face_aligner):
        with pytest.raises(FileNotFoundError):
            call()
    assert manager.get_preprocessor("Canny")(img).shape == (64, 64, 3)
    manager.register_preprocessor("Depth", path=str(tmp_path / "dpt.bin"))
    with pytest.raises(FileNotFoundError):
        manager.get_preprocessor("Depth")
    with pytest.raises(KeyError, match="not registered"):
        manager.get("nope")
    cn = manager.get_controlnet("Canny", unet)
    assert manager.get_controlnet("Canny", unet) is cn
    assert not cn["mid_zero_conv"]["kernel"].any()
    assert not any(z["kernel"].any() for z in cn["zero_convs"])
    ad = manager.get_t2i_adapter("Sketch", unet)
    assert ad["blocks"][3]["in_conv"] is None  # 128 -> 128
    assert manager.get_t2i_adapter("Sketch") is ad  # cached by name
    # the IP-Adapter getters: random weights by name, the stub embedder and
    # no detector until registered, networks once registered (cached)
    ipm = tapi.ModelManager(dtype=torch.float32, device="cpu")
    vcfg = tclip_vision.CLIPVisionConfig(**_VCFG)
    ipm.register_image_encoder(cfg=vcfg)
    enc_cfg, enc = ipm.get_image_encoder()
    assert enc_cfg is vcfg and ipm.get_image_encoder()[1] is enc
    assert enc["layers"][0]["fc1"]["kernel"].shape == (64, 32)
    for name, variant in tapi.ModelManager._IP_VARIANTS.items():
        st = ipm.get_ip_adapter_state(name, unet)
        assert ipm.get_ip_adapter_state(name, unet) is st
        # the same weights as the JAX package's by name (its routing rows
        # above hold each name's variant to the JAX package's)
        ref = jipa.random_state_dict(
            _CFG.unet, variant, seed=0,
            embed_dim=32 if variant == "resampler" else 16)
        for group in ref:
            assert all(np.array_equal(st[group][k], ref[group][k])
                       for k in ref[group])
    assert ipm.get_face_embedder() is tface_embed.embed_face
    assert ipm.get_face_aligner() is None
    ipm.register_face_embedder(cfg=tarcface.ARCFACE_TINY)
    embed = ipm.get_face_embedder()
    assert ipm.get_face_embedder() is embed
    assert embed(np.zeros((40, 40, 3), np.uint8)).shape == (32,)
    ipm.register_face_detector(cfg=tface_detect.FACEDETECT_TINY,
                               top1_fallback=True)
    align = ipm.get_face_aligner()
    assert align(_INIT).shape == (112, 112, 3)
    fresh = tapi.ModelManager(dtype=torch.float32, device="cpu")
    assert fresh.get_t2i_adapter("x")["blocks"][0]["in_conv"]["kernel"] \
        .shape[0] == 320  # the SD1.5 adapter without a config


def test_zero_head_controlnet_unit_changes_nothing(manager):
    """A ControlNet by name (zero heads) gives the image of the request
    without it, bit for bit; a T2I-Adapter unit changes the image."""
    kw = dict(prompt=PROMPT, model="tiny", steps=2, width=64, height=64,
              seed=3, encoding_mode="short", dtype=torch.float32)
    img = np.random.default_rng(3).integers(0, 256, (80, 80, 3)).astype(
        np.uint8)
    plain = tapi.inference(manager, **kw)["images"]
    cn = tapi.inference(manager, controlnet_units=[
        tapi.ControlNetUnit("Canny", img, guess_mode=True)], **kw)["images"]
    t2i = tapi.inference(manager, t2i_units=[
        tapi.T2IAdapterUnit("Sketch", img)], **kw)["images"]
    assert np.array_equal(cn, plain)
    assert not np.array_equal(t2i, plain)


def test_ip_unit_leaves_the_manager_tree_as_it_was(manager):
    """An IP-Adapter request installs its weights into a copy of the UNet
    tree's containers: the manager's tree gains no ``"ip"`` lists and a
    plain request after it gives the earlier plain image bit for bit. At
    scale 0 the unit gives the plain image (``out + 0 * ip_out``); a
    FaceID unit with the registered tiny detector and a 512-wide ArcFace
    moves it."""
    kw = dict(prompt=PROMPT, model="tiny", steps=2, width=64, height=64,
              seed=3, encoding_mode="short", dtype=torch.float32,
              region_state=_state(64))
    manager.register_image_encoder(cfg=tclip_vision.CLIPVisionConfig(
        **_VCFG))
    plain = tapi.inference(manager, **kw)["images"]
    unit = tapi.IPAdapterUnit("IP-Adapter Plus", _INIT, mask=_MASK)
    with_ip = tapi.inference(manager, ip_adapter_units=[unit], **kw)
    assert not np.array_equal(with_ip["images"], plain)
    attn2 = manager.get("tiny")[1]["unet"]["mid_block"]["attention"][
        "blocks"][0]["attn2"]
    assert "ip" not in attn2
    assert np.array_equal(tapi.inference(manager, **kw)["images"], plain)
    zero = dataclasses.replace(unit, scale=0.0)
    assert np.array_equal(tapi.inference(
        manager, ip_adapter_units=[zero], **kw)["images"], plain)
    manager.register_face_detector(cfg=tface_detect.FACEDETECT_TINY,
                                   top1_fallback=True)
    manager.register_face_embedder(cfg=dataclasses.replace(
        tarcface.ARCFACE_TINY, embed_dim=512))
    try:
        face = tapi.inference(manager, ip_adapter_units=[
            tapi.IPAdapterUnit("IP-Adapter FaceID", _INIT)], **kw)
        assert not np.array_equal(face["images"], plain)
    finally:
        manager._detector_spec = manager._face_cfg = None
        manager._adapters.pop("face_aligner", None)
        manager._adapters.pop("face_embedder", None)


def test_manager_registers_the_zoo_and_needs_a_card_by_default(tmp_path):
    m = tapi.ModelManager(device="cpu")
    j = japi.ModelManager()
    for repo in ("runwayml/stable-diffusion-v1-5",
                 "stabilityai/stable-diffusion-2-1-base",
                 "Meina/MeinaMix_V11"):
        (tmp_path / repo.split("/")[1]).mkdir()
    (tmp_path / "gsdf--Counterfeit-V2.5").mkdir()
    assert m.register_zoo(str(tmp_path)) == j.register_zoo(str(tmp_path))
    assert len(m._dirs) == 4
    for name, (path, cfg) in m._dirs.items():
        jpath, jc = j._dirs[name]
        assert path == jpath and cfg.name == jc.name
    assert m._dirs["Stable Diffusion v2.1"][1].name == "sd21"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tapi.ModelManager()


def test_warmup_runs_each_config_once(manager):
    configs = [c for c in tapi.default_warmup_configs("tiny", steps=2)]
    jconfigs = japi.default_warmup_configs("tiny", steps=2)
    assert len(configs) == len(jconfigs) == 8
    for c, jc in zip(configs, jconfigs):
        assert _summ(c) == _summ(jc)
    small = [dict(c, width=64, height=64, dtype=torch.float32,
                  region_state=None if "region_state" not in c else
                  {"warmup": dict(c["region_state"]["warmup"],
                                  mask=c["region_state"]["warmup"]["mask"][
                                      ::8, ::8])})
             for c in configs[:2]]
    with chip_smoke.UNetCalls() as n:
        out = tapi.warmup(manager, small)
    assert n.n == 4
    assert [r["config"]["model"] for r in out] == ["tiny", "tiny"]
    assert all(r["seconds"] > 0 for r in out)
