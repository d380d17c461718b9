"""Top-level API: model management and the ``inference`` entry point (port of
``app/api.py``).

``ModelManager`` holds the parameter trees per registered checkpoint on its
device; ``inference()`` takes the app's whole parameter surface (prompt and
negative, model, sampler name of the app's table, steps, CFG, size, seeds,
region-map state, img2img / inpaint, hires fix, clip-skip, prompt mode,
latent previews, the timeout watchdog, chunked and cancellable runs,
multi-prompt grids) and routes it to ``StableDiffusionTorch`` as the JAX
package routes it to ``StableDiffusionTPU``, with every check in the same
order, so that a request the JAX package refuses gets the same error here.

Not ported yet, and raising ``NotImplementedError`` that names the
ROADMAP item where the JAX package would first use them: ControlNet and
T2I-Adapter units (item 15), IP-Adapter units, the CLIP-vision encoder and
the face models (item 16), loading checkpoints, LoRAs and textual-inversion
embeddings (item 17), the speed modes cfg-tail, DeepCache, bottleneck and
TGATE (item 18) and the control preprocessors (item 20). The unit
dataclasses are ported as data, so that the server parses them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import registry
from ..config import (
    DEFAULT_NEGATIVE_PROMPT,
    GenerationConfig,
    ModelConfig,
    sd15_config,
    sd21_config,
)
from ..device import resolve_device
from ..models import factory
from ..pipeline.pipeline import StableDiffusionTorch
from ..text.tokenizer import load_tokenizer
from ..utils.profiling import PhaseTimer, Watchdog

_UNITS = "ControlNet and T2I-Adapter units (ROADMAP item 15)"
_IP = "IP-Adapter (ROADMAP item 16)"
_LOADING = ("loading checkpoints, LoRAs and textual-inversion embeddings "
            "(ROADMAP item 17)")
_PREPROCESSORS = "the control preprocessors (ROADMAP item 20)"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: not ported to the PyTorch package "
                               f"yet")


@dataclasses.dataclass
class ControlNetUnit:
    """One ControlNet unit (reference multi-unit editor,
    source/app.py:924-997). Data only until ROADMAP item 15."""

    model: str  # name in registry.CONTROLNET_MODELS or a path
    image: np.ndarray  # (H, W, 3) conditioning image in [0, 1]
    scale: float = 1.0
    guidance_start: float = 0.0
    guidance_end: float = 1.0
    guess_mode: bool = False
    preprocessor: Optional[str] = None
    preprocessor_options: Optional[dict] = None


@dataclasses.dataclass
class T2IAdapterUnit:
    """One T2I-Adapter unit (reference multi-unit editor,
    source/app.py:654-700, 989-997). Data only until ROADMAP item 15."""

    model: str  # name in registry.T2I_ADAPTER_MODELS or a weight path
    image: np.ndarray  # (H, W, 3) conditioning image in [0, 1]
    scale: float = 1.0
    preprocessor: Optional[str] = None
    preprocessor_options: Optional[dict] = None
    conditioning_factor: float = 1.0  # residuals active while
    # step < steps*factor (reference: model_k_diffusion.py:1110-1117)


@dataclasses.dataclass
class IPAdapterUnit:
    """One IP-Adapter unit (reference: app.py:1021-1096): a reference
    ``image`` or precomputed ``image_embeds``. Data only until ROADMAP
    item 16."""

    model: str  # variant name in registry.IP_ADAPTER_MODELS or a path
    image: Optional[np.ndarray] = None  # (H, W, 3) reference image
    image_embeds: Optional[np.ndarray] = None  # precomputed embeds
    scale: float = 1.0
    mask: Optional[np.ndarray] = None  # (H, W) spatial gate, 1 = active
    invert_mask: bool = False  # use 1 - mask
    uncond_image_embeds: Optional[np.ndarray] = None
    face_embedder: Optional[Any] = None


class ModelManager:
    """Checkpoint registry and caches (reference: model zoo and per-model
    component caches, app.py:111-167, 263-340).

    ``device`` defaults to CUDA and raises when there is none (CPU runs
    pass ``device="cpu"``); the parameters live there. ``attn_impl`` and
    ``conv_impl`` go to every ``StableDiffusionTorch`` the manager's
    requests build."""

    def __init__(self, dtype=torch.bfloat16,
                 device: Optional[Union[str, torch.device]] = None,
                 attn_impl: str = "pallas", conv_impl: Optional[str] = None):
        self.dtype = dtype
        self.device = resolve_device(device)
        self.attn_impl = attn_impl
        self.conv_impl = conv_impl
        self._dirs: Dict[str, Tuple[str, ModelConfig]] = {}
        self._cache: Dict[str, Dict[str, Any]] = {}
        self._tokenizers: Dict[str, Any] = {}

    def register(self, name: str, path: str,
                 model_cfg: Optional[ModelConfig] = None):
        self._dirs[name] = (path, model_cfg or sd15_config())

    def register_zoo(self, root: str):
        """Register every reference-zoo checkpoint found under ``root``
        (one subdirectory per HF repo id's basename), with the SD2.x preset
        where the zoo requires it (registry.SD2_MODELS)."""
        import os

        registered = []
        for display, repo_id in registry.MODEL_ZOO:
            path = os.path.join(root, repo_id.replace("/", "--"))
            if not os.path.isdir(path):
                path = os.path.join(root, os.path.basename(repo_id))
            if os.path.isdir(path):
                cfg = (
                    sd21_config() if repo_id in registry.SD2_MODELS
                    else sd15_config()
                )
                self.register(display, path, cfg)
                registered.append(display)
        return registered

    def register_random(self, name: str,
                        model_cfg: Optional[ModelConfig] = None, seed=0):
        """Random-init model on the manager's device (tests and runs
        without weights)."""
        cfg = model_cfg or sd15_config()
        self._dirs[name] = ("", cfg)
        self._cache[name] = factory.init_pipeline_params(
            seed, cfg, self.dtype, device=self.device
        )
        self._tokenizers[name] = load_tokenizer()

    def get(self, name: str):
        if name not in self._dirs:
            raise KeyError(f"model {name!r} not registered")
        cfg = self._dirs[name][1]
        if name not in self._cache:
            raise _not_ported(_LOADING)
        return cfg, self._cache[name], self._tokenizers[name]

    def get_variant(self, name: str, loras: Sequence = (),
                    ti_embeddings: Sequence[str] = ()):
        """(cfg, params, tokenizer); LoRA merges and textual-inversion
        embeddings (the JAX package caches a variant per combination) wait
        for ROADMAP item 17."""
        cfg, base_params, base_tok = self.get(name)
        if list(loras) or list(ti_embeddings):
            raise _not_ported(_LOADING)
        return cfg, base_params, base_tok

    def get_controlnet(self, name_or_path: str, unet_cfg):
        raise _not_ported(_UNITS)

    def get_t2i_adapter(self, name_or_path: str, unet_cfg=None):
        raise _not_ported(_UNITS)

    def get_ip_adapter_state(self, name_or_path: str, unet_cfg):
        raise _not_ported(_IP)

    def register_face_embedder(self, path: Optional[str] = None, cfg=None):
        raise _not_ported(_IP)

    def get_face_embedder(self):
        raise _not_ported(_IP)

    def register_face_detector(self, path: Optional[str] = None, cfg=None,
                               top1_fallback: bool = False):
        raise _not_ported(_IP)

    def get_face_aligner(self):
        raise _not_ported(_IP)

    def register_preprocessor(self, name: str, path: Optional[str] = None,
                              cfg=None, detect_resolution: int = 368):
        raise _not_ported(_PREPROCESSORS)

    def get_preprocessor(self, name: str):
        raise _not_ported(_PREPROCESSORS)

    def register_image_encoder(self, path: Optional[str] = None, cfg=None):
        raise _not_ported(_IP)

    def get_image_encoder(self):
        raise _not_ported(_IP)


def _to_host_u8(images) -> np.ndarray:
    """Images on the device -> (B, H, W, 3) uint8 numpy on the host."""
    return StableDiffusionTorch.to_uint8(images).cpu().numpy()


def inference(
    manager: ModelManager,
    prompt: str,
    model: str,
    neg_prompt: str = DEFAULT_NEGATIVE_PROMPT,
    sampler: str = registry.DEFAULT_SAMPLER,
    steps: int = 25,
    cfg_scale: float = 7.5,
    width: int = 512,
    height: int = 512,
    seed: int = 0,
    num_images_per_prompt: int = 1,
    clip_skip: int = 2,
    encoding_mode: str = "a1111",
    guidance_rescale: float = 0.0,
    eta: float = 1.0,
    # region control
    region_state: Optional[Dict[str, Dict]] = None,
    # img2img / inpaint
    init_image: Optional[np.ndarray] = None,  # (H, W, 3) uint8 or [-1,1]
    strength: float = 0.8,
    inpaint_mask: Optional[np.ndarray] = None,  # (H, W) 1 = regenerate
    invert_mask: bool = False,  # regenerate where mask==0 instead
    # hires fix
    hires_scale: float = 0.0,
    hires_strength: float = 0.6,
    hires_mode: str = "Latent (bilinear)",
    hires_steps: Optional[int] = None,
    hires_sampler: Optional[str] = None,  # sampler for the hires pass only
    hires_region: bool = True,  # region control in the hires pass (the
    # map is re-encoded at the target size)
    # conditioning units (ROADMAP items 15-16)
    controlnet_units: Sequence[ControlNetUnit] = (),
    t2i_units: Sequence[T2IAdapterUnit] = (),
    ip_adapter_units: Sequence[IPAdapterUnit] = (),
    # model variants (ROADMAP item 17)
    loras: Sequence = (),  # paths or (path, scale) pairs
    ti_embeddings: Sequence[str] = (),
    # extras
    latent_preview: bool = False,  # or "base"/"hires"/"both": which
    # pass's per-step decodes to return with hires on; True = "both"
    timeout: float = registry.INFERENCE_TIMEOUT_S,
    cancel_check_steps: Optional[int] = None,
    # the speed modes (ROADMAP item 18)
    cfg_tail_frac: float = 0.0,
    deepcache_interval: int = 0,
    bottleneck_low_scale: float = 0.0,
    tgate_gate_frac: float = 0.0,
    progress_cb=None,  # fn(steps_done, steps_total); may raise to cancel.
    # Only ticks on the chunked path (cancel_check_steps set, plain
    # txt2img).
    dtype=torch.bfloat16,
):
    """Generate images. Returns a dict with ``images`` (B, H, W, 3) uint8
    numpy on the host, ``timings`` (a JSON string) and, with
    ``latent_preview``, ``previews``.

    Multi-prompt batch: ``prompt`` may be a list of prompts with
    ``region_state`` a parallel list of per-prompt region dicts (or None);
    every prompt is generated for each seed (``seed`` list, or
    ``num_images_per_prompt`` consecutive seeds), prompt-major. txt2img or
    img2img only (no inpaint, hires or preview in grid mode)."""
    # Validate latent_preview up front: a bad value must not surface only
    # after a full sampling run (and 'hires' previews need a hires pass).
    if not isinstance(latent_preview, bool):
        if latent_preview not in ("base", "hires", "both"):
            raise ValueError(
                f"latent_preview must be bool or 'base'/'hires'/'both', "
                f"got {latent_preview!r}"
            )
        if latent_preview == "hires" and not (hires_scale
                                              and hires_scale > 1.0):
            raise ValueError(
                "latent_preview='hires' requires hires upscaling "
                "(hires_scale > 1)"
            )

    timer = PhaseTimer()
    watchdog = Watchdog(timeout)

    model_cfg, params, tokenizer = manager.get_variant(
        model, loras=loras, ti_embeddings=ti_embeddings
    )

    grid_prompts = grid_states = grid_seeds = None
    if isinstance(prompt, (list, tuple)) and len(prompt) > 1:
        # init_image may be one image or a per-prompt list (batched
        # img2img); inpaint, hires and preview stay single-prompt.
        if (hires_scale and hires_scale > 1.0) or latent_preview:
            raise ValueError(
                "multi-prompt batch supports txt2img/img2img (with "
                "optional conditioning units) only — no hires / preview"
            )
        if inpaint_mask is not None:
            raise ValueError(
                "multi-prompt batch does not support inpainting"
            )
        grid_prompts = list(prompt)
        grid_states = (
            list(region_state)
            if isinstance(region_state, (list, tuple))
            else [region_state] * len(grid_prompts)
        )
        if len(grid_states) != len(grid_prompts):
            raise ValueError(
                f"{len(grid_states)} region states for "
                f"{len(grid_prompts)} prompts"
            )
        grid_seeds = (
            [int(s) for s in seed]
            if isinstance(seed, (list, tuple, np.ndarray))
            else [int(seed) + i for i in range(num_images_per_prompt)]
        )
    elif isinstance(prompt, (list, tuple)):
        prompt = prompt[0]
    if grid_prompts is None and isinstance(region_state, (list, tuple)):
        region_state = region_state[0]
    if grid_prompts is None and isinstance(init_image, (list, tuple)):
        init_image = init_image[0]

    if ip_adapter_units:
        raise _not_ported(_IP)

    pipe = StableDiffusionTorch(
        model_cfg, params, tokenizer=tokenizer, attn_impl=manager.attn_impl,
        conv_impl=manager.conv_impl, device=manager.device,
    )

    spec = registry.resolve_sampler(sampler)
    gen = GenerationConfig(
        height=height,
        width=width,
        num_inference_steps=steps,
        guidance_scale=cfg_scale,
        guidance_rescale=guidance_rescale,
        sampler=spec.solver,
        schedule=spec.schedule,
        eta=eta,
        num_images_per_prompt=num_images_per_prompt,
        clip_skip=clip_skip,
        dtype=dtype,
    )

    if grid_prompts is None:
        with timer.phase("encode"):
            context, ids = pipe.encode_prompt(
                [prompt], [neg_prompt], clip_skip=clip_skip,
                mode=encoding_mode,
                num_images_per_prompt=num_images_per_prompt,
            )
            if cfg_scale <= 1.0:
                # no CFG pair: keep only the cond half (reference skips
                # the uncond pass when guidance is off)
                context = context[context.shape[0] // 2:]
            region_biases = None
            if region_state:
                region_biases = pipe.encode_region(
                    [region_state], ids, height=height, width=width,
                    num_images_per_prompt=num_images_per_prompt,
                    do_cfg=cfg_scale > 1.0,
                )
        watchdog.check()

    extras = None
    with timer.phase("conditioning"):
        if controlnet_units or t2i_units:
            raise _not_ported(_UNITS)
    watchdog.check()

    if grid_prompts is not None:
        from ..parallel.batched import generate_grid

        if ((cfg_tail_frac and cfg_tail_frac > 0.0)
                or (deepcache_interval and deepcache_interval > 1)
                or (bottleneck_low_scale
                    and 0.0 < bottleneck_low_scale < 1.0)):
            raise ValueError(
                "cfg_tail_frac / deepcache_interval / bottleneck_low_scale "
                "do not combine with multi-prompt grid mode"
            )
        grid_inits = None
        if init_image is not None:
            inits = (
                list(init_image)
                if isinstance(init_image, (list, tuple))
                else [init_image] * len(grid_prompts)
            )
            if len(inits) != len(grid_prompts):
                raise ValueError(
                    f"{len(inits)} init images for "
                    f"{len(grid_prompts)} prompts"
                )
            grid_inits = [torch.from_numpy(_to_pm1(im)) for im in inits]
        with timer.phase("sample"):
            out = generate_grid(
                pipe, grid_prompts, grid_seeds, gen,
                negative_prompt=neg_prompt, region_states=grid_states,
                mesh="auto", encoding_mode=encoding_mode, extras=extras,
                init_images=grid_inits, strength=strength,
            )
        watchdog.check()
        with timer.phase("to_host"):
            images = _to_host_u8(out)
        return {
            "images": images,
            "timings": timer.summary(model=model, sampler=sampler,
                                     steps=steps),
        }

    hires = None
    if hires_scale and hires_scale > 1.0:
        from ..ops.resize import parse_upscale_mode

        mode, antialias = parse_upscale_mode(hires_mode)
        hires = {
            "scale": hires_scale,
            "strength": hires_strength,
            "mode": mode,
            "antialias": antialias,
            "steps": hires_steps,
        }
        if hires_sampler:
            spec_hr = registry.resolve_sampler(hires_sampler)
            hires["sampler"] = spec_hr.solver
            hires["schedule"] = spec_hr.schedule
        if region_state and hires_region:
            hires["region_state"] = (
                [region_state], ids, num_images_per_prompt
            )

    batch = num_images_per_prompt
    turbo_modes = {
        "cfg_tail_frac": bool(cfg_tail_frac and cfg_tail_frac > 0.0),
        "deepcache_interval": bool(deepcache_interval
                                   and deepcache_interval > 1),
        "bottleneck_low_scale": bool(bottleneck_low_scale
                                     and 0.0 < bottleneck_low_scale < 1.0),
        "tgate_gate_frac": bool(tgate_gate_frac
                                and 0.0 < tgate_gate_frac < 1.0),
    }
    if init_image is not None and any(turbo_modes.values()):
        # the speed modes are txt2img-only
        on = [k for k, v in turbo_modes.items() if v]
        raise ValueError(
            f"{', '.join(on)} do(es) not combine with init_image "
            f"(img2img / inpaint)"
        )
    if sum(turbo_modes.values()) > 1:
        on = [k for k, v in turbo_modes.items() if v]
        raise ValueError(
            f"at most one acceleration mode at a time, got: {', '.join(on)}"
        )
    with timer.phase("sample"):
        if init_image is not None and inpaint_mask is not None:
            img = _to_pm1(init_image)[None]
            mask = np.asarray(inpaint_mask, np.float32)
            if invert_mask:
                # reference: ImageOps.invert on the uploaded mask when
                # "Black areas are used" is checked (app.py:921)
                mask = 1.0 - mask
            out = pipe.inpaint(
                context, torch.from_numpy(img),
                torch.from_numpy(np.ascontiguousarray(mask[None])), gen,
                strength=strength, seed=seed, region_biases=region_biases,
                extras=extras, return_history=latent_preview,
            )
        elif init_image is not None:
            img = _to_pm1(init_image)[None]
            latents = pipe.encode_image(torch.from_numpy(img), seed=seed)
            out = pipe.img2img(
                context, latents, gen, strength=strength, seed=seed,
                region_biases=region_biases, extras=extras,
                return_history=latent_preview,
            )
        elif cancel_check_steps and hires is None and not latent_preview:
            # the watchdog checks between chunks, and progress_cb (the job
            # queue's hook) ticks there and may raise to cancel; the
            # result is bitwise that of the plain path
            if cfg_tail_frac and cfg_tail_frac > 0.0:
                raise ValueError(
                    "cfg_tail_frac does not combine with cancel_check_steps"
                )
            if deepcache_interval and deepcache_interval > 1:
                raise ValueError(
                    "deepcache_interval does not combine with "
                    "cancel_check_steps"
                )
            if turbo_modes["bottleneck_low_scale"]:
                raise ValueError(
                    "bottleneck_low_scale does not combine with "
                    "cancel_check_steps"
                )
            if turbo_modes["tgate_gate_frac"]:
                raise ValueError(
                    "tgate_gate_frac does not combine with "
                    "cancel_check_steps"
                )

            def _tick(done, total):
                watchdog.check()
                if progress_cb is not None:
                    progress_cb(done, total)

            out = pipe.sample_chunked(
                context, gen, seed=seed, region_biases=region_biases,
                batch_size=batch, extras=extras,
                chunk_steps=cancel_check_steps,
                on_chunk=_tick,
                uint8_output=True,
            )
        elif bottleneck_low_scale and 0.0 < bottleneck_low_scale < 1.0:
            if hires is not None or latent_preview:
                raise ValueError(
                    "bottleneck_low_scale does not combine with hires or "
                    "latent_preview"
                )
            if (cfg_tail_frac and cfg_tail_frac > 0.0) or (
                    deepcache_interval and deepcache_interval > 1):
                raise ValueError(
                    "bottleneck_low_scale does not combine with "
                    "cfg_tail_frac or deepcache_interval"
                )
            raise _not_ported("bottleneck sampling (ROADMAP item 18)")
        elif deepcache_interval and deepcache_interval > 1:
            if hires is not None or latent_preview:
                raise ValueError(
                    "deepcache_interval does not combine with hires or "
                    "latent_preview"
                )
            if cfg_tail_frac and cfg_tail_frac > 0.0:
                raise ValueError(
                    "deepcache_interval does not combine with cfg_tail_frac"
                )
            raise _not_ported("DeepCache (ROADMAP item 18)")
        elif turbo_modes["tgate_gate_frac"]:
            if hires is not None or latent_preview:
                raise ValueError(
                    "tgate_gate_frac does not combine with hires or "
                    "latent_preview"
                )
            raise _not_ported("TGATE (ROADMAP item 18)")
        elif cfg_tail_frac and cfg_tail_frac > 0.0:
            if hires is not None or latent_preview:
                raise ValueError(
                    "cfg_tail_frac does not combine with hires or "
                    "latent_preview"
                )
            raise _not_ported("cfg-tail sampling (ROADMAP item 18)")
        else:
            out = pipe.txt2img(
                context, gen, seed=seed, region_biases=region_biases,
                batch_size=batch, extras=extras, hires=hires,
                return_history=latent_preview,
                uint8_output=not latent_preview,
            )
        previews = None
        if latent_preview and isinstance(out, tuple):
            # the history is one (steps, B, h, w, 4) tensor, or a list of
            # two when hires ran (base pass, then hires pass)
            out, history = out
            hists = history if isinstance(history, list) else [history]
            mode = (latent_preview if isinstance(latent_preview, str)
                    else "both")
            if len(hists) == 2 and mode != "both":
                hists = hists[:1] if mode == "base" else hists[1:]
            with timer.phase("preview_decode"):
                previews = [
                    _to_host_u8(pipe.decode_latents(hist[i]))
                    for hist in hists
                    for i in range(hist.shape[0])
                ]
    watchdog.check()

    with timer.phase("to_host"):
        images = _to_host_u8(out)

    result = {
        "images": images,
        "timings": timer.summary(model=model, sampler=sampler, steps=steps),
    }
    if latent_preview and previews is not None:
        result["previews"] = previews
    return result


def default_warmup_configs(model: str, *, steps: int = 25,
                           sampler: str = registry.DEFAULT_SAMPLER):
    """The common serving shape buckets: 512² and 768², batch 1 and 4,
    each with and without a region map."""
    configs = []
    for size in (512, 768):
        for batch in (1, 4):
            for region in (False, True):
                cfg = {
                    "model": model, "sampler": sampler, "steps": steps,
                    "width": size, "height": size,
                    "num_images_per_prompt": batch,
                }
                if region:
                    mask = np.zeros((size, size), np.float32)
                    mask[:, : size // 2] = 1.0
                    cfg["region_state"] = {
                        "warmup": {"mask": mask, "weight": 0.5,
                                   "mask_outsides": 0.0}
                    }
                configs.append(cfg)
    return configs


def warmup(manager: ModelManager, configs) -> list:
    """Run each ``inference()`` config once and discard the images.

    On the card the first request of a shape pays one-time costs: the
    kernels' first-use build (nvcc) and load, and cuDNN's and cuBLAS's
    choices for the convs and matmuls of that shape. A serving deployment
    calls this once at startup with its shape buckets (or
    :func:`default_warmup_configs`). ``prompt`` and ``seed`` default to a
    fixed warm-up value. Returns one ``{"seconds": float, "config": <echo
    of the scalar settings>}`` per config, in order."""
    results = []
    for cfg in configs:
        cfg = dict(cfg)
        cfg.setdefault("prompt", "warmup")
        cfg.setdefault("seed", 0)
        t0 = time.perf_counter()
        inference(manager, **cfg)
        seconds = time.perf_counter() - t0
        results.append({
            "seconds": round(seconds, 3),
            "config": {
                k: v for k, v in cfg.items()
                if isinstance(v, (str, int, float, bool))
            },
        })
    return results


def _to_pm1(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 127.5 - 1.0
    return img.astype(np.float32)
