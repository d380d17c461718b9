"""Top-level API: model management and the ``inference`` entry point (port of
``app/api.py``).

``ModelManager`` holds the parameter trees per registered checkpoint on its
device; ``inference()`` takes the app's whole parameter surface (prompt and
negative, model, sampler name of the app's table, steps, CFG, size, seeds,
region-map state, img2img / inpaint, hires fix, clip-skip, prompt mode,
latent previews, the timeout watchdog, chunked and cancellable runs,
multi-prompt grids, ControlNet, T2I-Adapter and IP-Adapter units, the
opt-in speed modes cfg-tail, DeepCache, bottleneck sampling and TGATE) and
routes it to
``StableDiffusionTorch`` as the JAX package routes it to
``StableDiffusionTPU``, with every check in the same order, so that a
request the JAX package refuses gets the same error here.

Registered checkpoint directories (diffusers layout), LoRAs,
textual-inversion embeddings and the weight files of units, the image
tower, the face networks and the control preprocessors are converted by
``convert/`` and the models' converters onto the manager's device. A unit's
model name that is not an existing path gets random weights from the
port's own generator (seed 0): a ControlNet with zero heads (a no-op, as in
the JAX package) and a random T2I-Adapter (other values than the JAX
package's ``PRNGKey(0)`` init). An IP-Adapter name gets the JAX package's
own synthetic state dict (``ip_adapter.random_state_dict``, numpy, the
same weights); the CLIP-vision tower and the face networks (when
registered without a path) random weights from the port's generator. A
control preprocessor without weights draws its published-layout state dict
from its model's ``random_state_dict`` (seed 0), so its values differ from
the JAX package's ``PRNGKey(0)`` init; its networks run in fp32 on the
manager's device whatever the manager's dtype, as the JAX package builds
them in ``jnp.float32``, with the card's convolutions and matmuls off TF32
and on deterministic algorithms whatever the process-wide settings
(``models._nets.strict_fp32``).

On a data-parallel mesh (``ModelManager(mesh=...)``, one process a rank
under ``torchrun``) a grid request on rank 0 runs on every rank: rank 0
decides, as the JAX package sends grids to ``generate_grid(mesh="auto")``,
and hands the request's keyword arguments to the other ranks, which run the
same ``inference()`` call in ``follow_requests``; before sampling every
rank reports whether it is ready, so a rank's error reaches rank 0, which
raises it. A rank that fails during sampling is out of step and leaves the
mesh; rank 0 raises that request's error and runs every later grid alone.
Other requests run on rank 0 alone, with no collective.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import os
import time
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import registry
from ..config import (
    DEFAULT_NEGATIVE_PROMPT,
    GenerationConfig,
    ModelConfig,
    T2IAdapterConfig,
    sd15_config,
    sd21_config,
)
from ..convert import lora as lora_mod
from ..convert.hf import (
    convert_clip_vision,
    convert_controlnet,
    convert_t2i_adapter,
    load_pipeline_params,
    load_state_dict,
)
from ..convert.textual_inversion import add_embeddings, load_embedding_file
from ..device import resolve_device
from ..models import factory
from ..models import ip_adapter as ipa
from ..models.controlnet import controlnet_init
from ..models.t2i_adapter import t2i_adapter_init
from ..ops.resize import resize_latents
from ..parallel.mesh import RankError
from ..pipeline.pipeline import DenoiseExtras, StableDiffusionTorch, on_device
from ..text.tokenizer import load_tokenizer
from ..utils.profiling import PhaseTimer, Watchdog

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class ControlNetUnit:
    """One ControlNet unit (reference multi-unit editor,
    source/app.py:924-997)."""

    model: str  # name in registry.CONTROLNET_MODELS or a path
    image: np.ndarray  # (H, W, 3) conditioning image in [0, 1]
    scale: float = 1.0
    guidance_start: float = 0.0
    guidance_end: float = 1.0
    guess_mode: bool = False
    # a detector applied to ``image`` first, with its options
    preprocessor: Optional[str] = None
    preprocessor_options: Optional[dict] = None


@dataclasses.dataclass
class T2IAdapterUnit:
    """One T2I-Adapter unit (reference multi-unit editor,
    source/app.py:654-700, 989-997)."""

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
    ``image`` (embedded by the registered CLIP-vision tower, or for FaceID
    by the face embedder, after the face detector when one is registered)
    or precomputed ``image_embeds``."""

    model: str  # variant name in registry.IP_ADAPTER_MODELS or a path
    image: Optional[np.ndarray] = None  # (H, W, 3) reference image
    image_embeds: Optional[np.ndarray] = None  # precomputed embeds
    scale: float = 1.0
    mask: Optional[np.ndarray] = None  # (H, W) spatial gate, 1 = active
    invert_mask: bool = False  # use 1 - mask
    uncond_image_embeds: Optional[np.ndarray] = None
    face_embedder: Optional[Any] = None  # a callable crop -> (512,) in
    # place of the manager's embedder


class ModelManager:
    """Checkpoint registry and caches (reference: model zoo and per-model
    component caches, app.py:111-167, 263-340).

    ``device`` defaults to CUDA and raises when there is none (CPU runs
    pass ``device="cpu"``); the parameters live there. ``attn_impl`` and
    ``conv_impl`` go to every ``StableDiffusionTorch`` the manager's
    requests build. ``mesh`` (``parallel.mesh.Mesh``): the data-parallel
    mesh its grid requests run on (the device defaults to the mesh's); every
    rank has its own manager with the same models."""

    def __init__(self, dtype=torch.bfloat16,
                 device: Optional[Union[str, torch.device]] = None,
                 attn_impl: str = "pallas", conv_impl: Optional[str] = None,
                 mesh=None):
        self.dtype = dtype
        self.mesh = mesh
        self.device = resolve_device(
            mesh.device if device is None and mesh is not None else device)
        self.attn_impl = attn_impl
        self.conv_impl = conv_impl
        self._dirs: Dict[str, Tuple[str, ModelConfig]] = {}
        self._cache: Dict[str, Dict[str, Any]] = {}
        self._tokenizers: Dict[str, Any] = {}
        self._controlnets: Dict[str, Dict[str, Any]] = {}
        self._adapters: Dict[str, Dict[str, Any]] = {}
        # the IP-Adapter networks' configs and weight paths, None until
        # registered
        self._face_cfg = self._detector_spec = self._image_encoder_cfg = None
        self._face_path = self._image_encoder_path = None
        self._preproc_spec: Dict[str, Tuple] = {}

    def register(self, name: str, path: str,
                 model_cfg: Optional[ModelConfig] = None):
        self._dirs[name] = (path, model_cfg or sd15_config())

    def register_zoo(self, root: str):
        """Register every reference-zoo checkpoint found under ``root``
        (one subdirectory per HF repo id's basename), with the SD2.x preset
        where the zoo requires it (registry.SD2_MODELS)."""
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
        """(cfg, params, tokenizer) of a registered model; a checkpoint
        directory is converted onto the manager's device at its first use,
        with 64 spare rows in the token-embedding table for textual
        inversion, and its ``tokenizer/`` read (the hash tokenizer when it
        has no vocab files)."""
        if name not in self._dirs:
            raise KeyError(f"model {name!r} not registered")
        path, cfg = self._dirs[name]
        if name not in self._cache:
            self._cache[name] = load_pipeline_params(
                path, cfg, self.dtype, n_extra_tokens=64, device=self.device)
            self._tokenizers[name] = load_tokenizer(
                os.path.join(path, "tokenizer"))
        return cfg, self._cache[name], self._tokenizers[name]

    def get_variant(self, name: str, loras: Sequence = (),
                    ti_embeddings: Sequence[str] = ()):
        """(cfg, params, tokenizer) with LoRA merges and textual-inversion
        embeddings applied, cached per combination (reference:
        load_lora_control_pipeline app.py:532-597 merges into weights;
        add_embedding app.py:759-785 injects TI tokens). ``loras``: paths
        or (path, scale) pairs. The base tree and tokenizer stay as they
        were: a variant is a copy of the tree's containers whose merged
        kernels and embedding table are new tensors."""
        cfg, base_params, base_tok = self.get(name)
        loras = [
            (p, 1.0) if isinstance(p, str) else (p[0], float(p[1]))
            for p in loras
        ]
        ti_embeddings = list(ti_embeddings)
        if not loras and not ti_embeddings:
            return cfg, base_params, base_tok
        key = (
            "variant", name,
            tuple((str(p), s) for p, s in loras),
            tuple(map(str, ti_embeddings)),
        )
        if key not in self._adapters:
            params = ipa.copy_tree_containers(base_params)
            for path, scale in loras:
                lora_mod.merge_lora(
                    params, load_state_dict(path).tensors, scale=scale)
            tok = base_tok
            if ti_embeddings:
                embs: Dict[str, np.ndarray] = {}
                for path in ti_embeddings:
                    for k, v in load_embedding_file(path).items():
                        # A1111 .pt files name the vector '*': the trigger
                        # word is the file stem (reference: add_embedding,
                        # app.py:759-785)
                        nm = (os.path.splitext(os.path.basename(path))[0]
                              if k == "*" else k)
                        embs[nm] = v
                clip = dict(params["clip"])
                table = clip["token_embedding"]
                need = cfg.clip.vocab_size + sum(
                    np.atleast_2d(v).shape[0] for v in embs.values())
                if table.shape[0] < need:
                    # a random model's table has no spare rows
                    clip["token_embedding"] = torch.cat([
                        table, table.new_zeros((need - table.shape[0],
                                                table.shape[1]))])
                clip, tok = add_embeddings(clip, tok, embs,
                                           cfg.clip.vocab_size)
                params["clip"] = clip
            self._adapters[key] = (params, tok)
        params, tok = self._adapters[key]
        return cfg, params, tok

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(0)

    def get_controlnet(self, name_or_path: str, unet_cfg):
        """ControlNet parameters for a unit, cached by name: converted from
        a weight path (a file or a diffusers directory), or for another name
        a random trunk with zero heads (a no-op)."""
        if name_or_path not in self._controlnets:
            if os.path.exists(name_or_path):
                cn = convert_controlnet(load_state_dict(name_or_path),
                                        unet_cfg, self.dtype, self.device)
            else:
                cn = controlnet_init(self._generator(), unet_cfg,
                                     dtype=self.dtype, device=self.device)
            self._controlnets[name_or_path] = cn
        return self._controlnets[name_or_path]

    def get_t2i_adapter(self, name_or_path: str, unet_cfg=None):
        """T2I-Adapter parameters for a unit, cached by name: converted
        from a weight path, or for another name random, with the UNet's
        level widths (the SD1.5 adapter without ``unet_cfg``)."""
        if name_or_path not in self._adapters:
            if os.path.exists(name_or_path):
                ad = convert_t2i_adapter(load_state_dict(name_or_path),
                                         self.dtype, self.device)
            else:
                cfg = (T2IAdapterConfig(channels=unet_cfg.block_out_channels)
                       if unet_cfg is not None else T2IAdapterConfig())
                ad = t2i_adapter_init(self._generator(), cfg,
                                      dtype=self.dtype, device=self.device)
            self._adapters[name_or_path] = ad
        return self._adapters[name_or_path]

    _IP_VARIANTS = {
        "IP-Adapter": "linear",
        "IP-Adapter Light": "linear",
        "IP-Adapter Face": "mlp",
        "IP-Adapter FaceID": "faceid",
        "IP-Adapter Plus": "resampler",
        "IP-Adapter Plus Face": "resampler",
    }

    def get_ip_adapter_state(self, name_or_path: str, unet_cfg):
        """The {image_proj, ip_adapter} numpy state dict of one adapter,
        cached: read from a weight file, or for another name the JAX
        package's synthetic weights of its variant (the base layout for an
        unknown name), with the image tower's widths."""
        key = f"ip::{name_or_path}"
        if key not in self._adapters:
            if os.path.isfile(name_or_path):
                self._adapters[key] = ipa.load_ip_adapter_file(name_or_path)
            else:
                variant = self._IP_VARIANTS.get(name_or_path, "linear")
                enc_cfg, _ = self.get_image_encoder()
                embed_dim = (enc_cfg.hidden_size if variant == "resampler"
                             else enc_cfg.projection_dim)
                self._adapters[key] = ipa.random_state_dict(
                    unet_cfg, variant, seed=0, embed_dim=embed_dim)
        return self._adapters[key]

    def register_face_embedder(self, path: Optional[str] = None, cfg=None):
        """The FaceID identity embedder: an ArcFace iResNet
        (``models/arcface.py``) at ``cfg`` (the full iResNet-50 by default),
        fp32 on the manager's device, converted from an ``arcface_torch``
        ``backbone.pth`` at ``path`` (the insightface buffalo_l recognition
        weights' torch layout) or with random weights. Without a
        registration the deterministic stub (``ops/face_embed.py``)
        embeds."""
        from ..models.arcface import ArcFaceConfig

        self._face_path = path
        self._face_cfg = cfg or ArcFaceConfig()
        self._adapters.pop("face_embedder", None)

    def get_face_embedder(self):
        """Callable (H, W, 3) face crop -> (512,) L2-normalized embedding
        (insightface's ``normed_embedding`` contract)."""
        if "face_embedder" in self._adapters:
            return self._adapters["face_embedder"]
        if self._face_cfg is None:
            from ..ops.face_embed import embed_face

            return embed_face
        from ..models.arcface import (
            arcface_init,
            convert_arcface,
            make_arcface_embedder,
        )

        if self._face_path:
            params = convert_arcface(load_state_dict(self._face_path).arrays(),
                                     self._face_cfg, torch.float32,
                                     self.device)
        else:
            params = arcface_init(self._generator(), self._face_cfg,
                                  torch.float32, self.device)
        fn = make_arcface_embedder(params, self._face_cfg)
        self._adapters["face_embedder"] = fn
        return fn

    def register_face_detector(self, path: Optional[str] = None, cfg=None,
                               top1_fallback: bool = False):
        """The FaceID face detector and aligner: an SCRFD-class network
        (``models/face_detect.py``) at ``cfg`` (its 640^2 default), fp32 on
        the manager's device, converted from an insightface ``scrfd`` torch
        checkpoint at ``path`` or with random weights. Once registered,
        FaceID units detect, align and then embed the raw photo; without
        one the image is taken as an aligned crop. ``top1_fallback``: the
        best anchor when none clears the threshold (random weights detect
        nothing)."""
        from ..models.face_detect import FaceDetectConfig

        self._detector_spec = (path, cfg or FaceDetectConfig(),
                               top1_fallback)
        self._adapters.pop("face_aligner", None)

    def get_face_aligner(self):
        """Callable raw photo -> aligned (112, 112, 3) crop of the top face
        (None when no face is found), or None when no detector is
        registered."""
        if "face_aligner" in self._adapters:
            return self._adapters["face_aligner"]
        if self._detector_spec is None:
            return None
        from ..models.face_detect import (
            convert_scrfd,
            make_face_aligner,
            scrfd_init,
        )

        path, cfg, top1 = self._detector_spec
        if path:
            params = convert_scrfd(load_state_dict(path).arrays(), cfg,
                                   torch.float32, self.device)
        else:
            params = scrfd_init(self._generator(), cfg, torch.float32,
                                self.device)
        fn = make_face_aligner(params, cfg, top1_fallback=top1)
        self._adapters["face_aligner"] = fn
        return fn

    def register_preprocessor(self, name: str, path: Optional[str] = None,
                              cfg=None, detect_resolution: int = 368):
        """Configure a model-based control preprocessor: a weight path in
        its published layout, an architecture config (read by "Depth",
        "Normal Map", "Semantic Segmentation" and "Zoedepth"; the random
        weights' shape without a path), and Openpose's detect resolution.
        The other names build their published width. A sub-net
        ("Openpose (hand)", "Openpose (face)") drops its parent's built
        closure, so the next ``get_preprocessor`` picks up its weights."""
        self._preproc_spec[name] = (path, cfg, detect_resolution)
        self._adapters.pop(f"preproc::{name}", None)
        if "(" in name:
            self._adapters.pop(f"preproc::{name.split(' (', 1)[0]}", None)

    def _detector(self, module, path, convert, cfg=None):
        """A detector's parameters on the manager's device, fp32: converted
        from ``path``, or from ``module.random_state_dict`` (at ``cfg``, or
        the published width for a network without one) without it."""
        if cfg is None:
            sd = load_state_dict(path) if path else \
                module.random_state_dict(seed=0)
            return convert(sd, device=self.device)
        sd = load_state_dict(path) if path else \
            module.random_state_dict(cfg, seed=0)
        return convert(sd, cfg, device=self.device)

    def get_preprocessor(self, name: str):
        """Callable (H, W, 3) image -> (H, W, 3) control image in [0, 1].

        The pure-image detectors come from
        ``ops.preprocess.NATIVE_PREPROCESSORS``; a model-based name builds
        its network at first use (the registered weights, or random
        published-layout weights), runs it in fp32 without TF32 on
        deterministic algorithms, and is cached by name."""
        from ..models import (dpt, hed, lineart, lineart_anime, mlsd,
                              normalbae, openpose, pidinet, upernet,
                              zoedepth)
        from ..models._nets import in_fp32
        from ..ops import preprocess as pp

        if name in pp.NATIVE_PREPROCESSORS:
            return pp.NATIVE_PREPROCESSORS[name]
        key = f"preproc::{name}"
        if key in self._adapters:
            return self._adapters[key]
        path, cfg, detect_res = self._preproc_spec.get(name,
                                                       (None, None, 368))
        nnet_cfg = isinstance(cfg, normalbae.NormalBaeConfig)
        if name == "Normal Map" and (path is not None or nnet_cfg):
            # NNET, the reference's Normal Map detector; without weights or
            # a config, the depth-gradient normals over DPT below
            ncfg = cfg or normalbae.NormalBaeConfig()
            params = self._detector(normalbae, path, normalbae.convert_nnet,
                                    ncfg)
            fn = pp.make_normalbae_preprocessor(
                params, ncfg,
                detect_res=detect_res if detect_res != 368 else 512)
        elif name in ("Depth", "Normal Map"):
            if name == "Normal Map" and path is None:
                # the weightless fallback reuses what "Depth" registered
                path, cfg, detect_res = self._preproc_spec.get(
                    "Depth", (None, cfg, detect_res))
            if cfg is None:
                cfg = dpt.DPTConfig() if path else dpt.DPT_FALLBACK
            params = self._detector(dpt, path, dpt.convert_dpt, cfg)
            fn = (pp.make_normal_map_preprocessor(params, cfg)
                  if name == "Normal Map"
                  else pp.make_depth_preprocessor(params, cfg))
        elif name == "Openpose":
            params = self._detector(openpose, path,
                                    openpose.convert_openpose_body)

            def _sub(sub_name, convert, draw):
                def build():
                    # the live spec: a sub-net registered after this
                    # closure was built is still picked up
                    sub_path = self._preproc_spec.get(sub_name, (None,))[0]
                    sd = load_state_dict(sub_path) if sub_path else \
                        draw(seed=0)
                    return convert(sd, device=self.device)

                return build

            fn = pp.make_openpose_preprocessor(
                params, detect_res,
                hand_params=_sub("Openpose (hand)",
                                 openpose.convert_openpose_hand,
                                 openpose.random_hand_state_dict),
                face_params=_sub("Openpose (face)",
                                 openpose.convert_openpose_face,
                                 openpose.random_face_state_dict))
        elif name == "Semantic Segmentation":
            if cfg is None:
                cfg = upernet.UperNetConfig() if path else \
                    upernet.UPERNET_FALLBACK
            params = self._detector(upernet, path, upernet.convert_upernet,
                                    cfg)
            fn = pp.make_segmentation_preprocessor(params, cfg)
        elif name == "Zoedepth":
            zcfg = cfg or (zoedepth.ZoeDepthConfig() if path
                           else zoedepth.ZOE_TINY)
            params = self._detector(zoedepth, path,
                                    zoedepth.convert_zoedepth, zcfg)
            fn = pp.make_zoedepth_preprocessor(params, zcfg)
        elif name == "MLSD":
            fn = pp.make_mlsd_preprocessor(
                self._detector(mlsd, path, mlsd.convert_mlsd))
        elif name in ("Soft Edge", "Scribble (PidiNet)"):
            scribble = name == "Scribble (PidiNet)"
            sd = load_state_dict(path) if path else None
            if sd is not None and "init_block.weight" not in sd.tensors \
                    and "block1.convs.0.weight" in sd.tensors:
                # HED-layout weights registered under the PidiNet slot
                fn = pp.make_hed_preprocessor(
                    hed.convert_hed(sd, device=self.device),
                    scribble=scribble)
            else:
                params = pidinet.convert_pidinet(
                    sd if sd is not None else pidinet.random_state_dict(
                        seed=0), device=self.device)
                fn = pp.make_pidinet_preprocessor(params, scribble=scribble)
        elif name in ("Soft Edge (HED)", "Scribble (HED)"):
            fn = pp.make_hed_preprocessor(
                self._detector(hed, path, hed.convert_hed),
                scribble=name == "Scribble (HED)")
        elif name == "Lineart":
            fn = functools.partial(lineart.detect_lineart, self._detector(
                lineart, path, lineart.convert_lineart))
        elif name == "Lineart (anime)":
            fn = functools.partial(
                lineart_anime.detect_lineart_anime, self._detector(
                    lineart_anime, path, lineart_anime.convert_lineart_anime))
        elif name == "Instruct Pix2Pix":
            fn = pp.NATIVE_PREPROCESSORS["None"]  # the raw image
        else:
            names = tuple(pp.NATIVE_PREPROCESSORS) + \
                pp.MODEL_BASED_PREPROCESSORS
            raise KeyError(f"unknown preprocessor {name!r}; available: "
                           f"{names}")
        if name != "Instruct Pix2Pix":
            fn = in_fp32(fn)
        self._adapters[key] = fn
        return fn

    def register_image_encoder(self, path: Optional[str] = None, cfg=None):
        """The IP-Adapter image encoder: its config (``CLIPVisionConfig``,
        ViT-H/14 by default) and a CLIPVisionModelWithProjection weight
        path (random weights without one)."""
        self._image_encoder_path = path
        self._image_encoder_cfg = cfg
        self._adapters.pop("image_encoder", None)

    def get_image_encoder(self):
        """(CLIPVisionConfig, params) of the IP-Adapter image encoder,
        converted from the registered weights or random from the port's
        generator, in the manager's dtype on its device, built at first
        use."""
        if "image_encoder" not in self._adapters:
            from ..models.clip_vision import (
                CLIPVisionConfig,
                clip_vision_init,
            )

            cfg = self._image_encoder_cfg or CLIPVisionConfig()
            if self._image_encoder_path:
                params = convert_clip_vision(
                    load_state_dict(self._image_encoder_path), cfg,
                    self.dtype, self.device)
            else:
                params = clip_vision_init(self._generator(), cfg,
                                          dtype=self.dtype,
                                          device=self.device)
            self._adapters["image_encoder"] = (cfg, params)
        return self._adapters["image_encoder"]


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
    # conditioning units
    controlnet_units: Sequence[ControlNetUnit] = (),
    t2i_units: Sequence[T2IAdapterUnit] = (),
    ip_adapter_units: Sequence[IPAdapterUnit] = (),
    # model variants
    loras: Sequence = (),  # paths or (path, scale) pairs
    ti_embeddings: Sequence[str] = (),
    # extras
    latent_preview: bool = False,  # or "base"/"hires"/"both": which
    # pass's per-step decodes to return with hires on; True = "both"
    timeout: float = registry.INFERENCE_TIMEOUT_S,
    cancel_check_steps: Optional[int] = None,
    # the opt-in speed modes (no reference counterpart; one at a time)
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
    img2img only (no inpaint, hires or preview in grid mode). On the
    manager's mesh, when it has several ranks and they split the grid
    equally, rank 0 sends the request to the other ranks
    (``follow_requests``) and returns the whole grid; a rank's error before
    sampling raises ``RankError`` here. An error during sampling leaves the
    ranks out of step: rank 0 raises ``RankError`` with the messages of the
    ranks that left, and runs every later grid alone."""
    # the request as the other ranks of a mesh take it: every argument but
    # the manager and the callback (a grid never calls it)
    request = {k: v for k, v in locals().items()
               if k not in ("manager", "progress_cb")}
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

    loaded_ip = None
    if ip_adapter_units:
        # the adapters' K/V weights go into a copy of the UNet tree's
        # containers (the tensors are shared), so the manager's cached tree
        # stays as it was
        states = [manager.get_ip_adapter_state(u.model, model_cfg.unet)
                  for u in ip_adapter_units]
        unet_copy = ipa.copy_tree_containers(params["unet"])
        loaded_ip = ipa.load_ip_adapter(unet_copy, model_cfg.unet, states,
                                        dtype=dtype, device=manager.device)
        params = {**params, "unet": unet_copy}

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

    # one conditioning image serves every generated sample: the whole grid
    # in grid mode, the num_images_per_prompt fan-out otherwise
    unit_fan = (
        len(grid_prompts) * len(grid_seeds)
        if grid_prompts is not None
        else num_images_per_prompt
    )
    extras: Optional[DenoiseExtras] = None
    cn_params = cn_imgs_raw = t2i_params = t2i_imgs_raw = None
    ip_extras: Optional[DenoiseExtras] = None
    with timer.phase("conditioning"):
        if controlnet_units:
            cn_params = [
                manager.get_controlnet(u.model, model_cfg.unet)
                for u in controlnet_units
            ]
            cn_imgs_raw = [
                _maybe_preprocess(manager, u) for u in controlnet_units
            ]
        if t2i_units:
            t2i_params = [
                manager.get_t2i_adapter(u.model, model_cfg.unet)
                for u in t2i_units
            ]
            t2i_imgs_raw = [
                _maybe_preprocess(manager, u) for u in t2i_units
            ]
        if ip_adapter_units:
            embeds, uncond_embeds = [], []
            for u, ad in zip(ip_adapter_units, loaded_ip):
                e, ue = _ip_unit_embeds(manager, u, ad)
                if unit_fan > 1 and e.shape[0] == 1:
                    # one reference image serves the whole fan-out
                    e = torch.repeat_interleave(e, unit_fan, dim=0)
                    ue = torch.repeat_interleave(ue, unit_fan, dim=0)
                embeds.append(e)
                uncond_embeds.append(ue)
            # the tokens and masks do not depend on the resolution (a mask
            # is downsampled at each attention): built once, the hires pass
            # reuses them
            ip_extras = pipe.build_ip_extras(
                loaded_ip, embeds,
                do_cfg=cfg_scale > 1.0,
                scales=[u.scale for u in ip_adapter_units],
                masks=(
                    [
                        None if u.mask is None
                        else _unit_batch(
                            1.0 - np.asarray(u.mask, np.float32)
                            if u.invert_mask else u.mask,
                            unit_fan,
                        )
                        for u in ip_adapter_units
                    ]
                    if any(u.mask is not None for u in ip_adapter_units)
                    else None
                ),
                uncond_image_embeds=uncond_embeds,
            )

        def build_unit_extras(gen_for):
            """The units' extras at gen_for's size. ControlNet images and
            T2I residuals are bound to the resolution, so the hires pass
            calls this again with its own config."""
            ex = None
            if controlnet_units:
                imgs = [
                    _unit_batch(
                        _fit_unit_image(im, gen_for.height, gen_for.width),
                        unit_fan,
                    )
                    for im in cn_imgs_raw
                ]
                ex = pipe.build_controlnet_extras(
                    gen_for, cn_params, imgs,
                    do_cfg=cfg_scale > 1.0,
                    scales=[u.scale for u in controlnet_units],
                    starts=[u.guidance_start for u in controlnet_units],
                    ends=[u.guidance_end for u in controlnet_units],
                    guess_mode=any(u.guess_mode for u in controlnet_units),
                )
            if t2i_units:
                # the residuals are computed once a generation and active
                # while step < steps * factor
                imgs = [
                    _unit_batch(
                        _fit_unit_image(im, gen_for.height, gen_for.width),
                        unit_fan,
                    )
                    for im in t2i_imgs_raw
                ]
                ex = pipe.build_t2i_extras(
                    gen_for, t2i_params, imgs,
                    do_cfg=cfg_scale > 1.0,
                    scales=[u.scale for u in t2i_units],
                    conditioning_factor=min(
                        u.conditioning_factor for u in t2i_units
                    ),
                    base=ex,
                )
            if ip_extras is not None:
                ex = dataclasses.replace(
                    ex or DenoiseExtras(),
                    ip_tokens=ip_extras.ip_tokens,
                    ip_scales=ip_extras.ip_scales,
                    ip_masks=ip_extras.ip_masks,
                )
            return ex

        if controlnet_units or t2i_units or ip_adapter_units:
            extras = build_unit_extras(gen)
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
        # the JAX package's mesh="auto", on the manager's mesh: rank 0
        # decides and sends the request; then every rank reports ready
        mesh = manager.mesh
        if mesh is not None and (mesh.world_size == 1 or len(grid_prompts)
                                 * len(grid_seeds) % mesh.world_size):
            mesh = None
        if mesh is not None and mesh.rank == 0 and mesh.left():
            _log.error("the mesh lost a rank (%s): the grid runs on rank 0 "
                       "alone", "; ".join(mesh.left()))
            mesh = None
        if mesh is not None:
            if mesh.rank == 0:
                mesh.send_request(("grid", request))
            mesh.agree()
        with timer.phase("sample"):
            try:
                out = generate_grid(
                    pipe, grid_prompts, grid_seeds, gen,
                    negative_prompt=neg_prompt, region_states=grid_states,
                    mesh=mesh, encoding_mode=encoding_mode, extras=extras,
                    init_images=grid_inits, strength=strength,
                )
            except Exception as e:
                if mesh is None or mesh.rank > 0:
                    raise  # a rank > 0 leaves in follow_requests
                # the ranks are out of step: rank 0 leaves the mesh too
                mesh.leave(f"{type(e).__name__}: {e}")
                raise RankError("; ".join(mesh.left())) from e
        watchdog.check()
        with timer.phase("to_host"):
            images = (_to_host_u8(out) if mesh is None or mesh.rank == 0
                      else None)
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
        if controlnet_units or t2i_units:
            hires["rebuild_extras"] = build_unit_extras

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
            rs = None
            if region_state:
                rs = ([region_state], ids, num_images_per_prompt)
            out = pipe.txt2img_bottleneck(
                context, gen, low_scale=bottleneck_low_scale, seed=seed,
                region_biases=None, region_state=rs, batch_size=batch,
                extras=extras, uint8_output=True,
            )
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
            out = pipe.txt2img_deepcache(
                context, gen, deepcache_interval, seed=seed,
                region_biases=region_biases, batch_size=batch,
                extras=extras, uint8_output=True,
            )
        elif turbo_modes["tgate_gate_frac"]:
            if hires is not None or latent_preview:
                raise ValueError(
                    "tgate_gate_frac does not combine with hires or "
                    "latent_preview"
                )
            out = pipe.txt2img_tgate(
                context, gen, tgate_gate_frac, seed=seed,
                region_biases=region_biases, batch_size=batch,
                extras=extras, uint8_output=True,
            )
        elif cfg_tail_frac and cfg_tail_frac > 0.0:
            if hires is not None or latent_preview:
                raise ValueError(
                    "cfg_tail_frac does not combine with hires or "
                    "latent_preview"
                )
            out = pipe.txt2img_cfg_tail(
                context, gen, cfg_tail_frac, seed=seed,
                region_biases=region_biases, batch_size=batch,
                extras=extras, uint8_output=True,
            )
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


def follow_requests(manager: ModelManager) -> int:
    """Ranks > 0 of the manager's mesh: run each grid request rank 0 sends
    (the same ``inference()`` call, in step with rank 0) until it sends
    ``stop_followers``; returns the requests run. An error before sampling
    is reported to every rank (``Mesh.agree``, which rank 0 raises) and the
    loop goes on. One during sampling leaves the ranks out of step: this
    rank leaves the mesh (``Mesh.leave``, so that rank 0 runs later grids
    alone) and raises it here, which ends the loop. Rank 0's request in
    flight fails once this rank's process group is gone (gloo) or at the
    group's timeout (NCCL)."""
    mesh = manager.mesh
    done = 0
    while True:
        kind, request = mesh.wait_request()
        if kind == "stop":
            return done
        agreed = mesh.counts["agree"]
        try:
            inference(manager, **request)
        except RankError:  # reported by every rank: the next request
            continue
        except Exception as e:  # noqa: BLE001 - reported to rank 0
            if mesh.counts["agree"] != agreed:
                mesh.leave(f"{type(e).__name__}: {e}")
                raise
            with contextlib.suppress(RankError):
                mesh.agree(f"{type(e).__name__}: {e}")
            continue
        if mesh.counts["agree"] == agreed:
            mesh.leave("a request rank 0 sent ran on this rank alone")
            raise RuntimeError("a request rank 0 sent ran on this rank "
                               "alone: the ranks are out of step")
        done += 1


def stop_followers(manager: ModelManager) -> None:
    """Rank 0: end the other ranks' ``follow_requests``."""
    manager.mesh.send_request(("stop", None))


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


def _maybe_preprocess(manager: ModelManager, unit) -> np.ndarray:
    """A unit's image in [0, 1]: uint8 maps are divided by 255. A
    ``preprocessor`` goes to ``manager.get_preprocessor``, with the unit's
    options."""
    if unit.preprocessor:
        fn = manager.get_preprocessor(unit.preprocessor)
        opts = getattr(unit, "preprocessor_options", None)
        return fn(unit.image, **opts) if opts else fn(unit.image)
    img = np.asarray(unit.image)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    return img


def _fit_unit_image(img, h: int, w: int) -> torch.Tensor:
    """A unit image (H, W, C), or (H, W) given a channel axis, resized to
    the generation size as ``jax.image.resize(..., "bilinear")`` does, its
    default antialiasing included (a control image larger than the request
    is shrunk with a widened kernel); fp32 on the host."""
    arr = torch.as_tensor(np.asarray(img, np.float32))
    if arr.dim() == 2:
        arr = arr[..., None]
    if arr.shape[0] == h and arr.shape[1] == w:
        return arr
    return resize_latents(arr[None], h, w, mode="bilinear",
                          antialias=True)[0]


def _unit_batch(img, n: int) -> torch.Tensor:
    """(H, W, C) unit image -> (n, H, W, C): one conditioning image serves
    the whole fan-out."""
    arr = torch.as_tensor(img, dtype=torch.float32)[None]
    return torch.repeat_interleave(arr, n, dim=0) if n > 1 else arr


def _to_pm1(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 127.5 - 1.0
    return img.astype(np.float32)


def _ip_unit_embeds(manager: ModelManager, unit: IPAdapterUnit, adapter):
    """(cond_embeds, uncond_embeds) of one IP-Adapter unit on the manager's
    device: ``image_embeds`` as given (a batch axis added to a vector, and
    to a (P, D) Resampler input; uncond as given or zeros); FaceID (an
    ``mlp`` adapter on 512 inputs) embeds the face, detected and aligned
    first when a detector is registered, uncond zeros; the others run the
    CLIP-vision tower, the Resampler on its penultimate hidden states with
    uncond the hidden states of zero pixels (after normalization), the rest
    on its projected embeds with uncond zeros."""
    dev = manager.device
    if unit.image_embeds is not None:
        emb = on_device(unit.image_embeds, dev)
        if emb.dim() == 1 or (adapter.variant == "resampler"
                              and emb.dim() == 2):
            emb = emb[None]
        uncond = (on_device(unit.uncond_image_embeds, dev)
                  if unit.uncond_image_embeds is not None
                  else torch.zeros_like(emb))
        if uncond.shape != emb.shape:
            uncond = uncond[None]
        return emb, uncond
    if unit.image is None:
        raise ValueError(
            f"IP-Adapter unit {unit.model!r} needs image or image_embeds"
        )

    # the port's linear kernels are (out, in): FaceID's MLP takes 512
    is_faceid = (adapter.variant == "mlp"
                 and adapter.proj_params["ff_in"]["kernel"].shape[1] == 512)
    if is_faceid:
        face_img = unit.image
        aligner = manager.get_face_aligner()
        if aligner is not None:
            face_img = aligner(np.asarray(face_img))
            if face_img is None:
                raise ValueError(
                    f"IP-Adapter unit {unit.model!r}: no face detected in "
                    "the reference image"
                )
        embedder = unit.face_embedder or manager.get_face_embedder()
        emb = on_device(embedder(face_img), dev)[None]
        return emb, torch.zeros_like(emb)

    from ..models.clip_vision import clip_vision_apply, preprocess_image

    enc_cfg, enc_params = manager.get_image_encoder()
    pixels = preprocess_image(np.asarray(unit.image)[None],
                              enc_cfg.image_size, device=dev)
    hidden = adapter.variant == "resampler"
    with torch.inference_mode():
        emb = clip_vision_apply(enc_params, enc_cfg, pixels,
                                output_hidden_state=hidden)
        if hidden:
            uncond = clip_vision_apply(enc_params, enc_cfg,
                                       torch.zeros_like(pixels),
                                       output_hidden_state=True)
        else:
            uncond = torch.zeros_like(emb)
    return emb, uncond
