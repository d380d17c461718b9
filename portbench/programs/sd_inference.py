"""The system under test for the Stable Diffusion configurations: the
port's ``app.api.inference()`` on a ``ModelManager``, as a user of the app
or of one ``/generate`` client calls it.

The weights the benchmark made (diffusers / transformers names) go through
the port's own checkpoint converters (``convert/hf.py``) in memory, with
the 64 spare token rows ``ModelManager.get`` gives a checkpoint, and the
manager takes the converted tree and the hash tokenizer as
``register_random`` gives them. The port's ``ModelConfig`` is built from
the configuration file's groups: every key of a group that names a field
of the port's dataclass of that group is passed to it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict

import numpy as np
import torch

MODEL = "bench"


def port_config(cfg: dict):
    """The port's ``ModelConfig`` of the configuration file."""
    from diffusionspatialcontrol_tpu_torch.config import (
        CLIPTextConfig,
        ModelConfig,
        UNetConfig,
        VAEConfig,
    )

    te, un, va, sc = (cfg["text_encoder"], cfg["unet"], cfg["vae"],
                      cfg["scheduler"])
    levels = len(un["block_out_channels"])
    heads = un.get("num_attention_heads") or un["attention_head_dim"]
    if not isinstance(heads, (list, tuple)):
        heads = [heads] * levels
    known = {
        "clip": (CLIPTextConfig, {
            "num_layers": te["num_hidden_layers"],
            "num_heads": te["num_attention_heads"]}, te),
        "unet": (UNetConfig, {
            "block_out_channels": tuple(un["block_out_channels"]),
            "num_attention_heads": tuple(heads),
            "attn_levels": tuple(t.startswith("CrossAttn")
                                 for t in un["down_block_types"])}, un),
        "vae": (VAEConfig, {
            "block_out_channels": tuple(va["block_out_channels"])}, va),
    }
    groups = {}
    for key, (cls, fixed, src) in known.items():
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in src.items() if k in names}
        kw.update({k: v for k, v in fixed.items() if k in names})
        groups[key] = cls(**kw)
    return ModelConfig(
        name=cfg["name"], **groups,
        prediction_type=sc.get("prediction_type", "epsilon"),
        num_train_timesteps=sc["num_train_timesteps"],
        beta_start=sc["beta_start"], beta_end=sc["beta_end"],
        beta_schedule=sc["beta_schedule"])


class Program:
    """``run(request)`` -> (images (B, H, W, 3) uint8 on the host, the
    request's ``timings`` phases in seconds)."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], device,
                 dtype):
        from diffusionspatialcontrol_tpu_torch.app.api import ModelManager
        from diffusionspatialcontrol_tpu_torch.convert.hf import (
            StateDict,
            convert_clip,
            convert_unet,
            convert_vae,
        )
        from diffusionspatialcontrol_tpu_torch.text.tokenizer import (
            load_tokenizer,
        )

        from portbench import weights as W

        self.dtype = dtype
        self.model_cfg = port_config(cfg)
        self.manager = ModelManager(dtype=dtype, device=device)
        params = {
            "unet": convert_unet(StateDict(W.component(weights, "unet.")),
                                 self.model_cfg.unet, dtype, device),
            "vae": convert_vae(StateDict(W.component(weights, "vae.")),
                               self.model_cfg.vae, dtype, device),
            "clip": convert_clip(
                StateDict(W.component(weights, "text_encoder.")),
                self.model_cfg.clip, dtype, n_extra_tokens=64,
                device=device),
        }
        # what register_random does, with the converted tree
        self.manager._dirs[MODEL] = ("", self.model_cfg)
        self.manager._cache[MODEL] = params
        self.manager._tokenizers[MODEL] = load_tokenizer()

    def run(self, req: dict):
        from diffusionspatialcontrol_tpu_torch.app.api import inference

        out = inference(
            self.manager, req["prompt"], MODEL,
            neg_prompt=req["negative_prompt"], sampler=req["sampler"],
            steps=req["steps"], cfg_scale=req["cfg_scale"],
            width=req["width"], height=req["height"], seed=req["seed"],
            num_images_per_prompt=req["num_images_per_prompt"],
            clip_skip=req["clip_skip"], encoding_mode=req["encoding_mode"],
            region_state=req["region_state"], dtype=self.dtype)
        timings = json.loads(out["timings"])
        phases = {k[:-2]: float(v) for k, v in timings.items()
                  if k.endswith("_s") and k != "total_s"}
        return np.asarray(out["images"]), phases
