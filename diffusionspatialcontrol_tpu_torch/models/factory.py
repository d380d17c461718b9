"""Random parameter construction (port of ``models/factory.py``).

The tree has the JAX package's structure and names, and every tensor its
JAX shape in the port's layout (``layers.py``); it is built directly on the
device. Random weights give the same per-step work as converted checkpoint
weights.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from ..config import ModelConfig
from ..device import resolve_device
from .clip import clip_init
from .unet import unet_init
from .vae import vae_init


def init_pipeline_params(generator: Union[int, torch.Generator],
                         cfg: ModelConfig, dtype=torch.bfloat16,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> Dict[str, Any]:
    """``generator``: a seed or a ``torch.Generator`` on ``device``.
    ``device`` defaults to CUDA and raises when there is none."""
    device = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)
    with torch.no_grad():
        return {
            "clip": clip_init(generator, cfg.clip, dtype, device),
            "unet": unet_init(generator, cfg.unet, dtype, device),
            "vae": vae_init(generator, cfg.vae, dtype, device),
        }


def with_text_bias(params, seed: int = 0):
    """The random init with a random final LayerNorm bias in CLIP (0.5 a
    standard normal, from a CPU generator of ``seed``), as trained weights
    have one: the init's zero bias leaves every text embedding row with a
    mean of 0 up to rounding, and the "a1111" and "long" prompt modes
    divide by such means (their weighting restores the embedding's mean).
    Changes ``params`` in place and returns it."""
    norm = params["clip"]["final_layer_norm"]
    g = torch.Generator().manual_seed(seed)
    bias = 0.5 * torch.randn(norm["bias"].shape, generator=g)
    norm["bias"] = bias.to(norm["bias"].dtype).to(norm["bias"].device)
    return params


def param_count(params) -> int:
    """Elements in a parameter tree (a ``None`` leaf counts none)."""
    if params is None:
        return 0
    if isinstance(params, torch.Tensor):
        return params.numel()
    items = params.values() if isinstance(params, dict) else params
    return sum(param_count(p) for p in items)
