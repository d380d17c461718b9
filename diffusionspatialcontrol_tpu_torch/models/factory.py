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


def param_count(params) -> int:
    """Elements in a parameter tree (a ``None`` leaf counts none)."""
    if params is None:
        return 0
    if isinstance(params, torch.Tensor):
        return params.numel()
    items = params.values() if isinstance(params, dict) else params
    return sum(param_count(p) for p in items)
