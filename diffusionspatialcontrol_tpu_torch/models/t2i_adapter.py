"""T2I-Adapter trunk, TencentARC's full adapter for SD1.5 (port of
``models/t2i_adapter.py``).

The adapter turns a conditioning image into one residual feature map a UNet
level (latent size /1, /2, /4, /8), which ``unet_apply`` adds after the last
layer of each down block. Several adapters sum their outputs, each times its
scale (diffusers' MultiAdapter). A level that keeps the previous level's
width has no ``in_conv`` (``None`` in the tree; SD1.5's level 3).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import T2IAdapterConfig
from .layers import conv2d, conv_init


def _pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/f, W/f, C f f), the channels ordered (C, fh, fw)
    as torch's PixelUnshuffle orders them."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // factor, factor, w // factor, factor, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # b, h/f, w/f, c, fh, fw
    return x.reshape(b, h // factor, w // factor, c * factor * factor)


def _resblock_init(g, channels, dtype, device):
    return {"block1": conv_init(g, channels, channels, 3, dtype, device),
            "block2": conv_init(g, channels, channels, 1, dtype, device)}


def _resblock_apply(p, x):
    h = F.relu(conv2d(p["block1"], x))
    return x + conv2d(p["block2"], h, padding="VALID")


def t2i_adapter_init(g: torch.Generator,
                     cfg: T2IAdapterConfig = T2IAdapterConfig(),
                     dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    blocks = []
    prev = cfg.in_channels * cfg.downscale_factor ** 2
    for ch in cfg.channels:
        blocks.append({
            "in_conv": (conv_init(g, prev, ch, 3, dtype, device)
                        if prev != ch else None),
            "resnets": [_resblock_init(g, ch, dtype, device)
                        for _ in range(cfg.num_res_blocks)],
        })
        prev = ch
    return {"blocks": blocks}


def t2i_adapter_apply(params, cfg: T2IAdapterConfig,
                      image: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """image: (B, H, W, 3) in [0, 1]; the adapter runs in the image's dtype
    (the kernels are cast to it). Returns one feature map a level."""
    x = _pixel_unshuffle(image, cfg.downscale_factor)
    feats: List[torch.Tensor] = []
    for level, block in enumerate(params["blocks"]):
        if level > 0:  # a 2x2 average pool, VALID, between levels
            x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        if block["in_conv"] is not None:
            x = conv2d(block["in_conv"], x)
        for r in block["resnets"]:
            x = _resblock_apply(r, x)
        feats.append(x)
    return tuple(feats)


def multi_adapter_apply(params_list: Sequence, cfg: T2IAdapterConfig,
                        images: Sequence[torch.Tensor],
                        scales: Sequence[float]) -> Tuple[torch.Tensor, ...]:
    """The sum over adapters of each one's features times its scale."""
    outs = None
    for p, img, s in zip(params_list, images, scales):
        feats = tuple(f * s for f in t2i_adapter_apply(p, cfg, img))
        outs = feats if outs is None else tuple(
            a + b for a, b in zip(outs, feats))
    return outs
