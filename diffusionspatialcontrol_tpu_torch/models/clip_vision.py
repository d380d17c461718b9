"""CLIP vision tower (ViT) with projection, the IP-Adapter image encoder
(port of ``models/clip_vision.py``).

``CLIPVisionModelWithProjection`` as the reference's IP-Adapter loader
registers it; the default config is OpenCLIP ViT-H/14 (224^2, patch 14,
1280 wide, 32 layers, 16 heads, projection 1024). The penultimate hidden
states feed the plus (Resampler) variants, the projected embeds the
others. The MLP uses the tanh GELU, as the JAX package's does. Attention
runs through K2 (``flash_attention_nlhd``; its plain version on CPU
tensors), where the JAX package runs plain XLA attention.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kernels.flash_attention import flash_attention_nlhd
from ..ops.resize import resize
from .layers import conv2d, conv_init, layer_norm, linear, linear_init, norm_init


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def clip_vision_init(g: torch.Generator, cfg: CLIPVisionConfig,
                     dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Random weights from ``g`` in the JAX package's distributions (its
    tree and names; other values than its ``PRNGKey`` init)."""
    d = cfg.hidden_size

    def normal(*shape):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return (t.normal_(generator=g) * 0.02).to(dtype)

    def lin(i, o, bias=True):
        return linear_init(g, i, o, bias=bias, dtype=dtype, device=device)

    params: Dict[str, Any] = {
        "class_embedding": normal(d),
        # CLIP's patch embedding has no bias
        "patch_embedding": {"kernel": conv_init(
            g, 3, d, cfg.patch_size, dtype, device)["kernel"]},
        "position_embedding": normal(cfg.num_patches + 1, d),
        "pre_layrnorm": norm_init(d, dtype, device),
        "layers": [],
        "post_layernorm": norm_init(d, dtype, device),
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "layer_norm1": norm_init(d, dtype, device),
            "q_proj": lin(d, d), "k_proj": lin(d, d), "v_proj": lin(d, d),
            "out_proj": lin(d, d),
            "layer_norm2": norm_init(d, dtype, device),
            "fc1": lin(d, cfg.intermediate_size),
            "fc2": lin(cfg.intermediate_size, d),
        })
    params["visual_projection"] = lin(d, cfg.projection_dim, bias=False)
    return params


def _attn(p, x, heads):
    b, l, d = x.shape

    def split(t):
        return t.reshape(b, l, heads, d // heads)

    out = flash_attention_nlhd(split(linear(p["q_proj"], x)),
                               split(linear(p["k_proj"], x)),
                               split(linear(p["v_proj"], x)))
    return linear(p["out_proj"], out.reshape(b, l, d))


def clip_vision_apply(params: Dict[str, Any], cfg: CLIPVisionConfig,
                      images: torch.Tensor,
                      output_hidden_state: bool = False) -> torch.Tensor:
    """images (B, H, W, 3), CLIP-normalized (``preprocess_image``) ->
    projected image embeds (B, projection_dim), or with
    ``output_hidden_state`` the penultimate hidden states (B, 1 + P,
    hidden): the last layer does not run."""
    dtype = params["class_embedding"].dtype
    x = images.to(dtype)
    d = cfg.hidden_size
    zero_bias = torch.zeros(d, dtype=dtype, device=x.device)
    patches = conv2d({"kernel": params["patch_embedding"]["kernel"],
                      "bias": zero_bias}, x, stride=cfg.patch_size,
                     padding="VALID")
    b = x.shape[0]
    cls = params["class_embedding"][None, None].expand(b, 1, d)
    h = torch.cat([cls, patches.reshape(b, -1, d)], dim=1)
    h = h + params["position_embedding"][None]
    h = layer_norm(params["pre_layrnorm"], h)
    n_run = cfg.num_layers - (1 if output_hidden_state else 0)
    for layer in params["layers"][:n_run]:
        h = h + _attn(layer, layer_norm(layer["layer_norm1"], h),
                      cfg.num_heads)
        hh = layer_norm(layer["layer_norm2"], h)
        h = h + linear(layer["fc2"], F.gelu(linear(layer["fc1"], hh),
                                            approximate="tanh"))
    if output_hidden_state:
        return h
    pooled = layer_norm(params["post_layernorm"], h[:, 0])
    return linear(params["visual_projection"], pooled)


CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_image(images, size: int = 224, device=None) -> torch.Tensor:
    """CLIPImageProcessor's role: images (B, H, W, 3), uint8 or in [0, 1],
    numpy or a tensor, resized to size x size as ``jax.image.resize(...,
    "cubic")`` does (Keys a = -0.5, antialiased when shrinking), then CLIP
    normalization; fp32 on ``device`` (the images' own by default)."""
    x = torch.as_tensor(np.asarray(images) if not isinstance(
        images, torch.Tensor) else images, device=device)
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    x = x.float()
    x = resize(x, (x.shape[0], size, size, 3), "cubic")
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std
