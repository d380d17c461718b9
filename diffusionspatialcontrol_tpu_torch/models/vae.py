"""AutoencoderKL (port of ``models/vae.py``): parameters of the encoder and
decoder, and the decode path. NHWC activations. The decoder's resnets take
``conv_impl`` as the UNet's do ("xla", "pallas": K4, "pallas2": K5).

Not ported yet: ``vae_encode`` (img2img / inpaint) and the asymmetric
mask-conditioned decoder.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..config import VAEConfig
from .layers import (
    check_conv_impl,
    conv2d,
    conv_init,
    group_norm,
    linear,
    linear_init,
    norm_init,
    resnet_fused,
    silu,
    upsample_nearest2x,
)


def _resnet_init(g, in_c, out_c, dtype, device):
    p = {
        "norm1": norm_init(in_c, dtype, device),
        "conv1": conv_init(g, in_c, out_c, 3, dtype, device),
        "norm2": norm_init(out_c, dtype, device),
        "conv2": conv_init(g, out_c, out_c, 3, dtype, device),
    }
    if in_c != out_c:
        p["conv_shortcut"] = conv_init(g, in_c, out_c, 1, dtype, device)
    return p


def _resnet_apply(p, x, groups, conv_impl="xla"):
    if conv_impl != "xla":
        return resnet_fused(p, x, groups, 1e-6, conv_impl)
    h = silu(group_norm(p["norm1"], x, groups, 1e-6))
    h = conv2d(p["conv1"], h)
    h = silu(group_norm(p["norm2"], h, groups, 1e-6))
    h = conv2d(p["conv2"], h)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding="VALID")
    return x + h


def _attn_init(g, c, dtype, device):
    def lin():
        return linear_init(g, c, c, dtype=dtype, device=device)

    return {"group_norm": norm_init(c, dtype, device), "to_q": lin(),
            "to_k": lin(), "to_v": lin(), "to_out": lin()}


def _attn_apply(p, x, groups):
    """Single-head mid attention: fp32 matmul and softmax (a plain XLA op in
    the JAX package, not a Pallas kernel)."""
    b, hh, ww, c = x.shape
    h = group_norm(p["group_norm"], x, groups, 1e-6).reshape(b, hh * ww, c)
    q = linear(p["to_q"], h).float()
    k = linear(p["to_k"], h).float()
    v = linear(p["to_v"], h).float()
    probs = torch.softmax(q @ k.transpose(1, 2) * c ** -0.5, dim=-1)
    out = (probs @ v).to(x.dtype)
    return x + linear(p["to_out"], out).reshape(b, hh, ww, c)


def vae_init(g: torch.Generator, cfg: VAEConfig, dtype=torch.bfloat16,
             device=None) -> Dict[str, Any]:
    if cfg.asymmetric:
        raise NotImplementedError("the asymmetric VAE decoder is not ported")
    chans = cfg.block_out_channels

    enc: Dict[str, Any] = {
        "conv_in": conv_init(g, cfg.in_channels, chans[0], 3, dtype, device)}
    down = []
    in_c = chans[0]
    for lv, out_c in enumerate(chans):
        block = {"resnets": [
            _resnet_init(g, in_c if j == 0 else out_c, out_c, dtype, device)
            for j in range(cfg.layers_per_block)]}
        if lv < len(chans) - 1:
            block["downsample"] = conv_init(g, out_c, out_c, 3, dtype, device)
        down.append(block)
        in_c = out_c
    enc["down_blocks"] = down
    c_last = chans[-1]
    enc["mid"] = {
        "resnet1": _resnet_init(g, c_last, c_last, dtype, device),
        "attention": _attn_init(g, c_last, dtype, device),
        "resnet2": _resnet_init(g, c_last, c_last, dtype, device),
    }
    enc["conv_norm_out"] = norm_init(c_last, dtype, device)
    enc["conv_out"] = conv_init(g, c_last, 2 * cfg.latent_channels, 3, dtype,
                                device)
    enc["quant_conv"] = conv_init(g, 2 * cfg.latent_channels,
                                  2 * cfg.latent_channels, 1, dtype, device)

    dec: Dict[str, Any] = {
        "post_quant_conv": conv_init(g, cfg.latent_channels,
                                     cfg.latent_channels, 1, dtype, device),
        "conv_in": conv_init(g, cfg.latent_channels, c_last, 3, dtype,
                             device),
        "mid": {
            "resnet1": _resnet_init(g, c_last, c_last, dtype, device),
            "attention": _attn_init(g, c_last, dtype, device),
            "resnet2": _resnet_init(g, c_last, c_last, dtype, device),
        },
    }
    up = []
    rev = list(reversed(chans))
    in_c = c_last
    for lv, out_c in enumerate(rev):
        block = {"resnets": [
            _resnet_init(g, in_c if j == 0 else out_c, out_c, dtype, device)
            for j in range(cfg.layers_per_block + 1)]}
        if lv < len(rev) - 1:
            block["upsample"] = conv_init(g, out_c, out_c, 3, dtype, device)
        up.append(block)
        in_c = out_c
    dec["up_blocks"] = up
    dec["conv_norm_out"] = norm_init(rev[-1], dtype, device)
    dec["conv_out"] = conv_init(g, rev[-1], cfg.out_channels, 3, dtype,
                                device)
    return {"encoder": enc, "decoder": dec}


def vae_decode(params, cfg: VAEConfig, latents: torch.Tensor,
               conv_impl: str = "xla") -> torch.Tensor:
    """latents (B, h, w, 4), *scaled*; returns images (B, 8h, 8w, 3) in
    [-1, 1], fp32."""
    conv_impl = check_conv_impl(conv_impl)
    dec = params["decoder"]
    g = cfg.norm_num_groups
    z = (latents / cfg.scaling_factor).to(dec["conv_in"]["kernel"].dtype)
    h = conv2d(dec["post_quant_conv"], z, padding="VALID")
    h = conv2d(dec["conv_in"], h)
    h = _resnet_apply(dec["mid"]["resnet1"], h, g, conv_impl)
    h = _attn_apply(dec["mid"]["attention"], h, g)
    h = _resnet_apply(dec["mid"]["resnet2"], h, g, conv_impl)
    for block in dec["up_blocks"]:
        for r in block["resnets"]:
            h = _resnet_apply(r, h, g, conv_impl)
        if "upsample" in block:
            h = conv2d(block["upsample"], upsample_nearest2x(h))
    h = silu(group_norm(dec["conv_norm_out"], h, g, 1e-6))
    return conv2d(dec["conv_out"], h).float()
