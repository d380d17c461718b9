"""AutoencoderKL (port of ``models/vae.py``): the encoder (images to
latents, for img2img and inpaint) and the decoder, with the asymmetric
mask-conditioned decoder of the inpaint presets. NHWC activations. The
resnets of both halves take ``conv_impl`` as the UNet's do ("xla",
"xla_bf16", "pallas": K4, "pallas2": K5); the single-head mid attention is
a plain op, as it is in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..config import VAEConfig
from ..ops.resize import resize_latents
from .layers import (
    FUSED_CONV_IMPLS,
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
    if conv_impl in FUSED_CONV_IMPLS:
        return resnet_fused(p, x, groups, 1e-6, conv_impl)
    rnd = conv_impl == "xla_bf16"
    h = silu(group_norm(p["norm1"], x, groups, 1e-6))
    h = conv2d(p["conv1"], h, round_before_bias=rnd)
    h = silu(group_norm(p["norm2"], h, groups, 1e-6))
    h = conv2d(p["conv2"], h, round_before_bias=rnd)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding="VALID",
                   round_before_bias=rnd)
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


def _mid_init(g, c, dtype, device):
    return {"resnet1": _resnet_init(g, c, c, dtype, device),
            "attention": _attn_init(g, c, dtype, device),
            "resnet2": _resnet_init(g, c, c, dtype, device)}


def _mid_apply(p, h, groups, conv_impl):
    h = _resnet_apply(p["resnet1"], h, groups, conv_impl)
    h = _attn_apply(p["attention"], h, groups)
    return _resnet_apply(p["resnet2"], h, groups, conv_impl)


def vae_init(g: torch.Generator, cfg: VAEConfig, dtype=torch.bfloat16,
             device=None) -> Dict[str, Any]:
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
    enc["mid"] = _mid_init(g, c_last, dtype, device)
    enc["conv_norm_out"] = norm_init(c_last, dtype, device)
    enc["conv_out"] = conv_init(g, c_last, 2 * cfg.latent_channels, 3, dtype,
                                device)
    enc["quant_conv"] = conv_init(g, 2 * cfg.latent_channels,
                                  2 * cfg.latent_channels, 1, dtype, device)

    # The decoder may be wider and deeper than the encoder (asymmetric VAE).
    dchans = cfg.decoder_block_out_channels or chans
    d_layers = cfg.decoder_layers_per_block or cfg.layers_per_block
    dc_last = dchans[-1]
    dec: Dict[str, Any] = {
        "post_quant_conv": conv_init(g, cfg.latent_channels,
                                     cfg.latent_channels, 1, dtype, device),
        "conv_in": conv_init(g, cfg.latent_channels, dc_last, 3, dtype,
                             device),
        "mid": _mid_init(g, dc_last, dtype, device),
    }
    up = []
    rev = list(reversed(dchans))
    in_c = dc_last
    for lv, out_c in enumerate(rev):
        block = {"resnets": [
            _resnet_init(g, in_c if j == 0 else out_c, out_c, dtype, device)
            for j in range(d_layers + 1)]}
        if lv < len(rev) - 1:
            block["upsample"] = conv_init(g, out_c, out_c, 3, dtype, device)
        up.append(block)
        in_c = out_c
    dec["up_blocks"] = up
    dec["conv_norm_out"] = norm_init(rev[-1], dtype, device)
    dec["conv_out"] = conv_init(g, rev[-1], cfg.out_channels, 3, dtype,
                                device)
    if cfg.asymmetric:
        dec["condition_encoder"] = mask_condition_encoder_init(g, cfg, dtype,
                                                               device)
    return {"encoder": enc, "decoder": dec}


def _condition_layer_plan(cfg: VAEConfig):
    """(in_c, out_c, stride) per layer of the mask-condition encoder: two
    stride-1 layers at full resolution (the channels of the last up block
    and of the final blend), then one stride-2 layer per coarser scale of
    the decoder, the deepest one at the decoder's ``conv_in`` width."""
    dchans = cfg.decoder_block_out_channels or cfg.block_out_channels
    rev = list(reversed(dchans))
    outs = [rev[-1], rev[-2]]
    strides = [1, 1]
    for i in range(len(rev) - 2, -1, -1):
        outs.append(rev[max(i - 1, 0)] if i > 0 else rev[0])
        strides.append(2)
    outs[-1] = dchans[-1]
    plan = []
    in_c = cfg.in_channels + 1  # masked image + mask channel
    for out_c, st in zip(outs, strides):
        plan.append((in_c, out_c, st))
        in_c = out_c
    return plan


def mask_condition_encoder_init(g: torch.Generator, cfg: VAEConfig,
                                dtype=torch.bfloat16, device=None):
    """3x3 convs for the stride-1 layers, 4x4 for the stride-2 ones."""
    return {"layers": [
        conv_init(g, in_c, out_c, 3 if st == 1 else 4, dtype, device)
        for in_c, out_c, st in _condition_layer_plan(cfg)]}


def mask_condition_encoder_apply(p, masked_image: torch.Tensor,
                                 mask: torch.Tensor):
    """Known-pixel features keyed by (C, H, W).

    ``masked_image``: (B, H, W, 3) with the regenerate region zeroed;
    ``mask``: (B, H, W, 1), 1 = regenerate. Each layer's conv output is
    recorded before its ReLU; a later layer of the same shape replaces an
    earlier one's entry, as in the JAX package."""
    x = torch.cat([masked_image.to(mask.dtype), mask], dim=-1).to(
        p["layers"][0]["kernel"].dtype)
    feats = {}
    for layer in p["layers"]:
        if layer["kernel"].shape[-1] == 4:  # 4x4 stride 2, padded 1 a side
            x = conv2d(layer, F.pad(x, (0, 0, 1, 1, 1, 1)), stride=2,
                       padding="VALID")
        else:
            x = conv2d(layer, x)
        feats[(x.shape[-1], x.shape[1], x.shape[2])] = x
        x = torch.relu(x)
    return feats


def vae_encode(params, cfg: VAEConfig, images: torch.Tensor,
               eps: Optional[torch.Tensor] = None,
               sample_mode: str = "sample",
               conv_impl: str = "xla") -> torch.Tensor:
    """images (B, H, W, 3) in [-1, 1] -> latents (B, H/8, W/8, 4) scaled by
    ``scaling_factor``. The encoder computes in the images' dtype (the
    weights are cast to it, as in the JAX package), the posterior moments
    in fp32 with logvar clipped to [-30, 20]. ``sample_mode`` "sample"
    returns mean + std * ``eps``, where ``eps`` (B, H/8, W/8, 4) is the
    caller's standard-normal draw (the pipeline's per-sample generators);
    "argmax" returns the mean."""
    if sample_mode not in ("sample", "argmax"):
        raise ValueError(f"sample_mode must be 'sample' or 'argmax', got "
                         f"{sample_mode!r}")
    if sample_mode == "sample" and eps is None:
        raise ValueError("sample_mode='sample' needs the posterior noise eps")
    conv_impl = check_conv_impl(conv_impl)
    enc = params["encoder"]
    g = cfg.norm_num_groups
    h = conv2d(enc["conv_in"], images)
    for block in enc["down_blocks"]:
        for r in block["resnets"]:
            h = _resnet_apply(r, h, g, conv_impl)
        if "downsample" in block:
            # padded (0, 1) on H and W, then a VALID stride-2 conv
            h = conv2d(block["downsample"], F.pad(h, (0, 0, 0, 1, 0, 1)),
                       stride=2, padding="VALID")
    h = _mid_apply(enc["mid"], h, g, conv_impl)
    h = silu(group_norm(enc["conv_norm_out"], h, g, 1e-6))
    h = conv2d(enc["conv_out"], h)
    moments = conv2d(enc["quant_conv"], h, padding="VALID").float()
    mean, logvar = moments.chunk(2, dim=-1)
    if sample_mode == "sample":
        std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
        z = mean + std * eps.to(device=mean.device, dtype=torch.float32)
    else:
        z = mean
    return z * cfg.scaling_factor


def vae_decode(params, cfg: VAEConfig, latents: torch.Tensor,
               cond_image: Optional[torch.Tensor] = None,
               cond_mask: Optional[torch.Tensor] = None,
               conv_impl: str = "xla") -> torch.Tensor:
    """latents (B, h, w, 4), *scaled*; returns images (B, 8h, 8w, 3) in
    [-1, 1], fp32.

    Asymmetric (mask-conditioned) decode: with an asymmetric VAE,
    ``cond_image`` (the init image with the regenerate region zeroed) and
    ``cond_mask`` ((B, H, W, 1), 1 = regenerate), the condition encoder's
    features are blended in before every up block and before the output
    norm, ``h * m + feature * (1 - m)`` with the mask shrunk to the scale
    by nearest resizing, wherever a feature has the scale's shape."""
    conv_impl = check_conv_impl(conv_impl)
    dec = params["decoder"]
    g = cfg.norm_num_groups
    z = (latents / cfg.scaling_factor).to(dec["conv_in"]["kernel"].dtype)
    feats = None
    if cond_image is not None and cond_mask is not None:
        if "condition_encoder" not in dec:
            raise ValueError("a conditioned decode needs an asymmetric VAE "
                             "(cfg.asymmetric=True)")
        feats = mask_condition_encoder_apply(dec["condition_encoder"],
                                             cond_image, cond_mask)

    def blend(h):
        key = (h.shape[-1], h.shape[1], h.shape[2])
        if feats is None or key not in feats:
            return h
        m = resize_latents(cond_mask.float(), h.shape[1], h.shape[2],
                           mode="nearest").to(h.dtype)
        return h * m + feats[key].to(h.dtype) * (1.0 - m)

    h = conv2d(dec["post_quant_conv"], z, padding="VALID")
    h = conv2d(dec["conv_in"], h)
    h = _mid_apply(dec["mid"], h, g, conv_impl)
    for block in dec["up_blocks"]:
        h = blend(h)
        for r in block["resnets"]:
            h = _resnet_apply(r, h, g, conv_impl)
        if "upsample" in block:
            h = conv2d(block["upsample"], upsample_nearest2x(h))
    h = blend(h)
    h = silu(group_norm(dec["conv_norm_out"], h, g, 1e-6))
    return conv2d(dec["conv_out"], h).float()
