"""ControlNet: a copy of the UNet's down path and mid block with zero-conv
heads (port of ``models/controlnet.py``).

``controlnet_init`` builds the JAX package's tree (names and per-tensor
shapes, in the port's layouts) with the heads zero: the cond embedding's
``conv_out``, the ``zero_convs`` (one a skip of the UNet, ``conv_in``'s
included: 12 for SD1.5) and ``mid_zero_conv``, so a fresh ControlNet is an
exact no-op. ``controlnet_apply`` returns the scaled residuals that
``unet_apply`` adds to its skips and after its mid block.

As in the JAX package, the trunk's resnets always run the unfused "xla"
convs, whatever ``conv_impl`` the request names, and no region map reaches
it. Its attentions run K2 with its default options (the JAX package runs
them as plain XLA attention; the port has no plain attention for CUDA
tensors, so there the two differ by rounding only).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from ..config import ControlNetConfig, UNetConfig
from .layers import (
    conv2d,
    conv_init,
    linear,
    linear_init,
    silu,
    timestep_embedding,
)
from .unet import (
    UNetCond,
    _resnet_apply,
    _resnet_init,
    _temb_projections,
    _transformer_apply,
    _transformer_init,
    flash_options,
)

# K2 with its default options, whatever the request's attn_impl suffixes
_FLASH_DEFAULT = flash_options("pallas")


def controlnet_init(g: torch.Generator, unet_cfg: UNetConfig,
                    cn_cfg: ControlNetConfig = ControlNetConfig(),
                    dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    temb_dim = unet_cfg.time_embed_dim
    b0 = unet_cfg.block_out_channels[0]

    def conv(i, o, k, zero=False):
        return conv_init(g, i, o, k, dtype, device, zero=zero)

    params: Dict[str, Any] = {
        "conv_in": conv(unet_cfg.in_channels, b0, 3),
        "time_embedding": {
            "linear_1": linear_init(g, b0, temb_dim, dtype=dtype,
                                    device=device),
            "linear_2": linear_init(g, temb_dim, temb_dim, dtype=dtype,
                                    device=device),
        },
    }

    # conditioning embedding: image -> b0 channels at the latent size
    ce_ch = cn_cfg.conditioning_embedding_out_channels
    ce: Dict[str, Any] = {
        "conv_in": conv(cn_cfg.conditioning_channels, ce_ch[0], 3),
        "blocks": [],
        "conv_out": conv(ce_ch[-1], b0, 3, zero=True),
    }
    for i in range(len(ce_ch) - 1):
        ce["blocks"].append(conv(ce_ch[i], ce_ch[i], 3))
        ce["blocks"].append(conv(ce_ch[i], ce_ch[i + 1], 3))
    params["cond_embedding"] = ce

    # the down path, the UNet's topology
    down = []
    zero_convs = [conv(b0, b0, 1, zero=True)]
    in_c = b0
    for level, out_c in enumerate(unet_cfg.block_out_channels):
        block = {"resnets": [], "attentions": []}
        for j in range(unet_cfg.layers_per_block):
            block["resnets"].append(_resnet_init(
                g, in_c if j == 0 else out_c, out_c, temb_dim, dtype,
                device))
            if unet_cfg.attn_levels[level]:
                block["attentions"].append(
                    _transformer_init(g, unet_cfg, out_c, dtype, device))
            zero_convs.append(conv(out_c, out_c, 1, zero=True))
        if level < unet_cfg.num_levels - 1:
            block["downsample"] = conv(out_c, out_c, 3)
            zero_convs.append(conv(out_c, out_c, 1, zero=True))
        down.append(block)
        in_c = out_c
    params["down_blocks"] = down
    params["zero_convs"] = zero_convs

    mid_c = unet_cfg.block_out_channels[-1]
    params["mid_block"] = {
        "resnet1": _resnet_init(g, mid_c, mid_c, temb_dim, dtype, device),
        "attention": _transformer_init(g, unet_cfg, mid_c, dtype, device),
        "resnet2": _resnet_init(g, mid_c, mid_c, temb_dim, dtype, device),
    }
    params["mid_zero_conv"] = conv(mid_c, mid_c, 1, zero=True)
    return params


def check_input_channels(params: Dict[str, Any], channels: int) -> None:
    """Raise ``ValueError`` unless the ControlNet's ``conv_in`` takes
    ``channels``, the latent channels it is fed (the denoiser checks before
    sampling)."""
    want = params["conv_in"]["kernel"].shape[1]
    if want != channels:
        raise ValueError(
            f"the ControlNet's conv_in takes {want} channels but is fed the "
            f"{channels} latent channels (the scaled latents, never a "
            f"9-channel inpaint UNet's input): a ControlNet built for an "
            f"in_channels={want} UNet cannot run (it fails in the JAX "
            f"package too)")


def controlnet_cond_embedding(params: Dict[str, Any],
                              cond_image: torch.Tensor,
                              dtype: torch.dtype) -> torch.Tensor:
    """The conditioning image (B, 8h, 8w, 3) in [0, 1] -> (B, h, w, b0)
    features, in ``dtype`` (the latents' compute dtype). Its stride-2 convs
    pad as XLA's "SAME" does, (0, 1)."""
    ce = params["cond_embedding"]
    c = silu(conv2d(ce["conv_in"], cond_image.to(dtype)))
    for i, blk in enumerate(ce["blocks"]):
        c = silu(conv2d(blk, c, stride=2 if i % 2 == 1 else 1))
    return conv2d(ce["conv_out"], c)


def _scaled(r: torch.Tensor, scale) -> torch.Tensor:
    """``r * scale`` as JAX promotes it: a tensor scale is an fp32 array,
    which lifts a bf16 residual to fp32 (a 0-d fp32 tensor does not in
    PyTorch); a Python number keeps the residual's dtype."""
    return r.float() * scale if torch.is_tensor(scale) else r * scale


def controlnet_apply(
    params: Dict[str, Any],
    unet_cfg: UNetConfig,
    sample: torch.Tensor,  # (B, h, w, 4) scaled latents (x * c_in)
    timesteps: torch.Tensor,  # (B,)
    context: torch.Tensor,  # (B, S, D)
    cond_embedding: torch.Tensor,  # (B, h, w, b0)
    conditioning_scale: Union[float, torch.Tensor] = 1.0,
    guess_mode: bool = False,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """(down residuals, one a skip of the UNet, conv_in's included; the mid
    residual), scaled by ``conditioning_scale``, and in guess mode also by
    ``logspace(-1, 0)`` over the down residuals then the mid one.

    ``cond_embedding`` is ``controlnet_cond_embedding`` of the control
    image, which the caller computes once (it depends on the image and the
    weights only; the JAX package's ``controlnet_apply`` takes the image and
    embeds it at every call)."""
    groups, eps_ = unet_cfg.norm_num_groups, unet_cfg.norm_eps
    cond = UNetCond(context=context)

    temb = timestep_embedding(timesteps, unet_cfg.block_out_channels[0],
                              unet_cfg.flip_sin_to_cos, unet_cfg.freq_shift)
    temb = linear(params["time_embedding"]["linear_1"],
                  temb.to(sample.dtype))
    temb = linear(params["time_embedding"]["linear_2"], silu(temb))

    # the fused time projections, in traversal order: the down resnets,
    # then the two of the mid block
    res_order = [r for blk in params["down_blocks"] for r in blk["resnets"]]
    res_order += [params["mid_block"]["resnet1"],
                  params["mid_block"]["resnet2"]]
    t_it = iter(_temb_projections(res_order, temb))

    h = conv2d(params["conv_in"], sample) + cond_embedding
    feats = [h]
    for level, block in enumerate(params["down_blocks"]):
        for j in range(len(block["resnets"])):
            h = _resnet_apply(block["resnets"][j], h, groups, eps_,
                              next(t_it))
            if block["attentions"]:
                h = _transformer_apply(block["attentions"][j], unet_cfg, h,
                                       cond, level, unet_cfg.heads_at(level),
                                       _FLASH_DEFAULT)
            feats.append(h)
        if "downsample" in block:
            h = conv2d(block["downsample"], h, stride=2)
            feats.append(h)

    mid = params["mid_block"]
    top = unet_cfg.num_levels - 1
    h = _resnet_apply(mid["resnet1"], h, groups, eps_, next(t_it))
    h = _transformer_apply(mid["attention"], unet_cfg, h, cond, top,
                           unet_cfg.heads_at(top), _FLASH_DEFAULT)
    h = _resnet_apply(mid["resnet2"], h, groups, eps_, next(t_it))

    down_res = [conv2d(zc, f, padding="VALID")
                for zc, f in zip(params["zero_convs"], feats)]
    mid_res = conv2d(params["mid_zero_conv"], h, padding="VALID")

    if guess_mode:
        ramp = torch.logspace(-1.0, 0.0, len(down_res) + 1,
                              dtype=torch.float32, device=sample.device)
        down_res = [r.float() * (s * conditioning_scale)
                    for r, s in zip(down_res, ramp[:-1])]
        mid_res = mid_res.float() * (ramp[-1] * conditioning_scale)
    else:
        down_res = [_scaled(r, conditioning_scale) for r in down_res]
        mid_res = _scaled(mid_res, conditioning_scale)
    return tuple(down_res), mid_res
