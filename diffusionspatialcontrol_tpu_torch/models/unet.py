"""UNet2DCondition for the SD1.x/2.x family (port of ``models/unet.py``).

The main path of the JAX package's ``unet_apply``: time embedding, the fused
per-resnet time projections, resnets on the ``conv_impl`` branch the caller
names ("xla": plain convs; "xla_bf16": plain convs with their output
rounded to the compute dtype before the bias; "pallas"/"pallas2": the fused
GN+SiLU+conv kernels K4/K5, see ``layers.resnet_fused``), transformers with
self-attention, region-biased or plain cross-attention and a GEGLU
feed-forward, down/up sampling and skips.
Activations are NHWC; attention operands are (B, L, H, D).

``attn_impl`` takes the JAX package's kernel strings,
``"pallas[+qkbf16][+pvbf16][+exp2]"``: attention always goes through the
hand-written kernels of ``ops/kernels`` (their plain versions on CPU
tensors). Any other value raises; there is no plain attention path for
CUDA tensors.

The SD1.x (conv projections, quick_gelu CLIP) and SD2.x (linear
projections, 64-wide heads) topologies and the 9-channel inpaint UNet
(``in_channels=9``) run here, with ControlNet and T2I-Adapter residuals
added where the JAX package adds them (``UNetCond``).

Not ported yet (passing them raises): FreeU, IP-Adapter, heatmaps, TGATE
caching and DeepCache.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import UNetConfig
from ..ops.kernels.flash_attention import flash_attention_nlhd
from ..ops.kernels.region_attention import region_attention_nlhd
from .layers import (
    FUSED_CONV_IMPLS,
    check_conv_impl,
    conv2d,
    conv_init,
    group_norm,
    layer_norm,
    linear,
    linear_init,
    norm_init,
    resnet_fused,
    silu,
    timestep_embedding,
    upsample_nearest2x,
)


@dataclasses.dataclass
class RegionState:
    """Region-bias tensors per resolution level plus the current noise sigma
    (a 0-d tensor). ``biases[i]`` is (B, H/8/2^i * W/8/2^i, S_text)."""

    biases: Tuple[torch.Tensor, ...]
    sigma: torch.Tensor


@dataclasses.dataclass
class UNetCond:
    """Conditioning of one UNet forward."""

    context: torch.Tensor  # (B, S, cross_dim) text embeddings
    region: Optional[RegionState] = None
    # ControlNet: one residual a skip (12 for SD1.5, conv_in's included)
    # and one for the mid block, NHWC, already scaled.
    controlnet_down: Optional[Tuple[torch.Tensor, ...]] = None
    controlnet_mid: Optional[torch.Tensor] = None
    # T2I-Adapter: one residual a down block, NHWC.
    t2i_residuals: Optional[Tuple[torch.Tensor, ...]] = None


# ---------------------------------------------------------------------------
# Init (same tree, names and per-tensor shapes as the JAX package, in the
# port's layouts: see layers.py)
# ---------------------------------------------------------------------------


def _resnet_init(g, in_c, out_c, temb_dim, dtype, device):
    p = {
        "norm1": norm_init(in_c, dtype, device),
        "conv1": conv_init(g, in_c, out_c, 3, dtype, device),
        "time_emb_proj": linear_init(g, temb_dim, out_c, dtype=dtype,
                                     device=device),
        "norm2": norm_init(out_c, dtype, device),
        "conv2": conv_init(g, out_c, out_c, 3, dtype, device),
    }
    if in_c != out_c:
        p["conv_shortcut"] = conv_init(g, in_c, out_c, 1, dtype, device)
    return p


def _attention_init(g, query_dim, context_dim, dtype, device):
    def lin(i, o, bias):
        return linear_init(g, i, o, bias=bias, dtype=dtype, device=device)

    return {"to_q": lin(query_dim, query_dim, False),
            "to_k": lin(context_dim, query_dim, False),
            "to_v": lin(context_dim, query_dim, False),
            "to_out": lin(query_dim, query_dim, True)}


def _transformer_init(g, cfg: UNetConfig, channels, dtype, device):
    if cfg.use_linear_projection:
        proj_in = linear_init(g, channels, channels, dtype=dtype,
                              device=device)
        proj_out = linear_init(g, channels, channels, dtype=dtype,
                               device=device)
    else:
        proj_in = conv_init(g, channels, channels, 1, dtype, device)
        proj_out = conv_init(g, channels, channels, 1, dtype, device)
    blocks = []
    for _ in range(cfg.transformer_layers_per_block):
        blocks.append({
            "norm1": norm_init(channels, dtype, device),
            "attn1": _attention_init(g, channels, channels, dtype, device),
            "norm2": norm_init(channels, dtype, device),
            "attn2": _attention_init(g, channels, cfg.cross_attention_dim,
                                     dtype, device),
            "norm3": norm_init(channels, dtype, device),
            "ff": {  # GEGLU
                "proj_in": linear_init(g, channels, channels * 8,
                                       dtype=dtype, device=device),
                "proj_out": linear_init(g, channels * 4, channels,
                                        dtype=dtype, device=device),
            },
        })
    return {"norm": norm_init(channels, dtype, device), "proj_in": proj_in,
            "blocks": blocks, "proj_out": proj_out}


def _up_skip_channels(cfg: UNetConfig, level: int) -> List[int]:
    """Channels of the skips consumed by up-block ``level``, in consumption
    order (LIFO from the down path)."""
    stack: List[int] = [cfg.block_out_channels[0]]
    for lv, out_c in enumerate(cfg.block_out_channels):
        stack.extend([out_c] * cfg.layers_per_block)
        if lv < cfg.num_levels - 1:
            stack.append(out_c)
    n_before = (cfg.num_levels - 1 - level) * (cfg.layers_per_block + 1)
    start = len(stack) - n_before - (cfg.layers_per_block + 1)
    return list(reversed(stack[start: start + cfg.layers_per_block + 1]))


def unet_init(g: torch.Generator, cfg: UNetConfig, dtype=torch.bfloat16,
              device=None) -> Dict[str, Any]:
    temb_dim = cfg.time_embed_dim
    b0 = cfg.block_out_channels[0]
    params: Dict[str, Any] = {
        "conv_in": conv_init(g, cfg.in_channels, b0, 3, dtype, device),
        "time_embedding": {
            "linear_1": linear_init(g, b0, temb_dim, dtype=dtype,
                                    device=device),
            "linear_2": linear_init(g, temb_dim, temb_dim, dtype=dtype,
                                    device=device),
        },
    }
    down = []
    in_c = b0
    for level, out_c in enumerate(cfg.block_out_channels):
        block = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block):
            block["resnets"].append(_resnet_init(
                g, in_c if j == 0 else out_c, out_c, temb_dim, dtype, device))
            if cfg.attn_levels[level]:
                block["attentions"].append(
                    _transformer_init(g, cfg, out_c, dtype, device))
        if level < cfg.num_levels - 1:
            block["downsample"] = conv_init(g, out_c, out_c, 3, dtype, device)
        down.append(block)
        in_c = out_c
    params["down_blocks"] = down

    mid_c = cfg.block_out_channels[-1]
    params["mid_block"] = {
        "resnet1": _resnet_init(g, mid_c, mid_c, temb_dim, dtype, device),
        "attention": _transformer_init(g, cfg, mid_c, dtype, device),
        "resnet2": _resnet_init(g, mid_c, mid_c, temb_dim, dtype, device),
    }

    up = []
    rev_channels = list(reversed(cfg.block_out_channels))
    for i, out_c in enumerate(rev_channels):
        level = cfg.num_levels - 1 - i
        prev_c = rev_channels[max(i - 1, 0)]
        skip_cs = _up_skip_channels(cfg, level)
        block = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block + 1):
            res_in = prev_c if j == 0 else out_c
            block["resnets"].append(_resnet_init(
                g, res_in + skip_cs[j], out_c, temb_dim, dtype, device))
            if cfg.attn_levels[level]:
                block["attentions"].append(
                    _transformer_init(g, cfg, out_c, dtype, device))
        if i < cfg.num_levels - 1:
            block["upsample"] = conv_init(g, out_c, out_c, 3, dtype, device)
        up.append(block)
    params["up_blocks"] = up

    params["conv_norm_out"] = norm_init(b0, dtype, device)
    params["conv_out"] = conv_init(g, b0, cfg.out_channels, 3, dtype, device)
    return params


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _temb_projections(resnets, temb):
    """Every resnet's ``linear(time_emb_proj, silu(temb))`` as ONE GEMM over
    the concatenated kernels, sliced back per resnet (the same math batched
    on N)."""
    kernels = [r["time_emb_proj"]["kernel"] for r in resnets]
    fused = {"kernel": torch.cat(kernels, dim=0),
             "bias": torch.cat([r["time_emb_proj"]["bias"] for r in resnets])}
    t_all = linear(fused, silu(temb))
    return list(torch.split(t_all, [k.shape[0] for k in kernels], dim=1))


def _resnet_apply(p, x, groups, eps, t, conv_impl="xla"):
    if conv_impl in FUSED_CONV_IMPLS:
        return resnet_fused(p, x, groups, eps, conv_impl, t)
    rnd = conv_impl == "xla_bf16"
    h = silu(group_norm(p["norm1"], x, groups, eps))
    h = conv2d(p["conv1"], h, round_before_bias=rnd)
    h = h + t[:, None, None, :].to(h.dtype)
    h = silu(group_norm(p["norm2"], h, groups, eps))
    h = conv2d(p["conv2"], h, round_before_bias=rnd)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding="VALID",
                   round_before_bias=rnd)
    return x + h


def _heads_split(x, heads):
    """(B, L, H*D) -> (B, L, H, D): a view, no copy."""
    b, l, d = x.shape
    return x.reshape(b, l, heads, d // heads)


def _heads_merge(x):
    b, l, h, d = x.shape
    return x.reshape(b, l, h * d)


def flash_options(attn_impl: str) -> dict:
    """K2's options from ``attn_impl="pallas[+qkbf16][+pvbf16][+exp2]"``.

    ``+qkbf16`` is accepted and selects nothing: in the Pallas kernel it only
    skips the cast of Q and K to fp32 before an fp32-accumulated QK^T, and
    K2 and its plain version always form QK^T in fp32 from the operands' own
    values."""
    base, *suffixes = attn_impl.split("+")
    unknown = set(suffixes) - {"qkbf16", "pvbf16", "exp2"}
    if base != "pallas" or unknown:
        raise ValueError(
            f"attn_impl={attn_impl!r}: the port takes "
            f"'pallas[+qkbf16][+pvbf16][+exp2]' (attention runs only "
            f"through its kernels)")
    return {"pv_bf16": "pvbf16" in suffixes, "use_exp2": "exp2" in suffixes}


def _self_attention(p, x, heads, flash_opts):
    q = _heads_split(linear(p["to_q"], x), heads)
    k = _heads_split(linear(p["to_k"], x), heads)
    v = _heads_split(linear(p["to_v"], x), heads)
    out = flash_attention_nlhd(q, k, v, **flash_opts)
    return linear(p["to_out"], _heads_merge(out))


def _cross_attention(p, x, cond: UNetCond, level: int, heads, flash_opts):
    q = _heads_split(linear(p["to_q"], x), heads)
    k = _heads_split(linear(p["to_k"], cond.context), heads)
    v = _heads_split(linear(p["to_v"], cond.context), heads)
    if cond.region is not None:
        out = region_attention_nlhd(q, k, v, cond.region.biases[level],
                                    cond.region.sigma)
    else:
        out = flash_attention_nlhd(q, k, v, **flash_opts)
    return linear(p["to_out"], _heads_merge(out))


def _geglu_ff(p, x):
    val, gate = linear(p["proj_in"], x).chunk(2, dim=-1)
    return linear(p["proj_out"], val * F.gelu(gate, approximate="none"))


def _transformer_apply(p, cfg: UNetConfig, x, cond: UNetCond, level: int,
                       heads, flash_opts):
    b, hh, ww, c = x.shape
    residual = x
    h = group_norm(p["norm"], x, cfg.norm_num_groups, 1e-6)
    if cfg.use_linear_projection:
        h = linear(p["proj_in"], h.reshape(b, hh * ww, c))
    else:
        h = conv2d(p["proj_in"], h, padding="VALID").reshape(b, hh * ww, c)

    for bp in p["blocks"]:
        h = h + _self_attention(bp["attn1"], layer_norm(bp["norm1"], h),
                                heads, flash_opts)
        xo = _cross_attention(bp["attn2"], layer_norm(bp["norm2"], h), cond,
                              level, heads, flash_opts)
        h = h + xo.to(h.dtype)
        h = h + _geglu_ff(bp["ff"], layer_norm(bp["norm3"], h))

    if cfg.use_linear_projection:
        h = linear(p["proj_out"], h).reshape(b, hh, ww, c)
    else:
        h = conv2d(p["proj_out"], h.reshape(b, hh, ww, c), padding="VALID")
    return h + residual


def unet_apply(params: Dict[str, Any], cfg: UNetConfig,
               sample: torch.Tensor, timesteps: torch.Tensor,
               cond: UNetCond, attn_impl: str = "pallas",
               conv_impl: Optional[str] = None, **unsupported):
    """UNet forward: sample (B, H, W, C) NHWC, timesteps (B,) possibly
    fractional. Returns the eps / v prediction (B, H, W, out_channels).

    ``cond``'s T2I residuals are added after the last layer of each down
    block (before its downsample, so the skip carries them), its ControlNet
    residuals to every skip after the down path and after the mid block's
    second resnet, each cast to the activations' dtype at the add."""
    if unsupported and any(v not in (None, False)
                           for v in unsupported.values()):
        raise NotImplementedError(
            f"not ported yet: {sorted(unsupported)} (FreeU, IP-Adapter, "
            f"DeepCache, TGATE and heatmaps come later)")
    conv_impl = check_conv_impl(conv_impl)
    flash_opts = flash_options(attn_impl)
    groups, eps_ = cfg.norm_num_groups, cfg.norm_eps

    temb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                              cfg.flip_sin_to_cos, cfg.freq_shift)
    temb = linear(params["time_embedding"]["linear_1"],
                  temb.to(sample.dtype))
    temb = linear(params["time_embedding"]["linear_2"], silu(temb))

    res_order = [r for blk in params["down_blocks"] for r in blk["resnets"]]
    res_order += [params["mid_block"]["resnet1"],
                  params["mid_block"]["resnet2"]]
    res_order += [r for blk in params["up_blocks"] for r in blk["resnets"]]
    t_it = iter(_temb_projections(res_order, temb))

    h = conv2d(params["conv_in"], sample)
    skips = [h]
    t2i = list(cond.t2i_residuals or ())
    for level, block in enumerate(params["down_blocks"]):
        n_res = len(block["resnets"])
        for j in range(n_res):
            h = _resnet_apply(block["resnets"][j], h, groups, eps_,
                              next(t_it), conv_impl)
            if block["attentions"]:
                h = _transformer_apply(block["attentions"][j], cfg, h, cond,
                                       level, cfg.heads_at(level), flash_opts)
            if j == n_res - 1 and t2i:
                h = h + t2i.pop(0).to(h.dtype)
            skips.append(h)
        if "downsample" in block:
            h = conv2d(block["downsample"], h, stride=2)
            skips.append(h)
    if cond.controlnet_down is not None:
        skips = [s + r.to(s.dtype)
                 for s, r in zip(skips, cond.controlnet_down)]

    mid = params["mid_block"]
    top = cfg.num_levels - 1
    h = _resnet_apply(mid["resnet1"], h, groups, eps_, next(t_it),
                      conv_impl)
    h = _transformer_apply(mid["attention"], cfg, h, cond, top,
                           cfg.heads_at(top), flash_opts)
    h = _resnet_apply(mid["resnet2"], h, groups, eps_, next(t_it),
                      conv_impl)
    if cond.controlnet_mid is not None:
        h = h + cond.controlnet_mid.to(h.dtype)

    for i, block in enumerate(params["up_blocks"]):
        level = cfg.num_levels - 1 - i
        for j in range(len(block["resnets"])):
            h = torch.cat([h, skips.pop()], dim=-1)
            h = _resnet_apply(block["resnets"][j], h, groups, eps_,
                              next(t_it), conv_impl)
            if block["attentions"]:
                h = _transformer_apply(block["attentions"][j], cfg, h, cond,
                                       level, cfg.heads_at(level), flash_opts)
        if "upsample" in block:
            h = conv2d(block["upsample"], upsample_nearest2x(h))

    h = silu(group_norm(params["conv_norm_out"], h, groups, eps_))
    return conv2d(params["conv_out"], h)
