"""DPT depth estimation, MiDaS 3.0 / Intel/dpt-large (port of
``models/dpt.py``).

The reference's "Depth" detector: a plain-ViT backbone (patch 16, pre-LN
layers), whose hidden states after ``backbone_out_indices`` are reassembled
(readout projection of the CLS token, 1x1 projection, x4 / x2 / x1 / x0.5
resampling), projected to the fusion width, fused coarse to fine with
pre-activation residual units and align-corners 2x upsampling, and decoded
by the three-conv depth head. The weights keep the transformers
``DPTForDepthEstimation`` layout; the parameters are its tensors by name
(fp32, on the device). The attention is plain
``scaled_dot_product_attention``, as the JAX package's is plain XLA
(``jax.nn.dot_product_attention``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize, resize_bilinear_align_corners
from . import _nets as N


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    """Defaults = Intel/dpt-large (MiDaS 3.0)."""

    image_size: int = 384
    patch_size: int = 16
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    backbone_out_indices: Tuple[int, ...] = (5, 11, 17, 23)
    neck_hidden_sizes: Tuple[int, ...] = (256, 512, 1024, 1024)
    reassemble_factors: Tuple[float, ...] = (4.0, 2.0, 1.0, 0.5)
    fusion_hidden_size: int = 256
    layer_norm_eps: float = 1e-12


#: the weightless "Depth" fallback of the app (JAX api.py's small config)
DPT_FALLBACK = DPTConfig(
    image_size=256, patch_size=16, hidden_size=64, num_layers=4,
    num_heads=4, intermediate_size=128, backbone_out_indices=(0, 1, 2, 3),
    neck_hidden_sizes=(32, 48, 64, 64), fusion_hidden_size=32)

_FUS = "neck.fusion_stage.layers"
_RE = "neck.reassemble_stage"


def random_state_dict(cfg: DPTConfig = DPTConfig(), seed: int = 0
                      ) -> Dict[str, np.ndarray]:
    d = N.Draw(seed)
    h, grid = cfg.hidden_size, cfg.image_size // cfg.patch_size
    d.array("dpt.embeddings.cls_token", (1, 1, h), 0.02)
    d.array("dpt.embeddings.position_embeddings", (1, grid * grid + 1, h),
            0.02)
    d.conv("dpt.embeddings.patch_embeddings.projection", h, 3,
           cfg.patch_size)
    for i in range(cfg.num_layers):
        pre = f"dpt.encoder.layer.{i}"
        d.norm(f"{pre}.layernorm_before", h)
        for n in ("query", "key", "value"):
            d.linear(f"{pre}.attention.attention.{n}", h, h)
        d.linear(f"{pre}.attention.output.dense", h, h)
        d.norm(f"{pre}.layernorm_after", h)
        d.linear(f"{pre}.intermediate.dense", cfg.intermediate_size, h)
        d.linear(f"{pre}.output.dense", h, cfg.intermediate_size)
    f = cfg.fusion_hidden_size
    for i, (c, factor) in enumerate(zip(cfg.neck_hidden_sizes,
                                        cfg.reassemble_factors)):
        d.linear(f"{_RE}.readout_projects.{i}.0", h, 2 * h)
        d.conv(f"{_RE}.layers.{i}.projection", c, h, 1)
        if factor > 1:
            d.conv_transpose(f"{_RE}.layers.{i}.resize", c, c, int(factor))
        elif factor < 1:
            d.conv(f"{_RE}.layers.{i}.resize", c, c, 3)
        d.conv(f"neck.convs.{i}", f, c, 3, bias=False)
        d.conv(f"{_FUS}.{i}.projection", f, f, 1)
        for r in (1, 2):
            for j in (1, 2):
                d.conv(f"{_FUS}.{i}.residual_layer{r}.convolution{j}", f, f,
                       3)
    d.conv("head.head.0", f // 2, f, 3)
    d.conv("head.head.2", 32, f // 2, 3)
    d.conv("head.head.4", 1, 32, 1)
    return d.sd


def convert_dpt(sd, cfg: DPTConfig = DPTConfig(), device=None
                ) -> Dict[str, torch.Tensor]:
    """``sd``: a DPTForDepthEstimation (plain-ViT) state dict -> its
    tensors in fp32 on ``device``; the converter's only shape work is the
    CLS token and the position table."""
    p = N.tensors(sd, device)
    d = cfg.hidden_size
    p["dpt.embeddings.cls_token"] = p["dpt.embeddings.cls_token"].reshape(d)
    p["dpt.embeddings.position_embeddings"] = \
        p["dpt.embeddings.position_embeddings"][0]
    return p


def _residual(p, pre, x):
    """Pre-activation residual conv unit (DPTPreActResidualLayer)."""
    h = N.conv_named(p, f"{pre}.convolution1", F.relu(x))
    h = N.conv_named(p, f"{pre}.convolution2", F.relu(h))
    return x + h


def _up2_ac(x):
    """2x bilinear upsampling of NCHW with align_corners=True."""
    return N.nchw(resize_bilinear_align_corners(N.nhwc(x), 2 * x.shape[2],
                                                2 * x.shape[3]))


def dpt_apply(params, cfg: DPTConfig, pixels: torch.Tensor) -> torch.Tensor:
    """pixels: (B, H, W, 3), (x - 0.5) / 0.5 normalized. Returns the
    predicted inverse depth (B, H, W) (H, W multiples of the patch)."""
    p = params
    ph, pw = pixels.shape[1] // cfg.patch_size, pixels.shape[2] // \
        cfg.patch_size
    d = cfg.hidden_size
    h = N.conv_named(p, "dpt.embeddings.patch_embeddings.projection",
                     N.nchw(pixels.float()), stride=cfg.patch_size,
                     padding=0)
    b = h.shape[0]
    tokens = h.flatten(2).transpose(1, 2)
    cls = p["dpt.embeddings.cls_token"].expand(b, 1, d)
    tokens = torch.cat([cls, tokens], dim=1)
    pos = p["dpt.embeddings.position_embeddings"]
    grid = int(round((pos.shape[0] - 1) ** 0.5))
    if (ph, pw) != (grid, grid):
        pos_grid = resize(pos[1:].reshape(1, grid, grid, d), (1, ph, pw, d),
                          "linear")
        pos = torch.cat([pos[:1], pos_grid.reshape(ph * pw, d)])
    x = tokens + pos[None]

    wanted = set(cfg.backbone_out_indices)
    feats: List[torch.Tensor] = []
    eps, heads = cfg.layer_norm_eps, cfg.num_heads
    for i in range(cfg.num_layers):
        pre = f"dpt.encoder.layer.{i}"
        hn = F.layer_norm(x, (d,), p[f"{pre}.layernorm_before.weight"],
                          p[f"{pre}.layernorm_before.bias"], eps)

        def split(t):
            return t.reshape(b, t.shape[1], heads, -1).transpose(1, 2)

        q, k, v = (split(N.lin(p, f"{pre}.attention.attention.{n}", hn))
                   for n in ("query", "key", "value"))
        att = F.scaled_dot_product_attention(q, k, v)
        att = att.transpose(1, 2).reshape(b, -1, d)
        x = x + N.lin(p, f"{pre}.attention.output.dense", att)
        hn = F.layer_norm(x, (d,), p[f"{pre}.layernorm_after.weight"],
                          p[f"{pre}.layernorm_after.bias"], eps)
        x = x + N.lin(p, f"{pre}.output.dense", F.gelu(
            N.lin(p, f"{pre}.intermediate.dense", hn)))
        if i in wanted:
            feats.append(x)

    necked = []
    for i, (feat, factor) in enumerate(zip(feats, cfg.reassemble_factors)):
        fm = feat[:, 1:].reshape(b, ph, pw, d)
        readout = feat[:, 0][:, None, None].expand(fm.shape)
        fm = F.gelu(N.lin(p, f"{_RE}.readout_projects.{i}.0",
                          torch.cat([fm, readout], dim=-1)))
        fm = N.conv_named(p, f"{_RE}.layers.{i}.projection", N.nchw(fm))
        if factor > 1:
            fm = F.conv_transpose2d(fm, p[f"{_RE}.layers.{i}.resize.weight"],
                                    p[f"{_RE}.layers.{i}.resize.bias"],
                                    stride=int(factor))
        elif factor < 1:
            fm = N.conv_named(p, f"{_RE}.layers.{i}.resize", fm, stride=2,
                              padding=1)
        necked.append(N.conv(fm, p[f"neck.convs.{i}.weight"], padding=1))

    fused = None
    for i in reversed(range(len(necked))):
        feat = necked[i]
        if fused is None:
            fused = feat
        else:
            res = feat
            if res.shape[2:] != fused.shape[2:]:
                res = N.nchw(resize(N.nhwc(res), (
                    res.shape[0], fused.shape[2], fused.shape[3],
                    res.shape[1]), "linear"))
            fused = fused + _residual(p, f"{_FUS}.{i}.residual_layer1", res)
        fused = _residual(p, f"{_FUS}.{i}.residual_layer2", fused)
        fused = N.conv_named(p, f"{_FUS}.{i}.projection", _up2_ac(fused))

    out = _up2_ac(N.conv_named(p, "head.head.0", fused))
    out = F.relu(N.conv_named(p, "head.head.2", out))
    out = F.relu(N.conv_named(p, "head.head.4", out))
    return out[:, 0]


def depth_to_control_image(depth: torch.Tensor) -> torch.Tensor:
    """(B, H, W) inverse depth -> (B, H, W, 3) control image in [0, 1]
    (per-image min-max normalization, the MiDaS detector's)."""
    lo = depth.amin(dim=(1, 2), keepdim=True)
    hi = depth.amax(dim=(1, 2), keepdim=True)
    norm = (depth - lo) / torch.clamp(hi - lo, min=1e-8)
    return norm[..., None].expand(*norm.shape, 3)
