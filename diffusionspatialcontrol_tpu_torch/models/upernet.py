"""UperNet semantic segmentation on a ConvNeXt backbone (port of
``models/upernet.py``).

The reference's "Semantic Segmentation" detector (transformers'
UperNetForSemanticSegmentation, openmmlab/upernet-convnext-*): a ConvNeXt
backbone (stride-4 patchify, depthwise 7x7 blocks with layer scale,
per-stage output LayerNorms) and the UperNet head (PSP pooling on the
deepest map, FPN laterals, BatchNorm in eval mode), then the labels'
random-colour image. The weights keep the transformers layout; the
parameters are its tensors by name (fp32, on the device). The bilinear
resizes are torch's ``align_corners=False`` without antialiasing, sampled
as the JAX package samples them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _nets as N

ADE20K_NUM_LABELS = 150


@dataclasses.dataclass(frozen=True)
class UperNetConfig:
    """Defaults = openmmlab/upernet-convnext-tiny."""

    hidden_sizes: Tuple[int, ...] = (96, 192, 384, 768)
    depths: Tuple[int, ...] = (3, 3, 9, 3)
    head_channels: int = 512
    pool_scales: Tuple[int, ...] = (1, 2, 3, 6)
    num_labels: int = ADE20K_NUM_LABELS
    layer_norm_eps: float = 1e-6


#: the weightless "Semantic Segmentation" fallback of the app
UPERNET_FALLBACK = UperNetConfig(hidden_sizes=(32, 48, 64, 96),
                                 depths=(1, 1, 2, 1), head_channels=64)

_BB, _DH = "backbone", "decode_head"


def random_state_dict(cfg: UperNetConfig = UperNetConfig(), seed: int = 0
                      ) -> Dict[str, np.ndarray]:
    d = N.Draw(seed)
    hs, ch = cfg.hidden_sizes, cfg.head_channels
    d.conv(f"{_BB}.embeddings.patch_embeddings", hs[0], 3, 4)
    d.norm(f"{_BB}.embeddings.layernorm", hs[0])
    for s, (c, depth) in enumerate(zip(hs, cfg.depths)):
        pre = f"{_BB}.encoder.stages.{s}"
        if s > 0:
            d.norm(f"{pre}.downsampling_layer.0", hs[s - 1])
            d.conv(f"{pre}.downsampling_layer.1", c, hs[s - 1], 2)
        for i in range(depth):
            bp = f"{pre}.layers.{i}"
            d.conv(f"{bp}.dwconv", c, c, 7, groups=c)
            d.norm(f"{bp}.layernorm", c)
            d.linear(f"{bp}.pwconv1", 4 * c, c)
            d.linear(f"{bp}.pwconv2", c, 4 * c)
            d.array(f"{bp}.layer_scale_parameter", (c,), 0.5)
        d.norm(f"{_BB}.hidden_states_norms.stage{s + 1}", c)

    def cbr(pre, o, i, k):
        d.conv(f"{pre}.conv", o, i, k, bias=False)
        d.bn(f"{pre}.batch_norm", o)

    for i in range(len(cfg.pool_scales)):
        cbr(f"{_DH}.psp_modules.{i}.1", ch, hs[-1], 1)
    cbr(f"{_DH}.bottleneck", ch, hs[-1] + len(cfg.pool_scales) * ch, 3)
    for i, c in enumerate(hs[:-1]):
        cbr(f"{_DH}.lateral_convs.{i}", ch, c, 1)
        cbr(f"{_DH}.fpn_convs.{i}", ch, ch, 3)
    cbr(f"{_DH}.fpn_bottleneck", ch, len(hs) * ch, 3)
    d.conv(f"{_DH}.classifier", cfg.num_labels, ch, 1)
    return d.sd


def convert_upernet(sd, cfg: UperNetConfig = UperNetConfig(), device=None
                    ) -> Dict[str, torch.Tensor]:
    """``sd``: an UperNetForSemanticSegmentation (ConvNeXt) state dict ->
    its tensors in fp32 on ``device``."""
    return N.tensors(sd, device)


def _ln(p, name, x, eps):
    """LayerNorm over the channel axis of NHWC."""
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"],
                        p[f"{name}.bias"], eps)


def convnext_backbone_apply(p, cfg: UperNetConfig, pixels: torch.Tensor
                            ) -> List[torch.Tensor]:
    """pixels (B, H, W, 3) normalized -> the four NHWC feature maps at
    strides 4, 8, 16 and 32, each through its stage's output norm."""
    eps = cfg.layer_norm_eps
    h = N.nhwc(N.conv_named(p, f"{_BB}.embeddings.patch_embeddings",
                            N.nchw(pixels.float()), stride=4, padding=0))
    h = _ln(p, f"{_BB}.embeddings.layernorm", h, eps)
    feats = []
    for s, depth in enumerate(cfg.depths):
        pre = f"{_BB}.encoder.stages.{s}"
        if s > 0:
            h = _ln(p, f"{pre}.downsampling_layer.0", h, eps)
            h = N.nhwc(N.conv_named(p, f"{pre}.downsampling_layer.1",
                                    N.nchw(h), stride=2, padding=0))
        for i in range(depth):
            bp = f"{pre}.layers.{i}"
            y = N.nhwc(N.conv_named(p, f"{bp}.dwconv", N.nchw(h),
                                    groups=h.shape[-1]))
            y = _ln(p, f"{bp}.layernorm", y, eps)
            y = N.lin(p, f"{bp}.pwconv2", F.gelu(N.lin(p, f"{bp}.pwconv1",
                                                       y)))
            if f"{bp}.layer_scale_parameter" in p:
                y = y * p[f"{bp}.layer_scale_parameter"]
            h = h + y
        feats.append(_ln(p, f"{_BB}.hidden_states_norms.stage{s + 1}", h,
                         eps))
    return feats


def _cbr(p, pre, x, padding=0):
    """Conv (no bias), eval BatchNorm from its statistics, ReLU; NHWC."""
    h = N.nhwc(N.conv(N.nchw(x), p[f"{pre}.conv.weight"], padding=padding))
    bn = f"{pre}.batch_norm"
    scale = p[f"{bn}.weight"] / torch.sqrt(p[f"{bn}.running_var"] + 1e-5)
    h = h * scale + (p[f"{bn}.bias"] - p[f"{bn}.running_mean"] * scale)
    return F.relu(h)


def _adaptive_avg_pool(x, s: int):
    """AdaptiveAvgPool2d(s) of NHWC: bin i spans [floor(i H / s),
    ceil((i + 1) H / s))."""
    b, h, w, c = x.shape
    rows = []
    for i in range(s):
        y0, y1 = (i * h) // s, -(-((i + 1) * h) // s)
        cols = []
        for j in range(s):
            x0, x1 = (j * w) // s, -(-((j + 1) * w) // s)
            cols.append(x[:, y0:y1, x0:x1].mean(dim=(1, 2)))
        rows.append(torch.stack(cols, dim=1))
    return torch.stack(rows, dim=1)


def _bilinear_gather(x, ys, xs):
    """Bilinear samples of NHWC ``x`` at float rows ``ys`` and columns
    ``xs`` (the four taps weighted as the JAX package weights them)."""
    y0 = torch.clamp(torch.floor(ys).long(), 0, x.shape[1] - 1)
    y1 = torch.clamp(y0 + 1, 0, x.shape[1] - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, x.shape[2] - 1)
    x1 = torch.clamp(x0 + 1, 0, x.shape[2] - 1)
    wy = (ys - y0)[None, :, None, None]
    wx = (xs - x0)[None, None, :, None]
    r0, r1 = x[:, y0], x[:, y1]
    return (r0[:, :, x0] * (1 - wy) * (1 - wx) + r0[:, :, x1] * (1 - wy) * wx
            + r1[:, :, x0] * wy * (1 - wx) + r1[:, :, x1] * wy * wx)


def _resize_bilinear(x, oh: int, ow: int):
    """torch ``F.interpolate(bilinear, align_corners=False)`` of NHWC,
    shrinking without antialiasing."""
    h, w = x.shape[1:3]
    dev = x.device
    ys = torch.clamp((torch.arange(oh, device=dev) + 0.5) * (h / oh) - 0.5,
                     0.0, h - 1.0)
    xs = torch.clamp((torch.arange(ow, device=dev) + 0.5) * (w / ow) - 0.5,
                     0.0, w - 1.0)
    return _bilinear_gather(x, ys, xs)


def upernet_head_apply(p, cfg: UperNetConfig, feats: List[torch.Tensor]
                       ) -> torch.Tensor:
    """Four backbone maps -> (B, H/4, W/4, num_labels) logits."""
    top = feats[-1]
    h, w = top.shape[1:3]
    psp = [top] + [
        _resize_bilinear(_cbr(p, f"{_DH}.psp_modules.{i}.1",
                              _adaptive_avg_pool(top, s)), h, w)
        for i, s in enumerate(cfg.pool_scales)]
    psp = _cbr(p, f"{_DH}.bottleneck", torch.cat(psp, dim=-1), padding=1)
    laterals = [_cbr(p, f"{_DH}.lateral_convs.{i}", feats[i])
                for i in range(len(feats) - 1)] + [psp]
    for i in range(len(laterals) - 1, 0, -1):
        ph, pw = laterals[i - 1].shape[1:3]
        laterals[i - 1] = laterals[i - 1] + _resize_bilinear(laterals[i], ph,
                                                             pw)
    outs = [_cbr(p, f"{_DH}.fpn_convs.{i}", laterals[i], padding=1)
            for i in range(len(laterals) - 1)] + [laterals[-1]]
    oh, ow = outs[0].shape[1:3]
    outs = [outs[0]] + [_resize_bilinear(f, oh, ow) for f in outs[1:]]
    out = _cbr(p, f"{_DH}.fpn_bottleneck", torch.cat(outs, dim=-1),
               padding=1)
    return N.nhwc(N.conv_named(p, f"{_DH}.classifier", N.nchw(out)))


def upernet_apply(p, cfg: UperNetConfig, pixels: torch.Tensor
                  ) -> torch.Tensor:
    """(B, H, W, 3) normalized -> (B, H, W, num_labels) logits."""
    logits = upernet_head_apply(p, cfg,
                                convnext_backbone_apply(p, cfg, pixels))
    return _resize_bilinear(logits, pixels.shape[1], pixels.shape[2])


def segmentation_to_control_image(seg: np.ndarray,
                                  seed: int = 0) -> np.ndarray:
    """Label map (H, W) -> random-colour region image (H, W, 3) in [0, 1],
    the palette drawn from a fixed seed per label id."""
    rng = np.random.RandomState(seed)
    palette = rng.randint(0, 256, (ADE20K_NUM_LABELS + 1, 3))
    out = palette[np.asarray(seg, np.int32) % (ADE20K_NUM_LABELS + 1)]
    return out.astype(np.float32) / 255.0
