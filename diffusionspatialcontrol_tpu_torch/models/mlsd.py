"""MLSD line-segment detector, MobileV2_MLSD_Large (port of
``models/mlsd.py``).

The reference's "MLSD" detector (controlnet_aux's MLSDdetector, the
``mlsd_large_512_fp32`` checkpoint): a truncated MobileNetV2 backbone on
RGB plus a ones plane, FPN taps at features {1, 3, 6, 10, 13}, the
BlockTypeA/B/C decoder, then the centre/displacement decoding and the
segments drawn white on black. BatchNorm is folded at conversion into a
per-channel affine after each conv, in numpy, as the JAX package folds it.
The input resize and the line drawing are OpenCV's in the JAX package;
here ``ops/cv.py`` computes them (``resize_area``, ``draw_line``).
``decode_lines`` is numpy, the JAX package's code.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cv import draw_line, resize_area
from ..ops.resize import resize_bilinear_align_corners
from . import _nets as N

# MobileNetV2 inverted residuals, truncated after the 96-wide stage:
# (expand_ratio, out_channels, num_blocks, first_stride)
_IR_SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1))
_FPN = (1, 3, 6, 10, 13)


@dataclasses.dataclass(frozen=True)
class MLSDConfig:
    """The published widths: the stem, the stages' outputs and the
    decoder's. Narrower ones draw smaller random state dicts (tests)."""

    stem: int = 32
    stage_widths: Tuple[int, ...] = (16, 24, 32, 64, 96)
    decoder: int = 64


def random_state_dict(cfg: MLSDConfig = MLSDConfig(), seed: int = 0
                      ) -> Dict[str, np.ndarray]:
    d = N.Draw(seed)
    d.conv("backbone.features.0.0", cfg.stem, 4, 3, bias=False)
    d.bn("backbone.features.0.1", cfg.stem)
    idx, in_c = 1, cfg.stem
    for (t, _, n, _), c in zip(_IR_SETTING, cfg.stage_widths):
        for _ in range(n):
            base, hidden = f"backbone.features.{idx}.conv", round(in_c * t)
            j = 0
            if t != 1:
                d.conv(f"{base}.0.0", hidden, in_c, 1, bias=False)
                d.bn(f"{base}.0.1", hidden)
                j = 1
            d.conv(f"{base}.{j}.0", hidden, hidden, 3, bias=False,
                   groups=hidden)
            d.bn(f"{base}.{j}.1", hidden)
            d.conv(f"{base}.{j + 1}", c, hidden, 1, bias=False)
            d.bn(f"{base}.{j + 2}", c)
            idx, in_c = idx + 1, c
    w, f = cfg.stage_widths, cfg.decoder
    for b, (in_a, in_b) in zip((15, 17, 19, 21),
                               ((w[3], w[4]), (w[2], f), (w[1], f),
                                (w[0], f))):
        d.conv(f"block{b}.conv1.0", f, in_b, 1)
        d.bn(f"block{b}.conv1.1", f)
        d.conv(f"block{b}.conv2.0", f, in_a, 1)
        d.bn(f"block{b}.conv2.1", f)
    for b in (16, 18, 20, 22):
        d.conv(f"block{b}.conv1.0", 2 * f, 2 * f, 3)
        d.bn(f"block{b}.conv1.1", 2 * f)
        d.conv(f"block{b}.conv2.0", f, 2 * f, 3)
        d.bn(f"block{b}.conv2.1", f)
    d.conv("block23.conv1.0", f, f, 3)
    d.bn("block23.conv1.1", f)
    d.conv("block23.conv2.0", f, f, 3)
    d.bn("block23.conv2.1", f)
    d.conv("block23.conv3", 16, f, 1)
    return d.sd


def _fold_bn(sd, conv_key, bn_key, device, eps=1e-5):
    """A conv and its BatchNorm's running statistics -> the OIHW kernel
    and the per-channel (scale, bias) applied after the conv."""
    kernel = np.asarray(sd.get(f"{conv_key}.weight"), np.float32)
    conv_bias = (np.asarray(sd.get(f"{conv_key}.bias"), np.float32)
                 if f"{conv_key}.bias" in sd.tensors else 0.0)
    if bn_key is None:
        scale = np.ones((kernel.shape[0],), np.float32)
        bias = np.asarray(conv_bias, np.float32)
        if bias.ndim == 0:
            bias = np.zeros((kernel.shape[0],), np.float32)
    else:
        gamma = np.asarray(sd.get(f"{bn_key}.weight"), np.float32)
        beta = np.asarray(sd.get(f"{bn_key}.bias"), np.float32)
        mean = np.asarray(sd.get(f"{bn_key}.running_mean"), np.float32)
        var = np.asarray(sd.get(f"{bn_key}.running_var"), np.float32)
        scale = gamma / np.sqrt(var + eps)
        bias = beta + scale * (conv_bias - mean)
    return N.tensors({"kernel": kernel, "scale": scale, "bias": bias},
                     device)


def convert_mlsd(sd, device=None) -> Dict[str, Any]:
    """``sd``: a ``convert.hf.StateDict`` over the MobileV2_MLSD_Large
    checkpoint -> the folded tree in fp32 on ``device``."""
    sd = N.state_dict(sd)
    device = N.resolve_device(device)
    p: Dict[str, Any] = {"stem": _fold_bn(sd, "backbone.features.0.0",
                                          "backbone.features.0.1", device)}
    blocks, idx = [], 1
    for t, _, n, _ in _IR_SETTING:
        for _ in range(n):
            base = f"backbone.features.{idx}.conv"
            blk = {}
            j = 0
            if t != 1:
                blk["expand"] = _fold_bn(sd, f"{base}.0.0", f"{base}.0.1",
                                         device)
                j = 1
            blk["dw"] = _fold_bn(sd, f"{base}.{j}.0", f"{base}.{j}.1",
                                 device)
            blk["project"] = _fold_bn(sd, f"{base}.{j + 1}",
                                      f"{base}.{j + 2}", device)
            blocks.append(blk)
            idx += 1
    p["blocks"] = blocks
    for b in (15, 16, 17, 18, 19, 20, 21, 22):
        p[f"block{b}"] = {k: _fold_bn(sd, f"block{b}.{k}.0",
                                      f"block{b}.{k}.1", device)
                          for k in ("conv1", "conv2")}
    p["block23"] = {
        "conv1": _fold_bn(sd, "block23.conv1.0", "block23.conv1.1", device),
        "conv2": _fold_bn(sd, "block23.conv2.0", "block23.conv2.1", device),
        "conv3": _fold_bn(sd, "block23.conv3", None, device),
    }
    return p


def _conv(x, p, stride=1, groups=1, dilation=1):
    """NCHW conv with symmetric dilation (k - 1) / 2 padding, then the
    folded BatchNorm affine in fp32."""
    y = N.conv(x, p["kernel"], stride=stride, dilation=dilation,
               groups=groups)
    return y * p["scale"][:, None, None] + p["bias"][:, None, None]


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def _backbone(params, x):
    h = _relu6(_conv(x, params["stem"], stride=2))
    feats = [h]
    i = 0
    for t, _, n, s in _IR_SETTING:
        for j in range(n):
            blk = params["blocks"][i]
            stride = s if j == 0 else 1
            y = h
            if "expand" in blk:
                y = _relu6(_conv(y, blk["expand"]))
            y = _relu6(_conv(y, blk["dw"], stride=stride,
                             groups=y.shape[1]))
            y = _conv(y, blk["project"])
            if stride == 1 and h.shape[1] == y.shape[1]:
                y = h + y
            h = y
            feats.append(h)
            i += 1
    return [feats[k] for k in _FPN]


def _type_a(p, a, b, upscale=True):
    b = F.relu(_conv(b, p["conv1"]))
    a = F.relu(_conv(a, p["conv2"]))
    if upscale:
        b = N.nchw(resize_bilinear_align_corners(
            N.nhwc(b), b.shape[2] * 2, b.shape[3] * 2))
    return torch.cat([a, b], dim=1)


def _type_b(p, x):
    x = F.relu(_conv(x, p["conv1"])) + x
    return _conv(x, p["conv2"])


def mlsd_apply(params, pixels: torch.Tensor) -> torch.Tensor:
    """pixels: (B, H, W, 4), RGB / 127.5 - 1 and the ones plane, H and W
    multiples of 16. Returns the 9-channel tpMap (B, H/2, W/2, 9): centre
    logits, then the displacements (dx0, dy0, dx1, dy1) and 4 more."""
    c1, c2, c3, c4, c5 = _backbone(params, N.nchw(pixels.float()))
    x = _type_b(params["block16"], _type_a(params["block15"], c4, c5,
                                           upscale=False))
    x = _type_b(params["block18"], _type_a(params["block17"], c3, x))
    x = _type_b(params["block20"], _type_a(params["block19"], c2, x))
    x = _type_b(params["block22"], _type_a(params["block21"], c1, x))
    p23 = params["block23"]
    x = F.relu(_conv(x, p23["conv1"], dilation=5))
    x = F.relu(_conv(x, p23["conv2"]))
    return N.nhwc(_conv(x, p23["conv3"]))[..., 7:]


def decode_lines(tpmap: np.ndarray, score_thr: float = 0.10,
                 dist_thr: float = 20.0, topk: int = 200,
                 ksize: int = 3) -> np.ndarray:
    """controlnet_aux ``pred_lines``: non-max-suppressed sigmoid centre
    peaks and their displacement endpoints -> (N, 4) segments
    [x0, y0, x1, y1] in tpMap pixels."""
    center = tpmap[..., 0]
    disp = tpmap[..., 1:5]
    heat = 1.0 / (1.0 + np.exp(-center))
    pad = (ksize - 1) // 2
    hp = np.pad(heat, pad, mode="constant", constant_values=-np.inf)
    h, w = heat.shape
    windows = np.lib.stride_tricks.sliding_window_view(hp, (ksize, ksize))
    hmax = windows.max(axis=(-2, -1))
    nms = np.where(hmax == heat, heat, 0.0)
    flat = nms.reshape(-1)
    idx = np.argpartition(flat, -topk)[-topk:]
    idx = idx[np.argsort(-flat[idx])]
    yy, xx = idx // w, idx % w
    scores = flat[idx]
    dist = np.sqrt(((disp[..., :2] - disp[..., 2:]) ** 2).sum(-1))
    segs = []
    for y, x, s in zip(yy, xx, scores):
        if s > score_thr and dist[y, x] > dist_thr:
            dx0, dy0, dx1, dy1 = disp[y, x]
            segs.append([x + dx0, y + dy0, x + dx1, y + dy1])
    return np.asarray(segs, np.float32).reshape(-1, 4)


def mlsd_input(image: np.ndarray, detect_res: int = 512) -> np.ndarray:
    """The network's (1, R, R, 4) input: the image in 0..255, resized as
    OpenCV's INTER_AREA resizes it, the ones plane concatenated before the
    / 127.5 - 1 normalization."""
    img = np.asarray(image)
    if img.dtype != np.uint8 and img.max() <= 1.0:
        img = img * 255.0
    img = img.astype(np.float32)
    net_in = resize_area(img, detect_res, detect_res)
    ones = np.ones(net_in.shape[:2] + (1,), np.float32)
    return (np.concatenate([net_in, ones], -1)[None] / 127.5) - 1.0


def detect_mlsd(params, image: np.ndarray, thr_v: float = 0.1,
                thr_d: float = 0.1, detect_res: int = 512) -> np.ndarray:
    """RGB image -> (H, W, 3) white-line-on-black map in [0, 1];
    ``thr_v``/``thr_d`` are the score and length thresholds. The segments,
    found at half the network's resolution, are scaled to the image and
    drawn 1.0 on black."""
    h, w = np.asarray(image).shape[:2]
    batch = mlsd_input(image, detect_res)
    tpmap = mlsd_apply(params, torch.from_numpy(batch).to(
        N.param_device(params)))[0].cpu().numpy()
    segs = decode_lines(tpmap, score_thr=thr_v, dist_thr=thr_d) * 2.0
    segs = segs * np.array([w / detect_res, h / detect_res] * 2, np.float32)
    canvas = np.zeros((h, w), np.float32)
    for x0, y0, x1, y1 in segs:
        draw_line(canvas, (int(x0), int(y0)), (int(x1), int(y1)), 1.0)
    return np.stack([canvas] * 3, -1)
