"""PidiNet soft-edge detector, pixel-difference convolutions (port of
``models/pidinet.py``).

The reference's default "Soft Edge" / "Scribble" detector (controlnet_aux's
PidiNetDetector, ``table5_pidinet``: inplane 60, config "carv4", CDCM
dilation heads and CSAM attention). A pixel-difference convolution is a
linear transform of a plain kernel, so the converter folds each one into
its equivalent plain kernel (``fold_pdc``; cd and ad stay 3x3, rd becomes
the sparse 5x5), as the JAX package does, and the network runs plain
convolutions. The weights keep the ``table5_pidinet.pth`` layout (a
``module.`` prefix is stripped). ``fold_pdc``, ``_gauss_blur`` and
``_nms_thin`` are numpy, the JAX package's code.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize
from . import _nets as N

INPLANE = 60
DIL = 24
# carv4: the pdc type of layers 0..15
PDC_TYPES = tuple(["cd", "ad", "rd", "cv"] * 4)
# (name, layer index, in_c, out_c, strided)
_BLOCKS = (
    [("init", 0, 3, INPLANE, False)]
    + [(f"block1_{i}", i, INPLANE, INPLANE, False) for i in (1, 2, 3)]
    + [(f"block2_{i}", 3 + i, INPLANE if i == 1 else 2 * INPLANE,
        2 * INPLANE, i == 1) for i in (1, 2, 3, 4)]
    + [(f"block3_{i}", 7 + i, 2 * INPLANE if i == 1 else 4 * INPLANE,
        4 * INPLANE, i == 1) for i in (1, 2, 3, 4)]
    + [(f"block4_{i}", 11 + i, 4 * INPLANE, 4 * INPLANE, i == 1)
       for i in (1, 2, 3, 4)]
)
FUSE_PLANES = (INPLANE, 2 * INPLANE, 4 * INPLANE, 4 * INPLANE)
CDCM_DILATIONS = (5, 7, 9, 11)
_STAGE_ENDS = ("block1_3", "block2_4", "block3_4", "block4_4")

# rd: 3x3 taps (the centre excluded) scatter to the 5x5 ring and negate onto
# the inner 3x3 ring; ad: the clockwise tap permutation subtracted
_RD_OUTER = (0, 2, 4, 10, 14, 20, 22, 24)
_RD_INNER = (6, 7, 8, 11, 13, 16, 17, 18)
_AD_PERM = (3, 0, 1, 6, 4, 2, 7, 8, 5)


def fold_pdc(w: np.ndarray, pdc: str) -> np.ndarray:
    """A pixel-difference conv as its equivalent plain kernel: ``w`` is
    (O, I, 3, 3); the result (O, I, 3, 3) for cv/cd/ad, (O, I, 5, 5) for
    rd."""
    w = np.asarray(w, np.float64)
    o, i = w.shape[:2]
    if pdc == "cv":
        return w.astype(np.float32)
    if pdc == "cd":
        out = w.copy()
        out[:, :, 1, 1] -= w.sum(axis=(2, 3))
        return out.astype(np.float32)
    flat = w.reshape(o, i, 9)
    if pdc == "ad":
        out = flat - flat[:, :, _AD_PERM]
        return out.reshape(o, i, 3, 3).astype(np.float32)
    if pdc == "rd":
        buf = np.zeros((o, i, 25), np.float64)
        buf[:, :, list(_RD_OUTER)] = flat[:, :, 1:]
        buf[:, :, list(_RD_INNER)] = -flat[:, :, 1:]
        return buf.reshape(o, i, 5, 5).astype(np.float32)
    raise ValueError(f"unknown pdc type {pdc!r}")


def random_state_dict(cfg=None, seed: int = 0) -> Dict[str, np.ndarray]:
    """A ``table5_pidinet`` state dict (its one width; ``cfg`` is unused)."""
    d = N.Draw(seed)
    for name, _, in_c, out_c, strided in _BLOCKS:
        if name == "init":
            d.conv("init_block", out_c, in_c, 3, bias=False)
            continue
        d.conv(f"{name}.conv1", in_c, in_c, 3, bias=False, groups=in_c)
        d.conv(f"{name}.conv2", out_c, in_c, 1, bias=False)
        if strided:
            d.conv(f"{name}.shortcut", out_c, in_c, 1)
    for i, ch in enumerate(FUSE_PLANES):
        d.conv(f"dilations.{i}.conv1", DIL, ch, 1)
        for j in (1, 2, 3, 4):
            d.conv(f"dilations.{i}.conv2_{j}", DIL, DIL, 3, bias=False)
        d.conv(f"attentions.{i}.conv1", 4, DIL, 1)
        d.conv(f"attentions.{i}.conv2", 1, 4, 3, bias=False)
        d.conv(f"conv_reduces.{i}.conv", 1, DIL, 1)
    d.conv("classifier", 1, 4, 1)
    return d.sd


def convert_pidinet(sd, device=None) -> Dict[str, torch.Tensor]:
    """``sd``: the table5_pidinet state dict ('module.' prefixes
    stripped) -> fp32 tensors on ``device``, the PDC kernels folded."""
    raw = sd.tensors if hasattr(sd, "tensors") else sd
    if "state_dict" in raw and hasattr(raw["state_dict"], "items"):
        raw = raw["state_dict"]
    arrays = {k.replace("module.", ""): np.asarray(
        v.float().cpu().numpy() if isinstance(v, torch.Tensor) else v,
        np.float32) for k, v in raw.items()}
    for name, li, *_ in _BLOCKS:
        key = "init_block.weight" if name == "init" else f"{name}.conv1.weight"
        if key not in arrays:
            raise KeyError(f"pidinet weight {key!r} missing; have e.g. "
                           f"{sorted(arrays)[:4]}")
        arrays[key] = fold_pdc(arrays[key], PDC_TYPES[li])
    return N.tensors(arrays, device)


def _head(p, i: int, x):
    h = N.conv(F.relu(x), p[f"dilations.{i}.conv1.weight"],
               p[f"dilations.{i}.conv1.bias"])
    h = sum(N.conv(h, p[f"dilations.{i}.conv2_{j + 1}.weight"],
                   dilation=CDCM_DILATIONS[j]) for j in range(4))
    g = N.conv(F.relu(h), p[f"attentions.{i}.conv1.weight"],
               p[f"attentions.{i}.conv1.bias"])
    g = N.conv(g, p[f"attentions.{i}.conv2.weight"])
    h = h * torch.sigmoid(g)
    return N.conv(h, p[f"conv_reduces.{i}.conv.weight"],
                  p[f"conv_reduces.{i}.conv.bias"])


def pidinet_apply(params, pixels: torch.Tensor) -> torch.Tensor:
    """pixels: (B, H, W, 3) RGB in [0, 1]. Returns the fused edge map
    (B, H, W, 1) in [0, 1], the sigmoid of the four-scale classifier."""
    b, H, W = pixels.shape[:3]
    x = N.conv(N.nchw(pixels.float()), params["init_block.weight"])
    stages = []
    for name, _, _, _, strided in _BLOCKS[1:]:
        if strided:
            x = N.maxpool2(x)
        w1 = params[f"{name}.conv1.weight"]
        y = F.relu(N.conv(x, w1, groups=w1.shape[0]))
        y = N.conv(y, params[f"{name}.conv2.weight"])
        if strided:
            x = N.conv(x, params[f"{name}.shortcut.weight"],
                       params[f"{name}.shortcut.bias"])
        x = x + y
        if name in _STAGE_ENDS:
            stages.append(x)
    maps = [resize(N.nhwc(_head(params, i, s)), (b, H, W, 1), "linear")
            for i, s in enumerate(stages)]
    fused = N.conv(N.nchw(torch.cat(maps, dim=-1)),
                   params["classifier.weight"], params["classifier.bias"])
    return torch.sigmoid(N.nhwc(fused))


def _gauss_blur(y: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur as cv2.GaussianBlur(x, (0, 0), sigma) on
    float input: radius 4 sigma, BORDER_REFLECT_101."""
    h, w = y.shape
    r = max(int(round(4.0 * sigma)), 1)
    xs = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-(xs ** 2) / (2.0 * sigma * sigma))
    k /= k.sum()
    pad = np.pad(y, ((r, r), (0, 0)), mode="reflect")
    y = np.einsum("k,kij->ij", k,
                  np.stack([pad[i:i + h] for i in range(2 * r + 1)]))
    pad = np.pad(y, ((0, 0), (r, r)), mode="reflect")
    return np.einsum("k,kij->ij", k,
                     np.stack([pad[:, i:i + w] for i in range(2 * r + 1)]))


def _nms_thin(edge: np.ndarray) -> np.ndarray:
    """The scribble post-pass, ``nms(x, 127, 3)``: blur (sigma 3), keep the
    pixels that are the maximum of their 3-pixel line in any of 4
    directions, binarize at 127/255; then blur the binary map (sigma 3)
    and binarize at 4/255."""
    e = _gauss_blur(edge.astype(np.float32), 3.0)
    p = np.pad(e, 1, mode="edge")
    h, w = e.shape
    lines = [
        np.maximum(p[1:h + 1, :w], p[1:h + 1, 2:]),
        np.maximum(p[:h, 1:w + 1], p[2:, 1:w + 1]),
        np.maximum(p[:h, :w], p[2:, 2:]),
        np.maximum(p[2:, :w], p[:h, 2:]),
    ]
    keep = np.zeros_like(e, bool)
    for m in lines:
        keep |= e >= m
    z = (np.where(keep, e, 0.0) > 127.0 / 255.0).astype(np.float32)
    return (_gauss_blur(z, 3.0) > 4.0 / 255.0).astype(np.float32)


def detect_soft_edge(params, image: np.ndarray, scribble: bool = False,
                     safe: bool = False) -> np.ndarray:
    """RGB image -> (H, W, 3) soft-edge map in [0, 1]; ``scribble`` applies
    the thinning post-pass, ``safe`` the three-level safe step."""
    img = np.asarray(image)
    if img.dtype == np.uint8 or img.max() > 1.0:
        img = img.astype(np.float32) / 255.0
    h, w = img.shape[:2]
    padded = np.pad(img.astype(np.float32),
                    ((0, (-h) % 8), (0, (-w) % 8), (0, 0)), mode="edge")
    edge = pidinet_apply(params, N.host_image(
        padded, N.param_device(params)))[0, :h, :w, 0].cpu().numpy()
    if safe:
        edge = np.floor(edge * 2.999999) / 2.0
    if scribble:
        edge = _nms_thin(edge)
    return np.stack([edge.astype(np.float32)] * 3, -1)
