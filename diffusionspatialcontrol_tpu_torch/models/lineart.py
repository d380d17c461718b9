"""Lineart detector, the informative-drawings Generator (port of
``models/lineart.py``).

The reference's "Lineart" detector (controlnet_aux's LineartDetector,
``Generator(3, 1, 3)``): a reflection-padded 7x7 stem, two stride-2
downsamples, three residual blocks, two transposed-conv upsamples and a
7x7 head with a sigmoid, every norm an affine-free InstanceNorm. The
weights keep the ``sk_model.pth`` layout (``model0.1``, ``model1.{0,3}``,
``model2.{i}.conv_block.{1,5}``, ``model3.{0,3}``, ``model4.1``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from . import _nets as N

_N_RES = 3


@dataclasses.dataclass(frozen=True)
class LineartConfig:
    """The published stem width (64); narrower ones draw smaller random
    state dicts (tests)."""

    stem: int = 64


def random_state_dict(cfg: LineartConfig = LineartConfig(), seed: int = 0
                      ) -> Dict[str, np.ndarray]:
    c = cfg.stem
    d = N.Draw(seed)
    d.conv("model0.1", c, 3, 7)
    d.conv("model1.0", 2 * c, c, 3)
    d.conv("model1.3", 4 * c, 2 * c, 3)
    for i in range(_N_RES):
        d.conv(f"model2.{i}.conv_block.1", 4 * c, 4 * c, 3)
        d.conv(f"model2.{i}.conv_block.5", 4 * c, 4 * c, 3)
    d.conv_transpose("model3.0", 4 * c, 2 * c, 3)
    d.conv_transpose("model3.3", 2 * c, c, 3)
    d.conv("model4.1", 1, c, 7)
    return d.sd


def convert_lineart(sd, device=None) -> Dict[str, torch.Tensor]:
    """``sd``: sk_model.pth / sk_model2.pth -> fp32 tensors on
    ``device``."""
    return N.tensors(sd, device)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free InstanceNorm of NCHW, the biased variance, fp32."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def conv_transpose_s2(p, x: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d(k=3, stride=2, padding=1, output_padding=1) of NCHW
    ``x``; ``p["weight"]`` in torch's (in, out, kh, kw) layout."""
    return F.conv_transpose2d(x, p["weight"], p["bias"], stride=2, padding=1,
                              output_padding=1)


def _c(params, name, x, stride=1, padding=0):
    return N.conv(x, params[f"{name}.weight"], params[f"{name}.bias"],
                  stride=stride, padding=padding)


def _reflect(x, p):
    return F.pad(x, (p, p, p, p), mode="reflect")


def lineart_apply(params, pixels: torch.Tensor) -> torch.Tensor:
    """pixels (B, H, W, 3) RGB in [0, 1], H and W multiples of 4. Returns
    the sigmoid line map (B, H, W, 1)."""
    h = F.relu(instance_norm(_c(params, "model0.1",
                                _reflect(N.nchw(pixels.float()), 3))))
    for name in ("model1.0", "model1.3"):
        h = F.relu(instance_norm(_c(params, name, h, stride=2, padding=1)))
    for i in range(_N_RES):
        r = F.relu(instance_norm(_c(params, f"model2.{i}.conv_block.1",
                                    _reflect(h, 1))))
        r = instance_norm(_c(params, f"model2.{i}.conv_block.5",
                             _reflect(r, 1)))
        h = h + r
    for name in ("model3.0", "model3.3"):
        h = F.relu(instance_norm(conv_transpose_s2(
            {"weight": params[f"{name}.weight"],
             "bias": params[f"{name}.bias"]}, h)))
    return N.nhwc(torch.sigmoid(_c(params, "model4.1", _reflect(h, 3))))


def detect_lineart(params, image: np.ndarray,
                   invert_output: bool = True) -> np.ndarray:
    """RGB image -> (H, W, 3) line control image in [0, 1], white lines on
    black with ``invert_output`` (the Lineart ControlNet's input)."""
    img = np.asarray(image)
    if img.dtype == np.uint8 or img.max() > 1.0:
        img = img.astype(np.float32) / 255.0
    img = img.astype(np.float32)
    h, w = img.shape[:2]
    padded = np.pad(img, ((0, (-h) % 4), (0, (-w) % 4), (0, 0)),
                    mode="edge")
    line = lineart_apply(params, N.host_image(
        padded, N.param_device(params)))[0, :h, :w, 0].cpu().numpy()
    if invert_output:
        line = 1.0 - line
    return np.stack([line] * 3, -1)
