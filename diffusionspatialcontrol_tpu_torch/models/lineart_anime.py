"""Lineart (anime) detector, the Anime2Sketch pix2pix UnetGenerator (port
of ``models/lineart_anime.py``).

The reference's "Lineart (anime)" detector (controlnet_aux's
LineartAnimeDetector): ``UnetGenerator(3, 1, num_downs=8, ngf=64)`` with
affine-free InstanceNorm, LeakyReLU(0.2) downs, ConvTranspose(k4, s2, p1)
ups, a tanh output and nested skip concatenations. The weights keep the
``netG.pth`` layout (nested ``model.model...`` Sequential indices).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize
from . import _nets as N
from .lineart import instance_norm

NUM_DOWNS = 8


@dataclasses.dataclass(frozen=True)
class LineartAnimeConfig:
    """The published ngf (64); narrower ones draw smaller random state
    dicts (tests)."""

    ngf: int = 64


def _channels(ngf: int):
    """(outer_nc, inner_nc, input_nc) per block, outermost first."""
    chans = [(1, ngf, 3), (ngf, ngf * 2, None), (ngf * 2, ngf * 4, None),
             (ngf * 4, ngf * 8, None)]
    chans += [(ngf * 8, ngf * 8, None)] * (NUM_DOWNS - 4)
    return chans


def _prefixes() -> List[tuple]:
    """(down key, up key) per block, outermost first, in the nested
    Sequential layout."""
    out, prefix = [], "model"
    for i in range(NUM_DOWNS):
        if i == 0:
            down, sub, up = 0, 1, 3
        elif i == NUM_DOWNS - 1:
            down, sub, up = 1, None, 3
        else:
            down, sub, up = 1, 3, 5
        out.append((f"{prefix}.{down}", f"{prefix}.{up}"))
        if sub is not None:
            prefix = f"{prefix}.{sub}.model"
    return out


def random_state_dict(cfg: LineartAnimeConfig = LineartAnimeConfig(),
                      seed: int = 0) -> Dict[str, np.ndarray]:
    d = N.Draw(seed)
    for i, ((outer, inner, inp), (down, up)) in enumerate(
            zip(_channels(cfg.ngf), _prefixes())):
        d.conv(down, inner, inp if inp is not None else outer, 4)
        up_in = inner if i == NUM_DOWNS - 1 else inner * 2
        d.conv_transpose(up, up_in, outer, 4)
    return d.sd


def convert_lineart_anime(sd, device=None) -> Dict[str, torch.Tensor]:
    """``sd``: Anime2Sketch netG.pth -> fp32 tensors on ``device``."""
    return N.tensors(sd, device)


def _run_block(params, keys, i, x):
    """UnetSkipConnectionBlock.forward of block ``i`` (NCHW)."""
    down, up = keys[i]
    outermost, innermost = i == 0, i == len(keys) - 1
    h = x if outermost else F.leaky_relu(x, 0.2)
    h = N.conv(h, params[f"{down}.weight"], params[f"{down}.bias"],
               stride=2, padding=1)
    if not outermost and not innermost:
        h = _run_block(params, keys, i + 1, instance_norm(h))
    elif outermost:
        h = _run_block(params, keys, i + 1, h)
    h = F.conv_transpose2d(F.relu(h), params[f"{up}.weight"],
                           params[f"{up}.bias"], stride=2, padding=1)
    if outermost:
        return torch.tanh(h)
    return torch.cat([x, instance_norm(h)], dim=1)


def lineart_anime_apply(params, pixels: torch.Tensor) -> torch.Tensor:
    """pixels (B, H, W, 3) in [-1, 1], H and W multiples of 256. Returns
    the tanh line map (B, H, W, 1) in [-1, 1]."""
    return N.nhwc(_run_block(params, _prefixes(), 0,
                             N.nchw(pixels.float())))


def detect_lineart_anime(params, image: np.ndarray) -> np.ndarray:
    """RGB image -> (H, W, 3) anime line control image in [0, 1], white
    lines on black."""
    img = np.asarray(image)
    if img.dtype == np.uint8 or img.max() > 1.0:
        img = img.astype(np.float32) / 255.0
    h, w = img.shape[:2]
    th = max(((h + 128) // 256) * 256, 256)
    tw = max(((w + 128) // 256) * 256, 256)
    x = resize(N.host_image(np.asarray(img, np.float32),
                            N.param_device(params))[0], (th, tw, 3),
               "linear")
    out = lineart_anime_apply(params, (x * 2.0 - 1.0)[None])[0, :, :, 0]
    line = resize((out + 1.0) * 0.5, (h, w), "linear").cpu().numpy()
    return np.stack([1.0 - line] * 3, -1).astype(np.float32)
