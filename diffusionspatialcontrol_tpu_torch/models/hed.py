"""HED soft-edge detector, ControlNetHED (port of ``models/hed.py``).

The reference's "Soft Edge (HED)" / "Scribble (HED)" detector: a VGG-style
network of five blocks, each ending in a 1x1 side output, on raw 0..255
pixels less a learned ``norm`` shift. The weights keep the
``ControlNetHED.pth`` layout (``norm``, ``block{k}.convs.{i}.*``,
``block{k}.projection.*``). The detector takes the sigmoid of the side
outputs' mean (``ops/kernels/hed_fuse.py:hed_tail``, on the parameters'
device: one kernel on the card); scribble mode thins and binarizes it on
the host (``pidinet._nms_thin``, numpy, the JAX package's code).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kernels.hed_fuse import hed_tail
from ..utils.profiling import Span
from . import _nets as N
from .pidinet import _nms_thin

# convs per block; blocks 2..5 are preceded by a 2x2 max pool
_CONVS = (2, 2, 3, 3, 3)

_PREPARE, _NET, _FUSE = (Span("hed.prepare"), Span("hed.net"),
                         Span("hed.fuse"))


@dataclasses.dataclass(frozen=True)
class HEDConfig:
    """The published ControlNetHED widths; narrower ones draw smaller
    random state dicts (tests)."""

    widths: Tuple[int, ...] = (64, 128, 256, 512, 512)


def random_state_dict(cfg: HEDConfig = HEDConfig(), seed: int = 0
                      ) -> Dict[str, np.ndarray]:
    d = N.Draw(seed)
    d.array("norm", (1, 3, 1, 1), 10.0)
    c_in = 3
    for b, (n, c) in enumerate(zip(_CONVS, cfg.widths), start=1):
        for i in range(n):
            d.conv(f"block{b}.convs.{i}", c, c_in if i == 0 else c, 3)
        d.conv(f"block{b}.projection", 1, c, 1)
        c_in = c
    return d.sd


def convert_hed(sd, device=None) -> Dict[str, torch.Tensor]:
    """``sd``: a ControlNetHED.pth state dict -> fp32 tensors on
    ``device``."""
    p = N.tensors(sd, device)
    p["norm"] = p["norm"].reshape(3)
    return p


def hed_apply(params, pixels: torch.Tensor) -> List[torch.Tensor]:
    """pixels: (B, H, W, 3) RGB in [0, 255]. Returns the five side-output
    logit maps (B, h, w, 1) at strides 1, 2, 4, 8 and 16."""
    h = N.nchw(pixels.float() - params["norm"])
    outs = []
    for b, n in enumerate(_CONVS, start=1):
        if b > 1:
            h = N.maxpool2(h)
        for i in range(n):
            h = F.relu(N.conv(h, params[f"block{b}.convs.{i}.weight"],
                              params[f"block{b}.convs.{i}.bias"]))
        outs.append(N.nhwc(N.conv(h, params[f"block{b}.projection.weight"],
                                  params[f"block{b}.projection.bias"])))
    return outs


def detect_edges(params, image: np.ndarray, scribble: bool = False
                 ) -> np.ndarray:
    """RGB image -> (H, W, 3) soft-edge map in [0, 1]; ``scribble``
    thins and binarizes it into the Scribble ControlNet's sketch. Spans:
    ``hed.prepare``, ``hed.net``, ``hed.fuse`` (the tail: a kernel launch
    on the card, the plain version with its ``resize`` spans on the CPU),
    then one ``to_host``; scribble's thinning and three-channel stack run
    after it on the host under no child span, so a profiled request counts
    their device idle as outside the spans."""
    with _PREPARE:
        img = np.asarray(image)
        if img.dtype != np.uint8 and img.max() <= 1.0:
            img = (img * 255.0).astype(np.float32)
        img = img.astype(np.float32)
        h, w = img.shape[:2]
        padded = np.pad(img, ((0, (-h) % 16), (0, (-w) % 16), (0, 0)),
                        mode="edge")
        pixels = N.host_image(padded, N.param_device(params))
    with _NET:
        outs = hed_apply(params, pixels)
    with _FUSE:
        # allocated after the network, from its freed activations
        edge = hed_tail([o[0, :, :, 0] for o in outs], h, w,
                        1 if scribble else 3)
    edge = N.to_host(edge)
    if scribble:
        edge = _nms_thin(edge[:, :, 0])
        return np.stack([edge.astype(np.float32)] * 3, -1)
    return edge
