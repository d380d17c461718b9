"""Plain PyTorch HED soft-edge detection, the reference that decides whether
a run of the HED cell is correct.

It follows the published detector (ControlNet's annotator, the Apache-2.0
``ControlNetHED_Apache2`` network that ``ControlNetHED.pth`` holds, and
its ``HEDdetector``): the picture's raw 0..255 pixels less the learned
shift ``norm``; five blocks of 3x3 convolutions (zero padding 1) each
followed by a ReLU, blocks 2-5 after a 2x2 stride-2 max pool, each block
ending in a 1x1 side projection to one channel; every side output resized
to the picture's size by bilinear interpolation on half-pixel centres with
clamped borders (OpenCV's ``INTER_LINEAR``, which is PyTorch's
``align_corners=False`` when enlarging), and the edge map the logistic
sigmoid of their mean. The map is returned as the program returns it:
(1, H, W, 3) float32, the one channel three times. It reads the weights
as the benchmark made them, under the checkpoint's names, and imports
nothing of the program under test.

``precision="fp32"``: float32 with TF32 off. ``precision="tf32"`` is the
control: every operand of a convolution (the activations and the weights)
rounded to TF32's 10-bit mantissa (to nearest, ties to even), the sums in
float32, as TF32 tensor cores compute a float32 convolution.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to 10 mantissa bits, ties to even."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def generate(weights: Dict[str, torch.Tensor], cfg: dict, request: dict,
             precision: str = "fp32", device="cuda") -> np.ndarray:
    if precision not in ("fp32", "tf32"):
        raise ValueError(f"precision {precision!r}")
    q = to_tf32 if precision == "tf32" else (lambda t: t)
    net = cfg["hed"]

    def conv(h, name, padding):
        return F.conv2d(q(h), q(weights[name + ".weight"].float()),
                        weights[name + ".bias"].float(), padding=padding)

    image = torch.from_numpy(np.ascontiguousarray(request["image"]))
    x = image.to(device=device, dtype=torch.float32).permute(2, 0, 1)[None]
    height, width = x.shape[-2:]
    h = x - weights["norm"].float()
    sides = []
    for b, n in enumerate(net["convs"], start=1):
        if b > 1:
            h = F.max_pool2d(h, 2, 2)
        for i in range(n):
            h = F.relu(conv(h, f"block{b}.convs.{i}", 1))
        side = conv(h, f"block{b}.projection", 0)
        if side.shape[-2:] != (height, width):
            side = F.interpolate(side, size=(height, width), mode="bilinear",
                                 align_corners=False)
        sides.append(side[0, 0])
    edge = torch.sigmoid(torch.stack(sides).mean(0))
    return edge[None, :, :, None].expand(1, height, width, 3).cpu().numpy()
