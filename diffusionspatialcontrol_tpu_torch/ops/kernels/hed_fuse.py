"""HED's side-output tail, a hand-written CUDA kernel with its plain PyTorch
version beside it.

Replaces no Pallas kernel: the JAX package runs the tail of
``models/hed.py:detect_edges`` with ``jax.image.resize`` and numpy. From the
five side-output logit maps of ``hed_apply`` (side k a (th / 2^k, tw / 2^k)
float32 map, th and tw multiples of 16) it computes the soft-edge map: each
side resized to (th, tw) "linear", their mean, the sigmoid, the crop to
(h, w) and C copies of it, (h, w, C) float32. The kernel is
``csrc/hed_fuse.cu``: one launch a picture, bound by the bytes of the map
it writes.

Dispatch: CPU tensors take ``hed_tail_plain``; CUDA tensors launch the
kernel or raise. ``hed_tail.launches`` counts launches, and each launch adds
one to the counter ``hed.tail_kernel`` of the innermost open span.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ...utils.profiling import count
from ..resize import resize
from . import _build
from ._launch import on_cpu, raise_on_error, stream_arg

SIDES = 5


def hed_tail_plain(sides: Sequence[torch.Tensor], h: int, w: int,
                   channels: int = 3) -> torch.Tensor:
    """The tail in torch ops: ``resize`` of each side to side 0's size,
    mean, sigmoid, crop, C channels; (h, w, channels) float32."""
    size = tuple(sides[0].shape)
    edge = torch.sigmoid(torch.stack(
        [resize(s, size, "linear") for s in sides]).mean(0))[:h, :w]
    return torch.stack([edge] * channels, -1)


def _check(sides, h: int, w: int, channels: int) -> None:
    if len(sides) != SIDES:
        raise ValueError(f"HED has {SIDES} side outputs, got {len(sides)}")
    if sides[0].dim() != 2:
        raise ValueError(f"the sides are (h, w) maps, side 0 is "
                         f"{tuple(sides[0].shape)}")
    th, tw = sides[0].shape
    if th % 16 or tw % 16:
        raise ValueError(f"side 0 must be a multiple of 16 on each axis, "
                         f"got {(th, tw)}")
    for k, s in enumerate(sides):
        if s.shape != (th >> k, tw >> k):
            raise ValueError(f"side {k} must be {(th >> k, tw >> k)}, got "
                             f"{tuple(s.shape)}")
        if s.dtype != torch.float32:
            raise TypeError(f"the sides are float32, side {k} is {s.dtype}")
    if not (0 < h <= th and 0 < w <= tw):
        raise ValueError(f"crop {(h, w)} outside side 0's {(th, tw)}")
    if channels < 1:
        raise ValueError(f"channels must be positive, got {channels}")


def hed_tail_kernel(sides: Sequence[torch.Tensor], h: int, w: int,
                    channels: int = 3) -> torch.Tensor:
    """Launch the kernel on CUDA sides (no dispatch); counts the launch."""
    _check(sides, h, w, channels)
    sides = [s.contiguous() for s in sides]  # views of (1, hk, wk, 1): free
    th, tw = sides[0].shape
    out = torch.empty((h, w, channels), dtype=torch.float32,
                      device=sides[0].device)
    fn = _build.load("hed_fuse").dsc_hed_fuse
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    err = fn(*(s.data_ptr() for s in sides), out.data_ptr(), th, tw, h, w,
             channels, stream_arg(out))
    raise_on_error(err, "hed_fuse")
    hed_tail.launches += 1
    count("hed.tail_kernel")
    return out


def hed_tail(sides: Sequence[torch.Tensor], h: int, w: int,
             channels: int = 3) -> torch.Tensor:
    """The soft-edge map (h, w, channels) of HED's five side-output logit
    maps, on their device."""
    if on_cpu(*sides):
        return hed_tail_plain(sides, h, w, channels)
    return hed_tail_kernel(sides, h, w, channels)


hed_tail.launches = 0
