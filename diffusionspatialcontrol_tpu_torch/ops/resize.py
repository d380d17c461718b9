"""Latent upscaling for hires fix (port of ``ops/resize.py``).

The reference's upscale-mode table (Latent bilinear / bicubic / nearest,
each optionally antialiased). The JAX package resizes with
``jax.image.resize``; this module reproduces it exactly, as a separable
resize with the same weight matrices, because no ``F.interpolate`` call
matches it for every mode: its "bicubic" is the Keys kernel with a = -0.75
(JAX's is a = -0.5), and it clamps at the border where JAX renormalizes the
weights that fall inside the image. A plain op, not a kernel.
"""

from __future__ import annotations

import numpy as np
import torch

_MODES = {
    "bilinear": "linear",
    "bicubic": "cubic",
    "nearest": "nearest",
    "nearest-exact": "nearest",
}

UPSCALE_MODES = [
    "Latent (bilinear)",
    "Latent (bilinear antialiased)",
    "Latent (bicubic)",
    "Latent (bicubic antialiased)",
    "Latent (nearest)",
    "Latent (nearest-exact)",
]


def parse_upscale_mode(name: str):
    """UI name -> (mode, antialias)."""
    n = name.lower()
    antialias = "antialiased" in n
    for key in ("bicubic", "bilinear", "nearest-exact", "nearest"):
        if key in n:
            return key, antialias
    return "bilinear", False


def _kernel(method: str, x: np.ndarray) -> np.ndarray:
    if method == "linear":  # triangle
        return np.maximum(0, 1 - np.abs(x))
    out = ((1.5 * x - 2.5) * x) * x + 1.0  # Keys cubic, a = -0.5
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _weights(n_in: int, n_out: int, method: str, antialias: bool
             ) -> np.ndarray:
    """(n_out, n_in) float32 weights: ``jax.image``'s ``compute_weight_mat``
    (half-pixel centres, the kernel widened when downsampling with
    antialias, each row normalized over the taps inside the image)."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)  # a Python float, as in jax.image
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (np.arange(n_out, dtype=f32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = _kernel(method, x / kernel_scale).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).T.astype(f32)


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    offsets = (np.arange(n_out, dtype=np.float32) + 0.5) * n_in / n_out
    return np.floor(offsets.astype(np.float32)).astype(np.int64)


def resize_latents(latents: torch.Tensor, new_h: int, new_w: int,
                   mode: str = "bilinear",
                   antialias: bool = False) -> torch.Tensor:
    """Resize NHWC ``latents`` to (new_h, new_w) as
    ``jax.image.resize(method, antialias)`` does; an unknown ``mode`` means
    bilinear, as in the JAX package."""
    b, h, w, c = latents.shape
    method = _MODES.get(mode, "linear")
    dev = latents.device
    out = latents
    for axis, (n_in, n_out) in ((1, (h, new_h)), (2, (w, new_w))):
        if n_in == n_out:
            continue
        if method == "nearest":
            idx = torch.from_numpy(_nearest_index(n_in, n_out)).to(dev)
            out = out.index_select(axis, idx)
        else:
            wm = torch.from_numpy(_weights(n_in, n_out, method, antialias))
            wm = wm.to(device=dev, dtype=out.dtype)
            out = (torch.einsum("oi,biwc->bowc", wm, out) if axis == 1
                   else torch.einsum("oi,bhic->bhoc", wm, out))
    return out
