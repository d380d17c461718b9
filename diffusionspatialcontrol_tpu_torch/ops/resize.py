"""``jax.image.resize`` in PyTorch, and latent upscaling for hires fix
(port of ``ops/resize.py``).

The reference's upscale-mode table (Latent bilinear / bicubic / nearest,
each optionally antialiased). The JAX package resizes latents, unit and
IP-Adapter images, IP-Adapter masks and face crops with
``jax.image.resize``; ``resize`` reproduces it, as a separable resize
with the same weight matrices, because no ``F.interpolate`` call matches
it for every mode: its "bicubic" is the Keys kernel with a = -0.75 (JAX's
is a = -0.5), it clamps at the border where JAX renormalizes the weights
that fall inside the image, and JAX antialiases by default. A plain op,
not a kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import Span, count

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


def _kernel(method: str, x: torch.Tensor) -> torch.Tensor:
    if method == "linear":  # triangle
        return torch.clamp(1.0 - x.abs(), min=0.0)
    out = ((1.5 * x - 2.5) * x) * x + 1.0  # Keys cubic, a = -0.5
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _weights(n_in: int, n_out: int, method: str, antialias: bool,
             device=None) -> torch.Tensor:
    """(n_out, n_in) float32 weights on ``device``: ``jax.image``'s
    ``compute_weight_mat`` (half-pixel centres, the kernel widened when
    downsampling with antialias, each row normalized over the taps inside
    the image). Built with device ops from Python numbers, so that a
    denoiser call that needs them copies nothing from the host."""
    f32 = torch.float32
    inv_scale = 1.0 / (n_out / n_in)  # a Python float, as in jax.image
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (torch.arange(n_out, dtype=f32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = (sample[None, :]
         - torch.arange(n_in, dtype=f32, device=device)[:, None]).abs()
    w = _kernel(method, x / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(f32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    count("resize.weights_built")
    return torch.where(inside[None, :], w, torch.zeros_like(w)).T


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    offsets = (np.arange(n_out, dtype=np.float32) + 0.5) * n_in / n_out
    return np.floor(offsets.astype(np.float32)).astype(np.int64)


_RESIZE = Span("resize")

_METHODS = {"linear": "linear", "bilinear": "linear", "trilinear": "linear",
            "cubic": "cubic", "bicubic": "cubic", "tricubic": "cubic",
            "nearest": "nearest"}


def resize(x: torch.Tensor, shape, method: str = "linear",
           antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize(x, shape, method, antialias)`` for floating
    ``x`` of any layout: (H, W, C) images, (B, H, W, C) batches and
    (B, H, W) masks alike. Every axis whose size changes is resized, one
    after the other, with that axis's weight matrix ("linear" or "cubic";
    ``antialias`` widens the kernel when shrinking, as JAX's default does)
    or its half-pixel nearest index ("nearest"). Span ``resize``; counter
    ``resize.weights_built``, one a weight matrix built."""
    method = _METHODS[method]
    if len(shape) != x.dim():
        raise ValueError(f"shape {tuple(shape)} has not the {x.dim()} axes "
                         f"of x")
    letters = "abcdefgh"[: x.dim()]
    out = x
    with _RESIZE:
        for axis, (n_in, n_out) in enumerate(zip(x.shape, shape)):
            if n_in == n_out:
                continue
            if method == "nearest":
                idx = torch.from_numpy(_nearest_index(n_in, n_out)).to(
                    x.device)
                out = out.index_select(axis, idx)
                continue
            wm = _weights(n_in, n_out, method, antialias,
                          x.device).to(out.dtype)
            dst = letters[:axis] + "z" + letters[axis + 1:]
            out = torch.einsum(f"z{letters[axis]},{letters}->{dst}", wm,
                               out)
    return out


def resize_latents(latents: torch.Tensor, new_h: int, new_w: int,
                   mode: str = "bilinear",
                   antialias: bool = False) -> torch.Tensor:
    """Resize NHWC ``latents`` to (new_h, new_w) as
    ``jax.image.resize(method, antialias)`` does; an unknown ``mode`` means
    bilinear, as in the JAX package."""
    b, h, w, c = latents.shape
    return resize(latents, (b, new_h, new_w, c),
                  _MODES.get(mode, "linear"), antialias)


def _ac_axis(n_in: int, n_out: int):
    """The JAX package's align-corners taps of one axis: low and high
    indices and the float32 fraction, from float64 coordinates."""
    if n_out == 1 or n_in == 1:
        lo = np.zeros(n_out, np.int64)
        return lo, lo, np.zeros(n_out, np.float32)
    coord = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.floor(coord).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    return lo, hi, (coord - lo).astype(np.float32)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` with torch's ``align_corners=True``
    sampling (output i reads input i (n_in - 1) / (n_out - 1)), computed as
    the JAX package's ``resize_bilinear_align_corners`` computes it: rows
    blended along x, then along y, in float32. The MLSD, NormalBae and
    ZoeDepth decoders upsample this way."""
    b, h, w, c = x.shape
    if (h, w) == (out_h, out_w):
        return x
    dev = x.device
    ylo, yhi, yf = (torch.from_numpy(a).to(dev) for a in _ac_axis(h, out_h))
    xlo, xhi, xf = (torch.from_numpy(a).to(dev) for a in _ac_axis(w, out_w))
    xf32 = x.float()
    xw = xf[None, None, :, None]
    top_rows, bot_rows = xf32[:, ylo], xf32[:, yhi]
    top = top_rows[:, :, xlo] * (1 - xw) + top_rows[:, :, xhi] * xw
    bot = bot_rows[:, :, xlo] * (1 - xw) + bot_rows[:, :, xhi] * xw
    yw = yf[None, :, None, None]
    return (top * (1 - yw) + bot * yw).to(x.dtype)
