"""What the detector networks share: their weights as a flat dict of fp32
tensors on one device, NCHW convolutions on NHWC activations, and drawing
random state dicts in the published layouts, and the copy of a result to
the host.

The detectors keep the published checkpoints' names and torch layouts (a
conv weight is OIHW, a linear weight (out, in)), so a converter moves the
tensors to the device and folds what the JAX package folds (BatchNorm
statistics, pixel-difference kernels); nothing is transposed. They run in
fp32, as the JAX package builds them in ``jnp.float32``; ``strict_fp32``
keeps the card's convolutions and matmuls off TF32, and on deterministic
cuDNN algorithms, while they do.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..utils.profiling import Span


@contextlib.contextmanager
def strict_fp32():
    """cuDNN convolutions and cuBLAS matmuls in full fp32 (no TF32), and
    cuDNN's deterministic algorithms (a transposed convolution's default
    one adds with atomics, so two calls could differ), inside the block,
    whatever the process-wide settings (PyTorch's default lets cuDNN use
    TF32); all are restored on exit. The settings are global: callers run
    one detector at a time, as the server does."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, cudnn.deterministic,
             torch.get_float32_matmul_precision())
    cudnn.allow_tf32, cudnn.deterministic = False, True
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def in_fp32(fn):
    """``fn`` run under ``strict_fp32``."""
    @functools.wraps(fn)
    def run(*args, **kw):
        with strict_fp32():
            return fn(*args, **kw)

    return run


def tensors(sd, device=None, strip: str = "module."
            ) -> Dict[str, torch.Tensor]:
    """Every tensor of ``sd`` (a ``convert.hf.StateDict``, or a dict of
    numpy arrays or tensors) in fp32 on ``device`` (default: the card),
    with a ``strip`` prefix removed from its name."""
    device = resolve_device(device)
    raw = sd.tensors if hasattr(sd, "tensors") else sd
    out = {}
    for k, v in raw.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(np.asarray(v, np.float32)))
        out[k[len(strip):] if strip and k.startswith(strip) else k] = \
            t.to(device=device, dtype=torch.float32)
    return out


def param_device(params) -> torch.device:
    """The device of a parameter dict (the first tensor found)."""
    for v in params.values():
        if isinstance(v, torch.Tensor):
            return v.device
        if isinstance(v, dict):
            return param_device(v)
        if isinstance(v, (list, tuple)) and v:
            return param_device({"_": v[0]})
    raise ValueError("no tensor among the parameters")


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
         stride: int = 1, padding=None, dilation: int = 1,
         groups: int = 1) -> torch.Tensor:
    """NCHW conv; ``padding`` None is the symmetric "same" padding
    dilation (k - 1) / 2 of an odd kernel, as XLA's SAME at stride 1."""
    if padding is None:
        padding = dilation * (w.shape[-1] - 1) // 2
    return F.conv2d(x, w, b, stride=stride, padding=padding,
                    dilation=dilation, groups=groups)


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool, VALID (a trailing odd row/column dropped)."""
    return F.max_pool2d(x, 2, 2)


def host_image(img, device) -> torch.Tensor:
    """A numpy (H, W, C) float32 image as a (1, H, W, C) tensor on
    ``device``."""
    return torch.from_numpy(np.ascontiguousarray(img, np.float32))[None] \
        .to(device)


_TO_HOST = Span("to_host")


def to_host(x: torch.Tensor) -> np.ndarray:
    """``x`` as a numpy array on the host: the host waits for the device's
    work queued before the copy, then copies (span ``to_host``)."""
    with _TO_HOST:
        return x.cpu().numpy()


class Draw:
    """Random weights in a published layout, drawn in call order in
    float32 from ``np.random.default_rng(seed)``, uniform (four times as
    fast to draw as normal numbers) with the standard deviation given:
    conv and linear weights 1 / sqrt(fan_in), biases 0.1, norm scales
    1 +- 0.1, BatchNorm statistics mean 0 +- 0.1 and variance
    U(0.5, 1.5)."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.sd: Dict[str, np.ndarray] = {}

    def _n(self, shape, std):
        """U(-sqrt(3) std, sqrt(3) std): zero mean, standard deviation
        ``std``."""
        out = self.rng.random(shape, dtype=np.float32)
        out -= np.float32(0.5)
        out *= np.float32(2.0 * math.sqrt(3.0) * std)
        return out

    def array(self, name, shape, std=1.0):
        self.sd[name] = self._n(shape, std)

    def conv(self, name, o, i, k, bias=True, kw=None, groups=1):
        kw = k if kw is None else kw
        fan = (i // groups) * k * kw
        self.sd[f"{name}.weight"] = self._n((o, i // groups, k, kw),
                                            1.0 / math.sqrt(fan))
        if bias:
            self.sd[f"{name}.bias"] = self._n((o,), 0.1)

    def conv_transpose(self, name, i, o, k, bias=True):
        self.sd[f"{name}.weight"] = self._n((i, o, k, k),
                                            1.0 / math.sqrt(i * k * k / 4))
        if bias:
            self.sd[f"{name}.bias"] = self._n((o,), 0.1)

    def linear(self, name, o, i, bias=True):
        self.sd[f"{name}.weight"] = self._n((o, i), 1.0 / math.sqrt(i))
        if bias:
            self.sd[f"{name}.bias"] = self._n((o,), 0.1)

    def norm(self, name, c):
        self.sd[f"{name}.weight"] = 1.0 + self._n((c,), 0.1)
        self.sd[f"{name}.bias"] = self._n((c,), 0.1)

    def bn(self, name, c):
        self.norm(name, c)
        self.sd[f"{name}.running_mean"] = self._n((c,), 0.1)
        self.sd[f"{name}.running_var"] = 0.5 + self.rng.random(
            c, dtype=np.float32)


def state_dict(sd):
    """``sd`` as a ``convert.hf.StateDict`` (a dict of arrays or tensors is
    wrapped)."""
    from ..convert.hf import StateDict

    return sd if hasattr(sd, "tensors") else StateDict(sd)


def lin(p, name: str, x: torch.Tensor) -> torch.Tensor:
    """The linear layer ``name`` of a flat parameter dict (its bias, when
    it has one)."""
    return F.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))


def conv_named(p, name: str, x: torch.Tensor, **kw) -> torch.Tensor:
    """The conv ``name`` of a flat parameter dict on NCHW ``x``."""
    return conv(x, p[f"{name}.weight"], p.get(f"{name}.bias"), **kw)
