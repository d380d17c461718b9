"""Functional NN layers on parameter dicts (port of ``models/layers.py``).

Public functions keep the JAX package's layout: activations are NHWC / NLC.
Parameters keep the JAX tree's names (``kernel``, ``bias``, ``scale``) in
PyTorch's layouts: a linear ``kernel`` is (out, in) and a conv ``kernel`` is
OIHW. A conv runs on the NCHW view of an NHWC tensor, which is
``channels_last`` in memory, so no copy is made around cuDNN.

Normalization statistics are float32 whatever the activation dtype, and
matmuls accumulate in float32, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.kernels.conv_fused import (
    fold_group_norm,
    gn_silu_conv3x3,
    gn_silu_conv3x3_v2,
)


def _uniform(generator: torch.Generator, shape, bound: float, dtype,
             device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(-bound, bound, generator=generator)
    return t.to(dtype)


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------


def linear_init(generator: torch.Generator, in_features: int,
                out_features: int, bias: bool = True,
                dtype=torch.bfloat16, device=None):
    """U(+-1/sqrt(in)) kernel, zero bias (the JAX package's distribution)."""
    p = {"kernel": _uniform(generator, (out_features, in_features),
                            1.0 / math.sqrt(in_features), dtype, device)}
    if bias:
        p["bias"] = torch.zeros(out_features, dtype=dtype, device=device)
    return p


def linear(p, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p["kernel"].to(x.dtype),
                    None if "bias" not in p else p["bias"].to(x.dtype))


# ---------------------------------------------------------------------------
# Conv2D (NHWC activations, OIHW kernel)
# ---------------------------------------------------------------------------


def as_channels_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a tensor allocated ``channels_last``, the strides
    ``convert/hf.py`` gives a converted conv kernel. A contiguous (O, I, 1,
    1) kernel already counts as channels_last-contiguous, so
    ``.contiguous(memory_format=torch.channels_last)`` would keep its
    contiguous strides, and cuDNN would copy it at every call."""
    return torch.empty(t.shape, dtype=t.dtype, device=t.device,
                       memory_format=torch.channels_last).copy_(t)


def conv_init(generator: torch.Generator, in_channels: int,
              out_channels: int, kernel_size: int = 3,
              dtype=torch.bfloat16, device=None, zero: bool = False):
    """U(+-1/sqrt(fan_in)) kernel (all zero with ``zero``, which draws
    nothing), zero bias."""
    shape = (out_channels, in_channels, kernel_size, kernel_size)
    if zero:
        kernel = torch.zeros(shape, dtype=dtype, device=device)
    else:
        fan_in = in_channels * kernel_size * kernel_size
        kernel = _uniform(generator, shape, 1.0 / math.sqrt(fan_in), dtype,
                          device)
    return {"kernel": as_channels_last(kernel),
            "bias": torch.zeros(out_channels, dtype=dtype, device=device)}


def _same_pads(size: int, k: int, stride: int):
    """XLA's SAME padding: the odd pixel goes to the high side, so a 3x3
    stride-2 conv pads (0, 1), not torch's symmetric (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p, x: torch.Tensor, stride: int = 1, padding: str = "SAME",
           round_before_bias: bool = False) -> torch.Tensor:
    """NHWC conv with an OIHW kernel; ``padding`` is "SAME" or "VALID".

    The library conv adds the bias to its fp32 sums and rounds once to
    ``x.dtype``, as the JAX package's conv with an fp32 output does.
    ``round_before_bias`` rounds the conv's output to ``x.dtype`` first and
    adds the bias in that dtype, as its ``preferred=None`` (the
    ``conv_impl="xla_bf16"`` resnets); in fp32 the two agree (bitwise on
    the CPU, tests/test_torch_unet.py)."""
    w = p["kernel"].to(x.dtype)
    k = w.shape[-1]
    xc = x.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
    pad = 0
    if padding == "SAME":
        ph = _same_pads(x.shape[1], k, stride)
        pw = _same_pads(x.shape[2], k, stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    bias = p["bias"].to(x.dtype)
    if round_before_bias:
        y = F.conv2d(xc, w, None, stride=stride, padding=pad)
        return y.permute(0, 2, 3, 1) + bias
    y = F.conv2d(xc, w, bias, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


CONV_IMPLS = ("xla", "xla_bf16", "pallas", "pallas2")
FUSED_CONV_IMPLS = ("pallas", "pallas2")


def check_conv_impl(conv_impl: Optional[str]) -> str:
    """The resnet conv path: ``None`` or "xla" (plain convs), "xla_bf16"
    (plain convs whose output is rounded to the compute dtype before the
    bias, see ``conv2d``), "pallas" (K4) or "pallas2" (K5)."""
    conv_impl = conv_impl or "xla"
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl={conv_impl!r}: the port takes one of "
                         f"{CONV_IMPLS}")
    return conv_impl


def resnet_fused(p, x: torch.Tensor, groups: int, eps: float,
                 conv_impl: str, t: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The resnet branch through the fused kernels ("pallas": K4, "pallas2":
    K5), as the JAX resnets run it: GroupNorm folded into a per-(batch,
    channel) affine, then norm + SiLU + conv3x3 (+ the time projection
    ``t`` after conv1, + the shortcut after conv2) in one kernel each."""
    fused = gn_silu_conv3x3_v2 if conv_impl == "pallas2" else gn_silu_conv3x3
    # The kernels read NHWC contiguous. On the card a transformer's output
    # is NCHW in memory (cuDNN's 1x1 proj_out conv returns that layout), so
    # the resnets after a transformer copy it; the others copy nothing.
    x = x.contiguous()
    s1, b1 = fold_group_norm(p["norm1"], x, groups, eps)
    h = fused(x, s1, b1, p["conv1"]["kernel"].to(x.dtype), p["conv1"]["bias"],
              channel_bias=None if t is None else t.float())
    s2, b2 = fold_group_norm(p["norm2"], h, groups, eps)
    sc = (conv2d(p["conv_shortcut"], x, padding="VALID").contiguous()
          if "conv_shortcut" in p else x)
    return fused(h, s2, b2, p["conv2"]["kernel"].to(h.dtype),
                 p["conv2"]["bias"], skip=sc)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling of NHWC (``jax.image.resize`` "nearest" at an
    integer ratio repeats each pixel)."""
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0,
                         mode="nearest").permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


def norm_init(num_channels: int, dtype=torch.bfloat16, device=None):
    return {"scale": torch.ones(num_channels, dtype=dtype, device=device),
            "bias": torch.zeros(num_channels, dtype=dtype, device=device)}


def group_norm(p, x: torch.Tensor, num_groups: int = 32,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channel (last) axis of NHWC / NLC tensors, entirely
    in float32 with the biased variance, as the JAX package computes it."""
    xf = x.float().movedim(-1, 1)
    out = F.group_norm(xf, num_groups, p["scale"].float(), p["bias"].float(),
                       eps)
    return out.movedim(1, -1).to(x.dtype)


def layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    out = F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(),
                       p["bias"].float(), eps)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": gelu, "silu": silu}


# ---------------------------------------------------------------------------
# Timestep (sinusoidal) embedding
# ---------------------------------------------------------------------------


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0,
                       max_period: float = 10000.0,
                       device: Optional[torch.device] = None) -> torch.Tensor:
    """Sinusoidal embedding of (possibly fractional) timesteps, in float32:
    half cos / half sin when ``flip_sin_to_cos``."""
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device)
        / (half - freq_shift)
    )
    args = t[..., None] * freqs
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin], -1) if flip_sin_to_cos else torch.cat(
        [sin, cos], -1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb
