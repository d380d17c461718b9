"""K1: region-biased cross-attention, a hand-written CUDA kernel with its
plain PyTorch version beside it.

Replaces ``diffusionspatialcontrol_tpu/ops/pallas/region_attention.py:_kernel``
(its caller there is ``region_attention_nlhd``). The kernel is
``csrc/region_attention.cu``: on an H100 it is bound by the bytes of Q, O
and the fp32 bias, since S <= 308. For bf16 operands (the tensor-core body,
``csrc/attention_mma.cuh``) a block copies its rows of the bias into shared
memory once and reuses them for a group of heads; that tile bounds S (808
at D = 160, more at smaller D), and a longer S raises. fp32 operands take
the CUDA-core body of ``csrc/attention.cuh``, which takes any S.

The global logits std and the bias ``w = region * (weight_scale * sigma *
std)`` are plain reductions before the launch, as in the JAX package; sigma
and std stay 0-d device tensors, so nothing here waits for the card. On a
data-parallel mesh the std's moments are all-reduced over the ranks first
and K1 launches as it does on one device.

Dispatch: CPU tensors take ``region_softmax_attention_plain``; CUDA tensors
launch the kernel or raise. ``region_softmax_attention.launches`` counts
launches and ``region_softmax_attention.shapes`` tallies them by (L, S, D);
the launcher adds to both, so every launch counts, whoever calls it.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from ..attention import logits_std_gram_nlhd, region_bias
from . import _build
from ._launch import (
    check_nlhd,
    on_cpu,
    raise_on_error,
    stream_arg,
    strides_arg,
)


def region_softmax_attention_plain(q, k, v, w):
    """Materialized fp32 logits: softmax(scale * Q K^T + w) V, w (B, L, S)
    broadcast over heads. q: (B, L, H, D) -> (B, L, H, D) in q's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) * scale
    s = s + w[:, None].float()
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhls,bshd->bhld", p, v.float())
    out = out / p.sum(dim=-1, keepdim=True)
    return out.transpose(1, 2).to(q.dtype)


def region_softmax_attention_kernel(q, k, v, w):
    """Launch K1 on CUDA operands (no dispatch); counts the launch."""
    dtype_code = check_nlhd(q, k, v)
    b, l, h, d = q.shape
    s_len = k.shape[1]
    if w.shape != (b, l, s_len) or w.device != q.device:
        raise ValueError(f"bias must be (B, L, S) = {(b, l, s_len)} on "
                         f"{q.device}, got {tuple(w.shape)} on {w.device}")
    w = w.float().contiguous()
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = _build.load("region_attention")
    fn = lib.dsc_region_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             out.data_ptr(), dtype_code, b, h, l, s_len, d,
             strides_arg(q, k, v, out), 1.0 / math.sqrt(d), stream_arg(q))
    raise_on_error(err, "region_attention")
    region_softmax_attention.launches += 1
    region_softmax_attention.shapes[(l, s_len, d)] += 1
    return out


def region_softmax_attention(q, k, v, w):
    """softmax(Q K^T / sqrt(D) + w) V with a precomputed bias w (B, L, S)."""
    if on_cpu(q, k, v, w):
        return region_softmax_attention_plain(q, k, v, w)
    return region_softmax_attention_kernel(q, k, v, w)


region_softmax_attention.launches = 0
region_softmax_attention.shapes = collections.Counter()


def region_attention_nlhd(q, k, v, region_state, sigma,
                          weight_scale: float = 1.0, mesh=None):
    """Region attention on (B, L, H, D) operands; region_state (B, L, S),
    sigma a 0-d tensor. The counterpart of the Pallas wrapper of the same
    name; ``mesh`` is its ``axis_name``: the operands are this rank's shard
    and the std is all-reduced over the mesh (``logits_std_gram_nlhd``)."""
    scale = q.shape[-1] ** -0.5
    std = logits_std_gram_nlhd(q, k, scale, mesh=mesh)
    w = region_bias(region_state, sigma, std, weight_scale)
    return region_softmax_attention(q, k, v, w)
