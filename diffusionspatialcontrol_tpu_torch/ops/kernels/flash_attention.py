"""K2: attention without bias, a hand-written CUDA kernel with its plain
PyTorch version beside it.

Replaces ``diffusionspatialcontrol_tpu/ops/pallas/flash_attention.py:_kernel``
(the single-pass TPU kernel; its caller there is ``flash_attention_nlhd``).
The kernel is ``csrc/flash_attention.cu``: bf16 operands take the
tensor-core body of ``csrc/attention_mma.cuh`` (``mma.sync`` fed by a
``cp.async`` ring of K/V tiles, online softmax in registers, P kept in
registers), fp32 operands the CUDA-core body of ``csrc/attention.cuh``. On
an H100 the 512^2 self-attention is bound by its exps and MMAs, and K/V do
not fit a block's shared memory, so the kernel streams them with an online
softmax instead of the TPU's single pass.

Options: ``pv_bf16`` and ``use_exp2`` as in the Pallas kernel. Its third
option, ``qk_bf16``, only stops that kernel from casting Q and K to fp32
before an fp32-accumulated QK^T; both versions here always form QK^T from
the operands' own values in fp32, so the UNet's ``+qkbf16`` suffix selects
nothing (see ``models/unet.py``).

K2 is also the counterpart of K3, ``flash_attention.py:_stream_kernel``:
the JAX package leaves its single-pass kernel for that streaming body when
K/V outgrow VMEM (S > 12160 at D <= 128, e.g. the level-0 self-attention at
1024^2, L = S = 16384), and the kernel streams K/V tiles with an online
softmax at every S.

Dispatch: CPU tensors take ``flash_attention_plain``; CUDA tensors launch
the kernel or raise. ``flash_attention_nlhd.launches`` counts launches and
``flash_attention_nlhd.shapes`` tallies them by (L, S, D); the launcher
adds to both, so every launch counts, whoever calls it.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from . import _build
from ._launch import (
    check_nlhd,
    on_cpu,
    raise_on_error,
    stream_arg,
    strides_arg,
)

_LOG2E = 1.4426950408889634
_OPT_PV_BF16 = 1
_OPT_EXP2 = 2


def flash_attention_plain(q, k, v, pv_bf16: bool = False,
                          use_exp2: bool = False):
    """Materialized fp32 logits and softmax, as the TPU kernel computes them.
    q: (B, L, H, D); k, v: (B, S, H, D) -> (B, L, H, D) in q's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) * scale
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s * _LOG2E) if use_exp2 else torch.exp(s)
    denom = p.sum(dim=-1, keepdim=True)
    if pv_bf16:
        p = p.to(torch.bfloat16).float()
    out = torch.einsum("bhls,bshd->bhld", p, v.float()) / denom
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_kernel(q, k, v, pv_bf16: bool = False,
                           use_exp2: bool = False):
    """Launch K2 on CUDA operands (no dispatch); counts the launch."""
    opts = (_OPT_PV_BF16 if pv_bf16 else 0) | (_OPT_EXP2 if use_exp2 else 0)
    dtype_code = check_nlhd(q, k, v)
    b, l, h, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = _build.load("flash_attention")
    fn = lib.dsc_flash_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dtype_code, b, h, l, k.shape[1], d,
             strides_arg(q, k, v, out), 1.0 / math.sqrt(d), opts,
             stream_arg(q))
    raise_on_error(err, "flash_attention")
    flash_attention_nlhd.launches += 1
    flash_attention_nlhd.shapes[(l, k.shape[1], d)] += 1
    return out


def flash_attention_nlhd(q, k, v, pv_bf16: bool = False,
                         use_exp2: bool = False):
    """softmax(Q K^T / sqrt(D)) V. q: (B, L, H, D); k, v: (B, S, H, D)."""
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, pv_bf16, use_exp2)
    return flash_attention_kernel(q, k, v, pv_bf16, use_exp2)


flash_attention_nlhd.launches = 0
flash_attention_nlhd.shapes = collections.Counter()
