"""Operand checks and ``ctypes`` plumbing shared by the attention kernels."""

from __future__ import annotations

import ctypes

import torch

HEAD_DIMS = (16, 32, 40, 64, 80, 128, 160)  # template instances in csrc
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every operand lies on the CPU (the plain version runs);
    False when every operand is a CUDA tensor (the kernel runs). Anything
    else raises: there is no path from a CUDA tensor to the plain version."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"operands must all be on the CPU or all on one CUDA "
                     f"device, got {sorted(str(t.device) for t in tensors)}")


def check_nlhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Validate (B, L, H, D) / (B, S, H, D) CUDA operands for the kernels;
    returns the kernel's dtype code."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, L, H, D) / (B, S, H, D)")
    b, l, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the kernels take fp32 or bf16 operands of one "
                        f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} has no kernel instance "
                         f"(supported: {HEAD_DIMS})")
    if l == 0 or k.shape[1] == 0:
        raise ValueError("empty query or key sequence")
    # Both bodies copy 16 bytes at a time: a unit stride on D, the other
    # strides whole 16-byte words (4 fp32 or 8 bf16 elements), and a
    # 16-byte-aligned base.
    words = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % words for s in t.stride()[:3]):
            raise ValueError(f"{name} ({t.dtype}) needs a unit stride on D "
                             f"and strides that are multiples of {words}, "
                             f"got {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    return _DTYPES[q.dtype]


def strides_arg(*tensors: torch.Tensor):
    """The [b, row, h] element strides of each (B, *, H, D) operand."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def stream_arg(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on_error(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
