"""The operand checks the attention kernels run before every launch
(``ops/kernels/_launch.py:check_nlhd``). They take tensors of any device, so
they run here on CPU tensors; no kernel is launched.

Both kernel bodies copy 16 bytes at a time: bf16 operands need strides that
are multiples of 8 elements, fp32 operands multiples of 4, a unit stride on
D and a 16-byte-aligned base.
"""

import pytest
import torch

from diffusionspatialcontrol_tpu_torch.ops.kernels._launch import (
    HEAD_DIMS,
    check_nlhd,
)


def _projection(b, l, h, d, dtype):
    """(B, L, H, D) as the UNet makes it: a (B, L, H*D) linear's output
    split into heads (a view, no copy)."""
    return torch.zeros(b, l, h * d, dtype=dtype).reshape(b, l, h, d)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_unet_operand_strides_are_accepted(dtype, d):
    q = _projection(2, 64, 8, d, dtype)
    kv = _projection(2, 77, 8, d, dtype)
    assert check_nlhd(q, kv, kv) == {torch.float32: 0, torch.bfloat16: 1}[
        dtype]


@pytest.mark.parametrize("which", ["row", "head", "batch"])
def test_bf16_strides_off_16_bytes_are_refused(which):
    """A bf16 stride of 4 (mod 8) elements, which fp32's rule of multiples
    of 4 would let through, is refused on each of the three strides."""
    base = torch.zeros(4 * 64 * 2 * 48, dtype=torch.bfloat16)
    stride = {"row": (64 * 2 * 52, 2 * 48 + 4, 48, 1),
              "head": (64 * 2 * 48, 2 * 48, 44, 1),
              "batch": (64 * 2 * 48 + 4, 2 * 48, 48, 1)}[which]
    bad = base.as_strided((2, 64, 2, 40), stride)
    good = _projection(2, 64, 2, 40, torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        check_nlhd(bad, good, good)
    with pytest.raises(ValueError, match="multiples of 8"):
        check_nlhd(good, good, bad)


def test_fp32_keeps_multiples_of_4():
    """fp32 rows 44 elements apart (176 bytes) are accepted; 42 are not."""
    wide = torch.zeros(1, 64, 2, 44)
    assert check_nlhd(*(wide[..., :40],) * 3) == 0
    odd = torch.zeros(1, 64, 2, 42)
    with pytest.raises(ValueError, match="multiples of 4"):
        check_nlhd(*(odd[..., :40],) * 3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unaligned_base_and_non_unit_d_stride_are_refused(dtype):
    good = _projection(1, 64, 2, 40, dtype)
    flat = torch.zeros(1 * 64 * 2 * 40 + 16, dtype=dtype)
    shifted = flat[1:1 + good.numel()].view(1, 64, 2, 40)
    with pytest.raises(ValueError, match="aligned"):
        check_nlhd(good, shifted, shifted)
    with pytest.raises(ValueError, match="unit stride"):
        check_nlhd(good.transpose(2, 3).contiguous().transpose(2, 3), good,
                   good)
