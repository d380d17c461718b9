"""K1 and K2 on the card against their plain PyTorch versions.

Marked ``cuda``: they need a CUDA device and nvcc, and skip without them.
This file imports only torch and the port (no JAX), so it runs on a machine
with a card and no JAX; ``--noconftest`` skips tests/conftest.py, which
loads JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q --noconftest

Tolerances: fp32 operands rtol 2e-4 / atol 2e-5 (the JAX package's kernel
tolerance); bf16 operands against the plain version computed in fp32 on the
same bf16 values, rtol 1e-2 (the bf16 rounding of the output, at most 2^-8
relative) and atol 5% of the reference's RMS (outputs near zero); the same
for K2's pv_bf16/exp2 options against the plain version with those options.
"""

import pytest
import torch

from diffusionspatialcontrol_tpu_torch.ops.kernels import flash_attention as k2
from diffusionspatialcontrol_tpu_torch.ops.kernels import region_attention as k1


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, b, l, s, h, d, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, l, h, d, device=dev, generator=g).to(dtype)
    k = torch.randn(b, s, h, d, device=dev, generator=g).to(dtype)
    v = torch.randn(b, s, h, d, device=dev, generator=g).to(dtype)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 40, 64, 80, 128, 160])
@pytest.mark.parametrize("l,s", [(300, 300), (64, 77), (130, 1)])
def test_k2_fp32_matches_plain(dev, d, l, s):
    q, k, v = _qkv(dev, 2, l, s, 3, d, torch.float32)
    got = k2.flash_attention_kernel(q, k, v)
    torch.testing.assert_close(got, k2.flash_attention_plain(q, k, v),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 40, 80, 160])
@pytest.mark.parametrize("s", [77, 154, 5])
def test_k1_fp32_matches_plain(dev, d, s):
    q, k, v = _qkv(dev, 2, 200, s, 3, d, torch.float32, seed=1)
    w = torch.randn(2, 200, s, device=dev)
    got = k1.region_softmax_attention_kernel(q, k, v, w)
    want = k1.region_softmax_attention_plain(q, k, v, w)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def _assert_bf16_close(got, want):
    assert got.dtype == torch.bfloat16
    atol = 0.05 * float(want.square().mean().sqrt())
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=atol)


@pytest.mark.cuda
def test_bf16_and_options_match_plain(dev):
    q, k, v = _qkv(dev, 2, 256, 256, 8, 160, torch.bfloat16, seed=2)
    qf, kf, vf = q.float(), k.float(), v.float()
    _assert_bf16_close(k2.flash_attention_kernel(q, k, v),
                       k2.flash_attention_plain(qf, kf, vf))
    _assert_bf16_close(
        k2.flash_attention_kernel(q, k, v, pv_bf16=True, use_exp2=True),
        k2.flash_attention_plain(qf, kf, vf, pv_bf16=True, use_exp2=True))
    w = torch.randn(2, 256, 256, device=dev)
    _assert_bf16_close(k1.region_softmax_attention_kernel(q, k, v, w),
                       k1.region_softmax_attention_plain(qf, kf, vf, w))


@pytest.mark.cuda
def test_k1_head_broadcast_and_strided_operands(dev):
    q, k, v = _qkv(dev, 1, 64, 77, 1, 40, torch.float32, seed=3)
    q, k, v = (t.expand(-1, -1, 4, -1).contiguous() for t in (q, k, v))
    w = torch.randn(1, 64, 77, device=dev)
    out = k1.region_softmax_attention_kernel(q, k, v, w)
    for h in range(1, 4):
        torch.testing.assert_close(out[:, :, h], out[:, :, 0], rtol=0,
                                   atol=1e-6)
    # a (B, L, H, D) view of a wider projection: strided rows
    wide = torch.randn(2, 64, 3, 4, 40, device=dev)
    q = wide[:, :, 0]
    got = k2.flash_attention_kernel(q, wide[:, :, 1], wide[:, :, 2])
    want = k2.flash_attention_plain(q, wide[:, :, 1], wide[:, :, 2])
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_wrappers_count_and_refuse(dev):
    q, k, v = _qkv(dev, 1, 64, 64, 2, 40, torch.float32)
    before = k2.flash_attention_nlhd.launches
    k2.flash_attention_nlhd(q, k, v)
    assert k2.flash_attention_nlhd.launches == before + 1
    k2.flash_attention_kernel(q, k, v)  # the launcher itself counts too
    assert k2.flash_attention_nlhd.launches == before + 2
    w = torch.zeros(1, 64, 64, device=dev)
    k1_before = k1.region_softmax_attention.launches
    k1.region_softmax_attention(q, k, v, w)
    k1.region_softmax_attention_kernel(q, k, v, w)
    assert k1.region_softmax_attention.launches == k1_before + 2
    # refused operands launch nothing and count nothing
    with pytest.raises(ValueError):  # no kernel instance for D = 24
        k2.flash_attention_nlhd(*(t[..., :24] for t in (q, k, v)))
    with pytest.raises(TypeError):
        k2.flash_attention_nlhd(q.half(), k.half(), v.half())
    assert k2.flash_attention_nlhd.launches == before + 2
