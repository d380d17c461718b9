"""K1, K2, K4, K5 and HED's tail on the card against their plain PyTorch
versions.

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
fp32 operands run the CUDA-core body (csrc/attention.cuh), bf16 operands
the tensor-core body (csrc/attention_mma.cuh). HED's tail: atol 2e-6 on a
map in [0, 1] (the same float32 arithmetic, its sums in another order).
"""

import pytest
import torch

from diffusionspatialcontrol_tpu_torch.ops.kernels import flash_attention as k2
from diffusionspatialcontrol_tpu_torch.ops.kernels import hed_fuse
from diffusionspatialcontrol_tpu_torch.ops.kernels import region_attention as k1
from diffusionspatialcontrol_tpu_torch.ops.kernels._launch import HEAD_DIMS

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)


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


K2_OPTIONS = [{}, {"pv_bf16": True}, {"use_exp2": True},
              {"pv_bf16": True, "use_exp2": True}]


@pytest.mark.cuda
@pytest.mark.parametrize("opts", K2_OPTIONS,
                         ids=lambda o: "+".join(o) or "default")
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("l,s", [(300, 300), (130, 1), (130, 5), (64, 77),
                                 (300, 154), (130, 308)])
def test_k2_bf16_tensor_core_body_matches_plain(dev, opts, d, l, s):
    """Ragged L and S (one key, a partial 16-key group, partial 64-key
    tiles, several tiles) at every head dim, with each option."""
    q, k, v = _qkv(dev, 2, l, s, 3, d, torch.bfloat16, seed=5)
    _assert_bf16_close(
        k2.flash_attention_kernel(q, k, v, **opts),
        k2.flash_attention_plain(q.float(), k.float(), v.float(), **opts))


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("s", [1, 5, 77, 154, 308])
@pytest.mark.parametrize("l", [130, 300])
def test_k1_bf16_tensor_core_body_matches_plain(dev, d, s, l):
    """S from one key to four prompt chunks (77 * 4 = 308, four 80-key
    tiles); 8 heads over 2 batches, so the launch groups heads."""
    q, k, v = _qkv(dev, 2, l, s, 8, d, torch.bfloat16, seed=6)
    w = torch.randn(2, l, s, device=dev)
    _assert_bf16_close(
        k1.region_softmax_attention_kernel(q, k, v, w),
        k1.region_softmax_attention_plain(q.float(), k.float(), v.float(), w))


@pytest.mark.cuda
@pytest.mark.parametrize("d,s", [(40, 77), (160, 308), (16, 5)])
def test_k1_bf16_heads_are_bitwise_identical(dev, d, s):
    """The bias broadcasts over heads: identical q/k/v in every head give
    bitwise identical outputs, whichever block and head group ran them."""
    q, k, v = _qkv(dev, 2, 200, s, 1, d, torch.float32, seed=7)
    q, k, v = (t.expand(-1, -1, 8, -1).contiguous().to(torch.bfloat16)
               for t in (q, k, v))
    out = k1.region_softmax_attention_kernel(
        q, k, v, torch.randn(2, 200, s, device=dev))
    for h in range(1, 8):
        assert torch.equal(out[:, :, h], out[:, :, 0]), h


@pytest.mark.cuda
@pytest.mark.parametrize("kern", ["K1", "K2"])
@pytest.mark.parametrize("d", [40, 160])
def test_bf16_strided_operands(dev, kern, d):
    """(B, L, H, D) views of one wider projection: rows 3*H*D apart."""
    g = torch.Generator(device=dev).manual_seed(8)
    wide = torch.randn(2, 130, 3, 4, d, device=dev, generator=g).to(
        torch.bfloat16)
    q, k, v = wide[:, :, 0], wide[:, :77, 1], wide[:, :77, 2]
    ref = (q.float(), k.float(), v.float())
    if kern == "K2":
        got, want = (k2.flash_attention_kernel(q, k, v),
                     k2.flash_attention_plain(*ref))
    else:
        w = torch.randn(2, 130, 77, device=dev, generator=g)
        got, want = (k1.region_softmax_attention_kernel(q, k, v, w),
                     k1.region_softmax_attention_plain(*ref, w))
    _assert_bf16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kern", ["K1", "K2"])
@pytest.mark.parametrize("d,s", [(40, 77), (40, 130), (80, 5), (160, 154),
                                 (40, 152), (80, 227), (160, 152),
                                 (160, 227)])
def test_bf16_nan_past_the_operands_stays_out(dev, kern, d, s):
    """Q, K and V as views of buffers that hold NaN just past row L or S and
    in the 8 columns past D (D = 40 pads QK^T's depth to 48 there): the
    kernel zero-fills what it copies beyond the operands, so the output is
    finite and matches the plain version. S = 152 and 227 are the id counts
    of long-mode prompts of 2 and 3 chunks (75 n + 2): ragged in the last
    key tile."""
    b, l, h = 2, 100, 3

    def poisoned(rows, n_valid, seed):
        buf = torch.full((b, rows + 16, h, d + 8), float("nan"), device=dev,
                         dtype=torch.bfloat16)
        g = torch.Generator(device=dev).manual_seed(seed)
        view = buf[:, :n_valid, :, :d]
        view.copy_(torch.randn(view.shape, device=dev, generator=g))
        return view

    q, k, v = poisoned(l, l, 1), poisoned(s, s, 2), poisoned(s, s, 3)
    ref = (q.float(), k.float(), v.float())
    if kern == "K2":
        got, want = (k2.flash_attention_kernel(q, k, v),
                     k2.flash_attention_plain(*ref))
    else:
        w = torch.randn(b, l, s, device=dev)
        got, want = (k1.region_softmax_attention_kernel(q, k, v, w),
                     k1.region_softmax_attention_plain(*ref, w))
    assert torch.isfinite(got).all()
    _assert_bf16_close(got, want)


@pytest.mark.cuda
def test_k1_bf16_bias_tile_bounds_s(dev):
    """At D = 160 the bias rows of a block fit shared memory up to S = 808
    (ten prompt chunks); a longer S is refused, and fp32 takes any S."""
    q, k, v = _qkv(dev, 1, 40, 809, 2, 160, torch.bfloat16, seed=9)
    w = torch.randn(1, 40, 809, device=dev)
    _assert_bf16_close(
        k1.region_softmax_attention_kernel(q, k[:, :808], v[:, :808],
                                           w[..., :808]),
        k1.region_softmax_attention_plain(q.float(), k[:, :808].float(),
                                          v[:, :808].float(), w[..., :808]))
    with pytest.raises(RuntimeError):
        k1.region_softmax_attention_kernel(q, k, v, w)
    qf, kf, vf = q.float(), k.float(), v.float()
    torch.testing.assert_close(
        k1.region_softmax_attention_kernel(qf, kf, vf, w),
        k1.region_softmax_attention_plain(qf, kf, vf, w), rtol=2e-4,
        atol=2e-5)


def _p_rounding_operands(dev, b, l, s, h, d):
    """Operands on which rounding P to bf16 moves the output by about a
    third. Every query is e0; even keys are 0 (logit 0, P = 1 exactly, the
    max), odd keys -beta e0 (P = x = exp(-scale beta), about 1 - 1.5 * 2^-8,
    half-way between two bf16 values, so bf16(x) is 2^-9 off); V is +1 on
    even keys and -1 on odd ones. The output, about (1 - x) / (1 + x) =
    0.003 in every element, is a difference of sums of P, so P's 2^-9
    error is a third of it, where hi + lo (2^-17) and the bf16 output
    (2^-9 relative) stay near 0.2%."""
    beta = 0.0058766 * d ** 0.5  # scale * beta = -log(1 - 1.5 * 2^-8)
    q = torch.zeros(b, l, h, d, device=dev)
    q[..., 0] = 1
    k = torch.zeros(b, s, h, d, device=dev)
    k[:, 1::2, :, 0] = -beta
    v = torch.ones(b, s, h, d, device=dev)
    v[:, 1::2] = -1
    return tuple(t.to(torch.bfloat16) for t in (q, k, v))


def _rel_err(got, want):
    return float(((got.float() - want) / want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 80, 160])
def test_bf16_p_is_not_rounded_unless_pv_bf16(dev, d):
    """The default instances (P as bf16 hi + lo) match the unrounded fp32
    reference to 1% on operands where a bf16 P is a third off; the pv_bf16
    instances (hi only) are that far off, and match the plain version that
    rounds P. K1 takes no options: its result is held to the reference,
    and P rounded on the host shows that hi alone would miss it."""
    q, k, v = _p_rounding_operands(dev, 1, 130, 130, 2, d)
    ref = (q.float(), k.float(), v.float())
    want = k2.flash_attention_plain(*ref)
    assert float(want.abs().min()) > 1e-3
    for opts in K2_OPTIONS:
        got = k2.flash_attention_kernel(q, k, v, **opts)
        if opts.get("pv_bf16"):
            assert _rel_err(got, want) > 0.1, opts
            _assert_bf16_close(got, k2.flash_attention_plain(*ref, **opts))
        else:
            assert _rel_err(got, want) < 0.01, opts
    w = torch.zeros(1, 130, 130, device=dev)
    assert _rel_err(k1.region_softmax_attention_kernel(q, k, v, w),
                    k1.region_softmax_attention_plain(*ref, w)) < 0.01
    s = torch.einsum("blhd,bshd->bhls", *ref[:2]) * d ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))  # as the kernel: P / l
    hi_only = torch.einsum("bhls,bshd->blhd", p.to(torch.bfloat16).float(),
                           ref[2]) / p.sum(-1).transpose(1, 2)[..., None]
    assert _rel_err(hi_only, want) > 0.1


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
    assert k1.region_softmax_attention.shapes[(64, 64, 40)] >= 2
    # refused operands launch nothing and count nothing
    with pytest.raises(ValueError):  # no kernel instance for D = 24
        k2.flash_attention_nlhd(*(t[..., :24] for t in (q, k, v)))
    with pytest.raises(TypeError):
        k2.flash_attention_nlhd(q.half(), k.half(), v.half())
    # bf16 rows 44 elements apart: not whole 16-byte words
    wide = torch.zeros(1, 64, 2, 44, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        k2.flash_attention_nlhd(*(wide[..., :40],) * 3)
    assert k2.flash_attention_nlhd.launches == before + 2


# ---------------------------------------------------------------------------
# K4 and K5: the fused GroupNorm-affine + SiLU + conv3x3. Tolerances: fp32
# 5e-5 absolute (tests/test_conv_fused.py), bf16 as above.
# ---------------------------------------------------------------------------


def _conv_operands(dev, b, h, w, c_in, c_out, dtype, temb, skip, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, h, w, c_in, device=dev, generator=g)
    scale = 1 + 0.1 * torch.randn(b, c_in, device=dev, generator=g)
    bias = 0.1 * torch.randn(b, c_in, device=dev, generator=g)
    kern = (torch.rand(c_out, c_in, 3, 3, device=dev, generator=g) * 2 - 1) \
        / (9 * c_in) ** 0.5
    cb = 0.1 * torch.randn(c_out, device=dev, generator=g)
    xb = torch.randn(b, c_out, device=dev, generator=g) if temb else None
    sk = torch.randn(b, h, w, c_out, device=dev, generator=g) if skip \
        else None
    return (x.to(dtype), scale, bias,
            kern.to(dtype).contiguous(memory_format=torch.channels_last), cb,
            xb, None if sk is None else sk.to(dtype))


CONV_SHAPES = [(2, 12, 10, 32, 48, True, True), (1, 7, 13, 24, 40, True, True),
               (1, 10, 6, 640, 32, True, False), (1, 33, 17, 16, 136, False,
                                                  True),
               (2, 64, 64, 320, 320, True, False), (1, 3, 130, 64, 8, False,
                                                    False),
               (2, 8, 8, 2560, 1280, False, True),
               (2, 16, 16, 1280, 1280, True, False)]
# Where the bf16 bodies split the C_in chunks over several blocks a tile.
SPLIT_SHAPES = CONV_SHAPES[-2:]


def _conv_launcher(version):
    from diffusionspatialcontrol_tpu_torch.ops.kernels import conv_fused as kc

    return {"K4": kc.gn_silu_conv3x3_kernel,
            "K5": kc.gn_silu_conv3x3_v2_kernel}[version]


def _assert_conv_bf16_close(got, want):
    """Elementwise as _assert_bf16_close, and ||got - want|| / ||want|| <=
    4e-3: both sides round the same activations to bf16 and sum exact
    products in fp32, so they differ by the order of the sum and the final
    rounding (about 1e-3 RMS); a dropped chunk or tap is tens of percent."""
    _assert_bf16_close(got, want)
    rel = float((got.float() - want).norm() / want.norm())
    assert rel <= 4e-3, rel


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["K4", "K5"])
@pytest.mark.parametrize("shape", CONV_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:5])))
def test_conv_kernels_match_plain(dev, version, shape):
    from diffusionspatialcontrol_tpu_torch.ops.kernels import conv_fused as kc

    launch = _conv_launcher(version)
    b, h, w, c_in, c_out, temb, skip = shape
    ops = _conv_operands(dev, b, h, w, c_in, c_out, torch.float32, temb, skip)
    torch.testing.assert_close(launch(*ops), kc.gn_silu_conv3x3_plain(*ops),
                               rtol=0, atol=5e-5)
    ops = _conv_operands(dev, b, h, w, c_in, c_out, torch.bfloat16, temb,
                         skip, seed=1)
    _assert_conv_bf16_close(launch(*ops),
                            kc.gn_silu_conv3x3_plain(*ops).float())


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["K4", "K5"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:5])))
def test_conv_split_k_is_bitwise_repeatable(dev, version, shape):
    """The split partials are summed in split order by the tile's last
    block: two launches give the same bits, and the tickets are back at 0."""
    from diffusionspatialcontrol_tpu_torch.ops.kernels import conv_fused as kc

    b, h, w, c_in, c_out, temb, skip = shape
    assert kc.conv_plan(version, b, h, w, c_in, c_out).splits > 1
    ops = _conv_operands(dev, b, h, w, c_in, c_out, torch.bfloat16, temb,
                         skip, seed=2)
    launch = _conv_launcher(version)
    first = launch(*ops)
    for _ in range(2):
        assert torch.equal(launch(*ops), first)
    assert int(kc._ticket_array(first.device).abs().sum()) == 0
    _assert_conv_bf16_close(first, kc.gn_silu_conv3x3_plain(*ops).float())


def _poisoned(shape, values, pad=4096):
    """A contiguous view of the first elements of a wider buffer that holds
    NaN past them."""
    buf = torch.full((values.numel() + pad,), float("nan"),
                     dtype=values.dtype, device=values.device)
    view = buf[:values.numel()].view(shape)
    view.copy_(values.reshape(shape))
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["K4", "K5"])
@pytest.mark.parametrize("shape", [(1, 7, 13, 24, 40, True, True),
                                   (1, 33, 17, 16, 136, False, True),
                                   (2, 8, 8, 2560, 1280, False, True)],
                         ids=lambda s: "x".join(map(str, s[:5])))
def test_conv_bf16_nan_past_the_operands_stays_out(dev, version, shape):
    """x, the weights and the skip as views of buffers that hold NaN just
    past their last element: ragged C_in and C_out (24, 40, 136 against
    chunks of 16 or 64 and tiles of 128 channels) and the halo past the
    last pixel must be zero-filled, never read."""
    from diffusionspatialcontrol_tpu_torch.ops.kernels import conv_fused as kc

    b, h, w, c_in, c_out, temb, skip = shape
    x, scale, bias, kern, cb, xb, sk = _conv_operands(
        dev, b, h, w, c_in, c_out, torch.bfloat16, temb, skip, seed=3)
    x = _poisoned(x.shape, x)
    kern = _poisoned((c_out, 3, 3, c_in),
                     kern.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    sk = _poisoned(sk.shape, sk)
    got = _conv_launcher(version)(x, scale, bias, kern, cb, xb, sk)
    assert torch.isfinite(got).all()
    _assert_conv_bf16_close(got, kc.gn_silu_conv3x3_plain(
        x, scale, bias, kern, cb, xb, sk).float())


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["K4", "K5"])
def test_conv_fp32_keeps_the_cuda_core_bodies(dev, version):
    """fp32 operands launch the CUDA-core bodies of PR 2, bf16 operands the
    tensor-core ones, by the kernel names the profiler records."""
    from torch.profiler import ProfilerActivity, profile

    names = {"K4": ("conv_direct_kernel", "conv_mma_kernel"),
             "K5": ("conv_igemm_kernel", "conv_wgmma_kernel")}[version]
    for dtype, want, other in ((torch.float32, *names),
                               (torch.bfloat16, *names[::-1])):
        ops = _conv_operands(dev, 2, 12, 10, 32, 48, dtype, True, True)
        _conv_launcher(version)(*ops)  # built and loaded before the trace
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _conv_launcher(version)(*ops)
            torch.cuda.synchronize()
        launched = " ".join(e.key for e in prof.key_averages())
        assert want in launched and other not in launched, (dtype, launched)


@pytest.mark.cuda
def test_conv_wrappers_count_and_refuse(dev):
    from diffusionspatialcontrol_tpu_torch.ops.kernels import conv_fused as kc

    ops = _conv_operands(dev, 1, 8, 8, 16, 16, torch.float32, True, True)
    before = (kc.gn_silu_conv3x3.launches, kc.gn_silu_conv3x3_v2.launches)
    kc.gn_silu_conv3x3(*ops)
    kc.gn_silu_conv3x3_v2_kernel(*ops)  # the launcher itself counts too
    assert (kc.gn_silu_conv3x3.launches,
            kc.gn_silu_conv3x3_v2.launches) == (before[0] + 1, before[1] + 1)
    assert kc.gn_silu_conv3x3.shapes[(1, 8, 8, 16, 16)] >= 1
    x, scale, bias, kern, cb, xb, sk = ops
    with pytest.raises(ValueError):  # C_in not a multiple of 8
        kc.gn_silu_conv3x3(x[..., :12].contiguous(), scale[:, :12],
                           bias[:, :12], kern[:, :12].contiguous(
                               memory_format=torch.channels_last), cb)
    with pytest.raises(ValueError):  # OIHW contiguous, not channels_last
        kc.gn_silu_conv3x3_v2(x, scale, bias, kern.contiguous(), cb)
    with pytest.raises(TypeError):
        kc.gn_silu_conv3x3(x.half(), scale, bias, kern.half(), cb)
    with pytest.raises(ValueError):  # a CUDA tensor never reaches the plain
        kc.gn_silu_conv3x3(x, scale.cpu(), bias, kern, cb)
    assert (kc.gn_silu_conv3x3.launches,
            kc.gn_silu_conv3x3_v2.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_k2_at_the_k3_shape_matches_plain(dev):
    """K2 at L = S = 16384 (the hires pass's level-0 self-attention, where
    the JAX package streams), against the plain version on 2048 query rows
    at a time, and its per-shape tally."""
    q, k, v = _qkv(dev, 2, 16384, 16384, 8, 40, torch.bfloat16, seed=4)
    before = k2.flash_attention_nlhd.shapes[(16384, 16384, 40)]
    got = k2.flash_attention_nlhd(q, k, v)
    assert k2.flash_attention_nlhd.shapes[(16384, 16384, 40)] == before + 1
    kf, vf = k.float(), v.float()
    for i in range(0, 16384, 2048):
        _assert_bf16_close(got[:, i:i + 2048], k2.flash_attention_plain(
            q[:, i:i + 2048].float(), kf, vf))


# The VAE encoder's resnet convs on new channel pairs (img2img and inpaint
# at 512^2: conv1 of the first resnet of levels 1 and 2), at their maps.
ENCODER_SHAPES = [(1, 256, 256, 128, 256, False, False),
                  (1, 128, 128, 256, 512, False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["K4", "K5"])
@pytest.mark.parametrize("shape", ENCODER_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:5])))
def test_conv_kernels_at_the_encoder_channel_pairs(dev, version, shape):
    """fp32 (the encoder's dtype on an fp32 image: the CUDA-core bodies) and
    bf16 (the tensor-core bodies), tolerances as above."""
    from diffusionspatialcontrol_tpu_torch.ops.kernels import conv_fused as kc

    launch = _conv_launcher(version)
    b, h, w, c_in, c_out, temb, skip = shape
    ops = _conv_operands(dev, b, h, w, c_in, c_out, torch.float32, temb, skip,
                         seed=5)
    torch.testing.assert_close(launch(*ops), kc.gn_silu_conv3x3_plain(*ops),
                               rtol=0, atol=5e-5)
    ops = _conv_operands(dev, b, h, w, c_in, c_out, torch.bfloat16, temb,
                         skip, seed=6)
    _assert_conv_bf16_close(launch(*ops),
                            kc.gn_silu_conv3x3_plain(*ops).float())


# The large requests' extremes: the UNet's 17 x 30 level at 1088 x 1920
# (2560 -> 1280 with the skip: the C_in chunks split in two) and the
# decoder's largest operand there, conv1 of the 1920-wide level's first
# resnet (1088 x 1920 x 256 -> 128: 5.3e8 bf16 elements in).
LARGE_SHAPES = [(2, 17, 30, 2560, 1280, False, True),
                (1, 1088, 1920, 256, 128, False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["K4", "K5"])
@pytest.mark.parametrize("shape", LARGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:5])))
def test_conv_kernels_at_the_large_request_shapes(dev, version, shape):
    """fp32 and bf16 against the plain version, tolerances as above; where
    the plan splits, two launches give the same bits."""
    from diffusionspatialcontrol_tpu_torch.ops.kernels import conv_fused as kc

    launch = _conv_launcher(version)
    b, h, w, c_in, c_out, temb, skip = shape
    ops = _conv_operands(dev, b, h, w, c_in, c_out, torch.float32, temb, skip,
                         seed=7)
    torch.testing.assert_close(launch(*ops), kc.gn_silu_conv3x3_plain(*ops),
                               rtol=0, atol=5e-5)
    ops = _conv_operands(dev, b, h, w, c_in, c_out, torch.bfloat16, temb,
                         skip, seed=8)
    got = launch(*ops)
    _assert_conv_bf16_close(got, kc.gn_silu_conv3x3_plain(*ops).float())
    splits = kc.conv_plan(version, b, h, w, c_in, c_out).splits
    assert splits == (2 if h == 17 else 1)
    if splits > 1:
        assert torch.equal(launch(*ops), got)


# SD2.1 at 512^2: (L, heads) of each UNet level, D = 64, S = 77 text tokens.
SD21_LEVELS = [(4096, 5), (1024, 10), (256, 20), (64, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("l,h", SD21_LEVELS, ids=lambda v: str(v))
def test_k1_k2_at_the_sd21_shapes(dev, l, h):
    """K2's self-attention (S = L) and K1's region cross-attention (S = 77)
    at D = 64 with SD2.1's head counts, bf16 (the tensor-core body) and
    fp32 (the CUDA-core body), against the plain versions."""
    q, k, v = _qkv(dev, 2, l, l, h, 64, torch.bfloat16, seed=7)
    _assert_bf16_close(k2.flash_attention_kernel(q, k, v),
                       k2.flash_attention_plain(q.float(), k.float(),
                                                v.float()))
    q, k, v = _qkv(dev, 2, l, 77, h, 64, torch.bfloat16, seed=8)
    w = torch.randn(2, l, 77, device=dev)
    _assert_bf16_close(
        k1.region_softmax_attention_kernel(q, k, v, w),
        k1.region_softmax_attention_plain(q.float(), k.float(), v.float(),
                                          w))
    q, k, v = (t.float() for t in (q, k, v))
    torch.testing.assert_close(
        k1.region_softmax_attention_kernel(q, k, v, w),
        k1.region_softmax_attention_plain(q, k, v, w), rtol=2e-4, atol=2e-5)


def _hed_sides(dev, th, tw, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(th >> k, tw >> k, device=dev, generator=g) * 2
            for k in range(hed_fuse.SIDES)]


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("th,tw,h,w", [(1024, 768, 1024, 768),
                                       (256, 336, 250, 333)],
                         ids=["1024x768", "cropped"])
def test_hed_tail_matches_plain(dev, th, tw, h, w, channels):
    sides = _hed_sides(dev, th, tw)
    got = hed_fuse.hed_tail_kernel(sides, h, w, channels)
    want = hed_fuse.hed_tail_plain(sides, h, w, channels)
    assert got.shape == (h, w, channels) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


@pytest.mark.cuda
def test_hed_tail_counts_and_refuses(dev):
    from torch.profiler import ProfilerActivity, profile

    from diffusionspatialcontrol_tpu_torch.utils import profiling

    sides = _hed_sides(dev, 64, 80, seed=1)
    before = hed_fuse.hed_tail.launches
    fuse = profiling.Span("hed.fuse")
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with fuse:
                hed_fuse.hed_tail(sides, 50, 70)
    assert hed_fuse.hed_tail.launches == before + 2
    spans = [s for s in profiling.recorded_spans() if s.name == "hed.fuse"]
    assert [s.counters for s in spans[-2:]] == [{"hed.tail_kernel": 1}] * 2
    # refused operands launch nothing and count nothing
    with pytest.raises(ValueError):  # a CUDA map never reaches the plain
        hed_fuse.hed_tail(sides[:4] + [sides[4].cpu()], 50, 70)
    with pytest.raises(ValueError):  # side 3 not a quarter of side 1
        hed_fuse.hed_tail(sides[:3] + [sides[3][:-1]] + sides[4:], 50, 70)
    with pytest.raises(TypeError):
        hed_fuse.hed_tail([s.double() for s in sides], 50, 70)
    assert hed_fuse.hed_tail.launches == before + 2
