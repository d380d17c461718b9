"""The PyTorch port's ``unet_apply`` against the JAX package's, tiny config,
fp32, the same converted weights and inputs, with and without a region map.

The JAX side runs ``attn_impl="xla"``; the port runs its kernel path (the
kernels' plain versions on CPU tensors) with and without the ``+exp2``
option. Tolerance: rtol 1e-4 / atol 1e-4 on outputs of magnitude
~1, for a ~40-layer-deep fp32 network whose convolutions and attention sum
in another order on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.models import unet as junet
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.convert.from_jax import params_from_jax
from diffusionspatialcontrol_tpu_torch.models import unet as tunet
from diffusionspatialcontrol_tpu_torch.ops.kernels import flash_attention as k2
from diffusionspatialcontrol_tpu_torch.ops.kernels import region_attention as k1
from tests.test_torch_controlnet import to_jax

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def unet_params():
    """The tiny UNet's weights in both packages' layouts, from the port's
    init (the JAX init's tree and bounds: tests/test_torch_pipeline.py);
    the JAX package's own init compiles each of its random ops (~20 s of a
    worker)."""
    tp = tunet.unet_init(torch.Generator().manual_seed(0),
                         tcfg.tiny_config().unet, torch.float32, "cpu")
    jp = to_jax(tp)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


_jax_unet = jax.jit(junet.unet_apply, static_argnums=(1,))
_jax_unet_impl = jax.jit(junet.unet_apply, static_argnums=(1,),
                         static_argnames=("attn_impl", "conv_impl"))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    t = np.array([500.0, 31.5], np.float32)
    biases = tuple(
        (rng.standard_normal((2, (16 // 2 ** i) ** 2, 77)) * 0.3).astype(
            np.float32) for i in range(4))
    return x, ctx, t, biases


@pytest.mark.parametrize("region", [True, False])
@pytest.mark.parametrize("attn_impl", ["pallas", "pallas+exp2"])
def test_unet_apply_matches_jax(unet_params, region, attn_impl):
    jp, tp = unet_params
    x, ctx, t, biases = _inputs(1)
    sigma = 2.0
    jcond = junet.UNetCond(
        context=jnp.asarray(ctx),
        region=(junet.RegionState(tuple(map(jnp.asarray, biases)),
                                  jnp.asarray(sigma)) if region else None))
    want = np.asarray(_jax_unet(jp, jcfg.tiny_config().unet, jnp.asarray(x),
                                jnp.asarray(t), jcond))
    tcond = tunet.UNetCond(
        context=torch.from_numpy(ctx),
        region=(tunet.RegionState(tuple(map(torch.from_numpy, biases)),
                                  torch.tensor(sigma)) if region else None))
    counts = (k1.region_softmax_attention.launches,
              k2.flash_attention_nlhd.launches)
    got = tunet.unet_apply(tp, tcfg.tiny_config().unet, torch.from_numpy(x),
                           torch.from_numpy(t), tcond, attn_impl=attn_impl)
    assert got.shape == want.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # CPU tensors take the plain versions: no kernel was counted
    assert (k1.region_softmax_attention.launches,
            k2.flash_attention_nlhd.launches) == counts


@pytest.mark.parametrize("conv_impl", ["pallas", "pallas2"])
def test_unet_fused_convs_match_jax_xla(unet_params, conv_impl):
    """The whole tiny UNet with its resnets on K4/K5's plain version against
    the JAX package's unfused ``xla`` path, at the tolerance the JAX package
    holds its own fused path to (tests/test_conv_fused.py: 2e-4, rtol
    1e-3)."""
    jp, tp = unet_params
    x, ctx, t, _ = _inputs(1)
    want = np.asarray(_jax_unet(jp, jcfg.tiny_config().unet, jnp.asarray(x),
                                jnp.asarray(t),
                                junet.UNetCond(context=jnp.asarray(ctx))))
    got = tunet.unet_apply(tp, tcfg.tiny_config().unet, torch.from_numpy(x),
                           torch.from_numpy(t),
                           tunet.UNetCond(context=torch.from_numpy(ctx)),
                           conv_impl=conv_impl)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=2e-4)


def test_unet_rejects_unported_options(unet_params):
    """FreeU, heatmaps and the TGATE cache still raise; ControlNet and T2I
    residuals (``UNetCond``) now run: zero residuals leave the output as it
    is, bit for bit (their parity is tests/test_torch_units.py's)."""
    _, tp = unet_params
    x, ctx, t, _ = _inputs(2)
    cond = tunet.UNetCond(context=torch.from_numpy(ctx))
    args = (tp, tcfg.tiny_config().unet, torch.from_numpy(x),
            torch.from_numpy(t), cond)
    for option in ({"freeu": object()}, {"collect_heatmaps": True},
                   {"xattn_cache": ()}):
        with pytest.raises(NotImplementedError):
            tunet.unet_apply(*args, **option)
    with pytest.raises(ValueError):
        tunet.unet_apply(*args, conv_impl="cudnn")
    plain = tunet.unet_apply(*args)
    skips = [(16, 32)] * 3 + [(8, 32), (8, 64), (8, 64), (4, 64), (4, 128),
                              (4, 128), (2, 128), (2, 128), (2, 128)]
    zero = tunet.UNetCond(
        context=cond.context,
        controlnet_down=tuple(torch.zeros(2, s, s, c) for s, c in skips),
        controlnet_mid=torch.zeros(2, 2, 2, 128),
        t2i_residuals=tuple(torch.zeros(2, s, s, c) for s, c in (
            (16, 32), (8, 64), (4, 128), (2, 128))))
    assert torch.equal(tunet.unet_apply(*args[:4], zero), plain)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_unet_conv_impl_xla_bf16_matches_jax(unet_params, dtype):
    """``conv_impl="xla_bf16"`` rounds each resnet conv's output to the
    compute dtype before its bias. In fp32 that rounds nothing: bitwise
    equal to "xla", and within the fp32 UNet tolerance of the JAX UNet
    (whose "xla_bf16" equals its "xla" bitwise in fp32,
    tests/test_conv_fused.py, so the jitted "xla" UNet stands for it). In
    bf16, within atol/rtol 0.05 of JAX's "xla_bf16", the bound
    tests/test_conv_fused.py holds that path to against "xla"."""
    jp, tp = unet_params
    x, ctx, t, _ = _inputs(4)
    if dtype == "fp32":
        want = np.asarray(_jax_unet(
            jp, jcfg.tiny_config().unet, jnp.asarray(x), jnp.asarray(t),
            junet.UNetCond(context=jnp.asarray(ctx))))
        tdt = torch.float32
    else:
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
        want = np.asarray(_jax_unet_impl(
            jp, jcfg.tiny_config().unet, jnp.asarray(x, jnp.bfloat16),
            jnp.asarray(t),
            junet.UNetCond(context=jnp.asarray(ctx, jnp.bfloat16)),
            attn_impl="xla", conv_impl="xla_bf16"), np.float32)
        tdt = torch.bfloat16
    tp = jax.tree_util.tree_map(lambda a: a.to(tdt), tp)
    args = (tp, tcfg.tiny_config().unet, torch.from_numpy(x).to(tdt),
            torch.from_numpy(t),
            tunet.UNetCond(context=torch.from_numpy(ctx).to(tdt)))
    got = tunet.unet_apply(*args, conv_impl="xla_bf16")
    assert got.dtype == tdt
    if dtype == "fp32":
        assert torch.equal(got, tunet.unet_apply(*args, conv_impl="xla"))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0.05,
                                   atol=0.05)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas+bogus", "flash"])
def test_unet_takes_only_kernel_attention(unet_params, attn_impl):
    """Attention runs only through the kernels: a string that names another
    path raises instead of reaching plain attention."""
    _, tp = unet_params
    x, ctx, t, _ = _inputs(3)
    with pytest.raises(ValueError):
        tunet.unet_apply(tp, tcfg.tiny_config().unet, torch.from_numpy(x),
                         torch.from_numpy(t),
                         tunet.UNetCond(context=torch.from_numpy(ctx)),
                         attn_impl=attn_impl)


def test_flash_options_parse_the_jax_suffixes():
    assert tunet.flash_options("pallas") == {"pv_bf16": False,
                                             "use_exp2": False}
    assert tunet.flash_options("pallas+exp2+qkbf16+pvbf16") == {
        "pv_bf16": True, "use_exp2": True}
