"""The port's model presets, VAE encoder, asymmetric (mask-conditioned)
decoder and nearest mask resize against the JAX package on the CPU.

Parameters come from the port's own init, moved to the JAX package's
layouts (quicker than its init; and its ``vae_init`` splits 40 keys, which
the asymmetric presets' deeper decoder outgrows). Tolerances: rtol/atol
1e-5 for an encode; for a decode, rtol 1e-5 and atol 1e-5 of the output's
largest magnitude, since the fp32 convolutions sum in another order on
each side (the plain decode of the same weights differs by 1.4e-5 on
outputs of 3.5). The port's fused resnets ("pallas", "pallas2": the
kernels' plain versions on CPU tensors) are held against the JAX package's
unfused "xla" encode, to which its own tests hold its fused path. The
nearest resizes only pick pixels: bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.models import vae as jvae
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.convert.from_jax import params_from_jax
from diffusionspatialcontrol_tpu_torch.models import vae as tvae
from diffusionspatialcontrol_tpu_torch.ops.resize import resize_latents

PRESETS = [("sd15_inpaint_config", ()), ("sd15_asym_inpaint_config", (1.0,)),
           ("sd15_asym_inpaint_config", (1.5,)), ("sd21_config", (False,)),
           ("sd21_config", (True,)), ("sd15_config", ()),
           ("tiny_config", ())]


@pytest.mark.parametrize("name,args", PRESETS,
                         ids=[f"{n}{a}" for n, a in PRESETS])
def test_presets_match_jax_field_by_field(name, args):
    want = dataclasses.asdict(getattr(jcfg, name)(*args))
    got = dataclasses.asdict(getattr(tcfg, name)(*args))
    assert got == want


def to_jax(tree, name=None):
    """The port's parameter tree in the JAX package's layouts (the inverse
    of ``params_from_jax``)."""
    if isinstance(tree, dict):
        return {k: to_jax(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_jax(v) for v in tree]
    a = tree.numpy()
    if name == "kernel" and a.ndim == 4:
        a = a.transpose(2, 3, 1, 0)
    elif name == "kernel" and a.ndim == 2:
        a = a.T
    return jnp.asarray(np.ascontiguousarray(a))


def _asym(vae_cfg, scale, layers=None):
    return dataclasses.replace(
        vae_cfg, asymmetric=True,
        decoder_block_out_channels=tuple(int(c * scale)
                                         for c in vae_cfg.block_out_channels),
        decoder_layers_per_block=layers or vae_cfg.layers_per_block + 1)


@pytest.fixture(scope="module")
def vae():
    cfg = tcfg.tiny_config().vae
    tp = tvae.vae_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                       "cpu")
    return to_jax(tp), tp


_jax_encode = jax.jit(jvae.vae_encode, static_argnums=(1,),
                      static_argnames=("sample_mode", "conv_impl"))


def _images(seed, b=2, side=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (b, side, side, 3)).astype(np.float32)


@pytest.mark.parametrize("conv_impl", ["xla", "xla_bf16", "pallas",
                                       "pallas2"])
@pytest.mark.parametrize("mode", ["argmax", "sample"])
def test_vae_encode_matches_jax(vae, mode, conv_impl):
    """conv_in, down blocks with the (0, 1)-padded stride-2 downsample, mid
    block, moments in fp32 with logvar clipped; "sample" with JAX's own
    posterior draw injected as ``eps``."""
    jp, tp = vae
    img = _images(1)
    key = jax.random.PRNGKey(5)
    eps = np.array(jax.random.normal(key, (2, 8, 8, 4), jnp.float32))
    jimpl = conv_impl if conv_impl.startswith("xla") else "xla"
    want = np.asarray(_jax_encode(jp, jcfg.tiny_config().vae,
                                  jnp.asarray(img), rng=key, sample_mode=mode,
                                  conv_impl=jimpl))
    got = tvae.vae_encode(tp, tcfg.tiny_config().vae, torch.from_numpy(img),
                          eps=torch.from_numpy(eps) if mode == "sample"
                          else None, sample_mode=mode, conv_impl=conv_impl)
    assert got.shape == want.shape == (2, 8, 8, 4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_vae_encode_needs_eps_to_sample(vae):
    _, tp = vae
    img = torch.from_numpy(_images(2, b=1))
    with pytest.raises(ValueError):
        tvae.vae_encode(tp, tcfg.tiny_config().vae, img)
    with pytest.raises(ValueError):
        tvae.vae_encode(tp, tcfg.tiny_config().vae, img, sample_mode="mode")


def _mask(b, side, seed):
    rng = np.random.default_rng(seed)
    m = (rng.uniform(size=(b, side, side)) > 0.5).astype(np.float32)
    m[:, :, side // 2:] = 1.0
    return m


@pytest.mark.parametrize("scale", [1.0, 1.5])
def test_asymmetric_decode_matches_jax(scale):
    """The conditioned decode of an asymmetric VAE with the presets' deeper
    decoder (3 resnets a block): the condition encoder (3x3 stride 1, 4x4
    stride 2 on a (1, 1)-padded input, features recorded before the ReLU
    and keyed by shape) and the blend before every up block and the output
    norm, with a ragged mask shrunk by nearest resizing."""
    cfg = _asym(tcfg.tiny_config().vae, scale)
    tp = tvae.vae_init(torch.Generator().manual_seed(1), cfg, torch.float32,
                       "cpu")
    jp = to_jax(tp)
    rng = np.random.default_rng(3)
    z = (rng.standard_normal((2, 8, 8, 4)) * 0.2).astype(np.float32)
    mask = _mask(2, 64, 4)[..., None]
    cond = _images(5) * (1.0 - mask)
    jvcfg = _asym(jcfg.tiny_config().vae, scale)
    want = np.asarray(jvae.vae_decode(jp, jvcfg, jnp.asarray(z),
                                      cond_image=jnp.asarray(cond),
                                      cond_mask=jnp.asarray(mask)))
    got = tvae.vae_decode(tp, cfg, torch.from_numpy(z),
                          cond_image=torch.from_numpy(cond),
                          cond_mask=torch.from_numpy(mask))
    assert got.shape == (2, 64, 64, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    plain = tvae.vae_decode(tp, cfg, torch.from_numpy(z))
    assert float((plain - got).abs().max()) > 0.1  # the condition is used


def test_conditioned_decode_needs_an_asymmetric_vae(vae):
    _, tp = vae
    with pytest.raises(ValueError):
        tvae.vae_decode(tp, tcfg.tiny_config().vae, torch.zeros(1, 8, 8, 4),
                        cond_image=torch.zeros(1, 64, 64, 3),
                        cond_mask=torch.zeros(1, 64, 64, 1))


@pytest.mark.parametrize("side,out", [(64, 8), (512, 64), (64, 16),
                                      (48, 32)])
def test_mask_resize_is_jax_nearest_bitwise(side, out):
    """The masks are shrunk as ``jax.image.resize(..., "nearest")`` shrinks
    them, from half-pixel centres; ``F.interpolate``'s "nearest" picks other
    pixels."""
    m = _mask(2, side, 6)[..., None]
    want = np.asarray(jax.image.resize(jnp.asarray(m), (2, out, out, 1),
                                       "nearest"))
    got = resize_latents(torch.from_numpy(m), out, out, mode="nearest")
    np.testing.assert_array_equal(got.numpy(), want)
    floor = torch.nn.functional.interpolate(
        torch.from_numpy(m).permute(0, 3, 1, 2), size=(out, out),
        mode="nearest").permute(0, 2, 3, 1)
    assert not torch.equal(floor, got)


@pytest.mark.parametrize("scale", [1.0, 1.5])
def test_asymmetric_vae_converts_from_jax(scale):
    """The port's init has the tree and shapes of the JAX package's (taken
    with two resnets a block: its init's 40 keys do not reach the presets'
    three), and ``params_from_jax`` brings a JAX-layout tree across: the
    condition encoder's 3x3 and 4x4 kernels HWIO -> OIHW, the widened
    decoder as it is."""
    jvcfg = _asym(jcfg.tiny_config().vae, scale, layers=2)
    shapes = jax.eval_shape(
        lambda: jvae.vae_init(jax.random.PRNGKey(0), jvcfg, jnp.float32))
    own = tvae.vae_init(torch.Generator().manual_seed(0),
                        _asym(tcfg.tiny_config().vae, scale, layers=2),
                        torch.float32, "cpu")
    jp = to_jax(own)
    assert (jax.tree_util.tree_structure(jp)
            == jax.tree_util.tree_structure(shapes))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_equal(a.shape, b.shape), jp, shapes)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a.numpy(), b.numpy()),
        tp, own)
    layers = jp["decoder"]["condition_encoder"]["layers"]
    assert [l["kernel"].shape[:2] for l in layers] == [(3, 3), (3, 3),
                                                       (4, 4), (4, 4), (4, 4)]
    assert tp["decoder"]["condition_encoder"]["layers"][2]["kernel"].shape \
        == (layers[2]["kernel"].shape[3], layers[2]["kernel"].shape[2], 4, 4)
    up0 = tp["decoder"]["up_blocks"][0]["resnets"][0]["conv1"]["kernel"]
    assert up0.shape[0] == int(32 * scale)
