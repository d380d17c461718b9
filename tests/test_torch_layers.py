"""PyTorch port vs the JAX package: layers, CLIP and VAE decode, on the same
numpy inputs and the same (converted) weights.

Tolerances: both sides compute in fp32 on the CPU with different kernels
(XLA:CPU vs ATen), so elementwise ops agree to a few ULP and reductions /
convolutions to ~1e-5 relative. Each assert states its own bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.models import clip as jclip
from diffusionspatialcontrol_tpu.models import layers as jl
from diffusionspatialcontrol_tpu.models import vae as jvae
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.convert.from_jax import params_from_jax
from diffusionspatialcontrol_tpu_torch.models import clip as tclip
from diffusionspatialcontrol_tpu_torch.models import layers as tl
from diffusionspatialcontrol_tpu_torch.models import vae as tvae
from tests.test_torch_controlnet import to_jax

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny_params():
    """CLIP and VAE parameters from the port's init (the JAX init's trees
    and bounds: tests/test_torch_pipeline.py), in fp32, moved to the JAX
    package's layouts and converted back for the port. The JAX package's
    own inits compile each of their random ops (~15 s of a worker)."""
    cfg = tcfg.tiny_config()
    g = torch.Generator().manual_seed(0)
    jp = to_jax({"clip": tclip.clip_init(g, cfg.clip, torch.float32, "cpu"),
                 "vae": tvae.vae_init(g, cfg.vae, torch.float32, "cpu")})
    return jp, params_from_jax(_np_tree(jp), device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


# the JAX references jitted: one compile a program, not one an op (a
# quarter of the eager compile time)
_jax_clip = jax.jit(jclip.clip_apply, static_argnums=(1,),
                    static_argnames=("clip_skip",))
_jax_decode = jax.jit(jvae.vae_decode, static_argnums=(1,))


def test_linear_matches_jax():
    rng = np.random.default_rng(0)
    p = jl.linear_init(jax.random.PRNGKey(1), 24, 40, dtype=jnp.float32)
    p["bias"] = jnp.asarray(rng.standard_normal(40), jnp.float32)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    want = np.asarray(jl.linear(p, jnp.asarray(x)))
    got = tl.linear(params_from_jax(_np_tree(p), device="cpu"), _t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k,stride,padding,size", [
    (3, 1, "SAME", 16), (3, 2, "SAME", 16), (1, 1, "VALID", 9),
    (3, 2, "SAME", 9)])
def test_conv2d_matches_jax(k, stride, padding, size):
    """Includes XLA's asymmetric SAME padding of the stride-2 downsample."""
    rng = np.random.default_rng(k * 10 + stride)
    p = jl.conv_init(jax.random.PRNGKey(2), 6, 10, k, dtype=jnp.float32)
    p["bias"] = jnp.asarray(rng.standard_normal(10), jnp.float32)
    x = rng.standard_normal((2, size, size, 6)).astype(np.float32)
    want = np.asarray(jl.conv2d(p, jnp.asarray(x), stride=stride,
                                padding=padding))
    got = tl.conv2d(params_from_jax(_np_tree(p), device="cpu"), _t(x),
                    stride=stride, padding=padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 32), 8),
                                          ((2, 50, 16), 4)])
def test_group_norm_matches_jax(shape, groups):
    rng = np.random.default_rng(3)
    c = shape[-1]
    p = {"scale": rng.standard_normal(c).astype(np.float32),
         "bias": rng.standard_normal(c).astype(np.float32)}
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    want = np.asarray(jl.group_norm(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), groups, 1e-6))
    got = tl.group_norm({k: _t(v) for k, v in p.items()}, _t(x), groups,
                        1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_layer_norm_and_activations_match_jax():
    rng = np.random.default_rng(4)
    p = {"scale": rng.standard_normal(48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    x = (rng.standard_normal((3, 7, 48)) * 2).astype(np.float32)
    want = np.asarray(jl.layer_norm(jax.tree_util.tree_map(jnp.asarray, p),
                                    jnp.asarray(x)))
    got = tl.layer_norm({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for name in ("silu", "quick_gelu", "gelu"):
        want = np.asarray(jl.ACTIVATIONS[name](jnp.asarray(x)))
        got = tl.ACTIVATIONS[name](_t(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0.0, 1.5, 480.25, 999.0], np.float32)
    want = np.asarray(jl.timestep_embedding(jnp.asarray(t), dim))
    got = tl.timestep_embedding(_t(t), dim).numpy()
    # sin/cos of arguments up to ~1e3 rad: fp32 range reduction differs by
    # a few ULP of the argument between the two libraries
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_clip_apply_matches_jax(tiny_params):
    jp, tp = tiny_params
    cfg = jcfg.tiny_config().clip
    ids = np.random.default_rng(5).integers(0, 49408, (2, 77))
    for clip_skip in (1, 2):
        want = np.asarray(_jax_clip(jp["clip"], cfg, jnp.asarray(ids),
                                    clip_skip=clip_skip))
        got = tclip.clip_apply(tp["clip"], tcfg.tiny_config().clip,
                               torch.from_numpy(ids), clip_skip=clip_skip)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_vae_decode_matches_jax(tiny_params):
    jp, tp = tiny_params
    lat = np.random.default_rng(6).standard_normal((1, 8, 8, 4)).astype(
        np.float32)
    want = np.asarray(_jax_decode(jp["vae"], jcfg.tiny_config().vae,
                                  jnp.asarray(lat)))
    got = tvae.vae_decode(tp["vae"], tcfg.tiny_config().vae,
                          torch.from_numpy(lat))
    assert got.shape == (1, 64, 64, 3) and got.dtype == torch.float32
    # ~20 fp32 convs and norms deep: 1e-4 relative to the output's range
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
