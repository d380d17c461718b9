"""The port's CLIP vision tower (``models/clip_vision.py``) against the JAX
package's, on the CPU, fp32, at a tiny config.

Parameters come from the JAX package's ``clip_vision_init`` through
``convert/from_jax.params_from_jax``; the same numpy pixels go through
both. Both outputs (the projected embeds and the penultimate hidden
states): rtol/atol 1e-5 on values of magnitude ~1 (the port's attention is
K2's plain version, the JAX package's XLA's). ``preprocess_image`` (the
cubic resize with antialiasing, CLIP normalization) from uint8 and float
images, shrinking and enlarging: atol 1e-5 on normalized pixels of
magnitude ~2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu.models import clip_vision as jcv
from diffusionspatialcontrol_tpu_torch.convert.from_jax import params_from_jax
from diffusionspatialcontrol_tpu_torch.models import clip_vision as tcv
from tests.test_torch_controlnet import to_jax

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

# D = 16 a head: a head dim K2 has an instance for
TINY = dict(image_size=28, patch_size=14, hidden_size=32,
            intermediate_size=64, num_layers=2, num_heads=2,
            projection_dim=16)


def test_config_defaults_equal_jax():
    assert dataclasses.asdict(tcv.CLIPVisionConfig()) == \
        dataclasses.asdict(jcv.CLIPVisionConfig())
    assert tcv.CLIPVisionConfig().num_patches == 256
    assert (tcv.CLIP_IMAGE_MEAN, tcv.CLIP_IMAGE_STD) == \
        (jcv.CLIP_IMAGE_MEAN, jcv.CLIP_IMAGE_STD)


@pytest.mark.parametrize("hidden", [False, True])
def test_clip_vision_apply_matches_jax(hidden):
    jc, tc = jcv.CLIPVisionConfig(**TINY), tcv.CLIPVisionConfig(**TINY)
    # the port's init (the JAX init's tree: test_port_init_has_the_jax_tree)
    # in the JAX layouts; the JAX init compiles each of its random ops
    jp = to_jax(tcv.clip_vision_init(torch.Generator().manual_seed(0), tc,
                                     torch.float32, "cpu"))
    # the init's norms are ones and zeros: draw them, so they count
    rng = np.random.default_rng(1)
    jp = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    pixels = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    want = np.asarray(jcv.clip_vision_apply(jp, jc, jnp.asarray(pixels),
                                            output_hidden_state=hidden))
    got = tcv.clip_vision_apply(tp, tc, torch.from_numpy(pixels),
                                output_hidden_state=hidden)
    assert got.shape == want.shape == ((2, 5, 32) if hidden else (2, 16))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_port_init_has_the_jax_tree():
    tc = tcv.CLIPVisionConfig(**TINY)
    tp = tcv.clip_vision_init(torch.Generator().manual_seed(0), tc,
                              torch.float32, "cpu")
    shapes = jax.eval_shape(lambda: jcv.clip_vision_init(
        jax.random.PRNGKey(0), jcv.CLIPVisionConfig(**TINY), jnp.float32))
    conv = params_from_jax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), device="cpu")
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, tp)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0,
                                                            conv))
    for a, b in zip(jax.tree_util.tree_leaves(tp),
                    jax.tree_util.tree_leaves(conv)):
        assert a.shape == b.shape and a.dtype == b.dtype
    out = tcv.clip_vision_apply(tp, tc, torch.zeros(1, 28, 28, 3))
    assert out.shape == (1, 16) and torch.isfinite(out).all()


@pytest.mark.parametrize("src", [(96, 80), (20, 24), (28, 28)])
@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_preprocess_image_matches_jax(src, kind):
    """Shrinking antialiases (the cubic kernel widens by the ratio)."""
    rng = np.random.default_rng(sum(src))
    img = rng.integers(0, 256, (1,) + src + (3,)).astype(np.uint8)
    if kind == "float":
        img = img.astype(np.float32) / 255.0
    want = np.asarray(jcv.preprocess_image(img, 28))
    got = tcv.preprocess_image(img, 28)
    assert got.shape == want.shape == (1, 28, 28, 3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
