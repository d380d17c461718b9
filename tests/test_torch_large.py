"""The port at the shapes of the JAX package's large requests, against the
JAX package on the CPU at tiny size: txt2img with a two-phrase map at
192x128 and 128x192 (H x W; 24x16 and 16x24 latents, whose deepest UNet
level has an odd side, 3, as 1088x1920's 136x240 latents have, 17; the two
orientations catch an H/W swap), a mapped txt2img at batch 4 with a seed
list (the region std taken over the whole batch in both packages),
``encode_region_state`` at 1088x1920 at all four levels, and the VAE decode
at a non-square size; and the rule by which ``chip_smoke.py`` counts K3's
launches, against the JAX package's own choice of its streaming kernel.

Tiny config, fp32, the port's init moved to the JAX layouts
(``test_torch_controlnet.to_jax``), a random context (no CLIP run) and the
same initial latents on both sides (DPM++ 2M draws no other noise). The
JAX references run eagerly with the UNet jitted at XLA optimization level
0 (``test_torch_speed_modes.jax_eager``), the decode jitted at that level.

Tolerances: rtol/atol 1e-4 on pixels in [-1, 1] and 1 step on uint8 (as
tests/test_torch_pipeline.py holds txt2img); atol 1e-6 on the region
biases (its ``encode_region_state`` test); rtol 1e-5 and atol 1e-5 of the
max abs on the decode alone (tests/test_torch_vae.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.models import vae as jvae
from diffusionspatialcontrol_tpu.ops.pallas import flash_attention as jfa
from diffusionspatialcontrol_tpu.ops import region_map as jregion
from diffusionspatialcontrol_tpu.pipeline import pipeline as jpipeline
from diffusionspatialcontrol_tpu.text import tokenizer as jtok
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.models import factory as tfactory
from diffusionspatialcontrol_tpu_torch.models import vae as tvae
from diffusionspatialcontrol_tpu_torch.ops import region_map as tregion
from diffusionspatialcontrol_tpu_torch.pipeline import pipeline as tpipeline
from diffusionspatialcontrol_tpu_torch.text import tokenizer as ttok
from tests.test_torch_controlnet import to_jax
from tests.test_torch_speed_modes import PROMPT, jax_eager

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

STEPS = 4
JTINY, TTINY = jcfg.tiny_config(), tcfg.tiny_config()


def two_masks(h, w):
    """The main path's two-phrase map at H x W (chip_smoke._masks)."""
    m1 = np.zeros((h, w), np.float32)
    m1[:, : w // 2] = 1.0
    m2 = np.zeros((h, w), np.float32)
    m2[: h // 3, w // 2:] = 1.0
    return {"red cat": {"mask": m1, "weight": 0.8, "mask_outsides": 0.2},
            "blue bird": {"mask": m2, "weight": 0.7, "mask_outsides": 0.1}}


@pytest.fixture(scope="module")
def pipes():
    """Both pipelines on the same tiny weights and the prompt's ids."""
    tp = tfactory.init_pipeline_params(0, TTINY, torch.float32, device="cpu")
    jpipe = jpipeline.StableDiffusionTPU(JTINY, to_jax(tp),
                                         tokenizer=jtok.HashTokenizer(),
                                         attn_impl="xla")
    tpipe = tpipeline.StableDiffusionTorch(
        TTINY, tp, tokenizer=ttok.HashTokenizer(), device="cpu")
    tok = ttok.HashTokenizer()
    ids = [(tok.encode(PROMPT) + [tok.pad_token_id] * 77)[:77]]
    return jpipe, tpipe, ids


_FAST_COMPILE = {"xla_backend_optimization_level": 0}
_jax_decode = jax.jit(jvae.vae_decode, static_argnums=(1,),
                      static_argnames=("conv_impl",),
                      compiler_options=_FAST_COMPILE)


def _both(pipes, h, w, ctx, states, ids, lat, seed):
    """txt2img of both packages on the same context, maps and latents;
    (JAX's images, the port's images)."""
    jpipe, tpipe, _ = pipes
    kw = dict(height=h, width=w, num_inference_steps=STEPS)
    with jax_eager() as mp:
        mp.setattr(jpipeline, "vae_decode", _jax_decode)
        want = np.asarray(jpipe.txt2img(
            jnp.asarray(ctx), jcfg.GenerationConfig(dtype=jnp.float32, **kw),
            seed=seed, latents=jnp.asarray(lat),
            region_biases=jpipe.encode_region(states, ids, h, w)))
    got = tpipe.txt2img(
        torch.from_numpy(ctx), tcfg.GenerationConfig(dtype=torch.float32,
                                                     **kw),
        seed=seed, latents=torch.from_numpy(lat),
        region_biases=tpipe.encode_region(states, ids, h, w))
    return want, got


def _assert_images_close(got, want):
    assert tuple(got.shape) == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    want_u8 = np.round(np.clip(want * 0.5 + 0.5, 0, 1) * 255).astype(int)
    got_u8 = tpipeline.to_uint8(got).numpy().astype(int)
    assert np.abs(got_u8 - want_u8).max() <= 1


@pytest.mark.parametrize("h, w", [(192, 128), (128, 192)],
                         ids=["192x128", "128x192"])
def test_txt2img_non_square_matches_jax(pipes, h, w):
    """4 DPM++ 2M Karras steps with CFG and the map, then the decode."""
    _, _, ids = pipes
    rng = np.random.default_rng(h)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    lat = rng.standard_normal((1, h // 8, w // 8, 4)).astype(np.float32)
    want, got = _both(pipes, h, w, ctx, [two_masks(h, w)], ids, lat, 3)
    assert want.shape == (1, h, w, 3)
    _assert_images_close(got, want)


def test_txt2img_batch4_mapped_matches_jax(pipes):
    """Four samples with a seed list, their maps alternately mirrored
    left to right, at 64^2: the region std spans all eight CFG rows in
    both packages, so a sample depends on its batch (ROADMAP.md section
    3); the port must still agree with the JAX package on the batch."""
    _, _, ids = pipes
    rng = np.random.default_rng(44)
    ctx = rng.standard_normal((8, 77, 64)).astype(np.float32)
    lat = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    state = two_masks(64, 64)
    mirrored = {k: {**v, "mask": v["mask"][:, ::-1].copy()}
                for k, v in state.items()}
    want, got = _both(pipes, 64, 64, ctx, [state, mirrored] * 2, ids * 4,
                      lat, [5, 6, 7, 8])
    assert want.shape == (4, 64, 64, 3)
    _assert_images_close(got, want)
    assert float((got[0] - got[1]).abs().max()) > 1e-3


def test_encode_region_state_1088x1920_matches_jax():
    """``large_spatial``'s map (one phrase on the left half) and the
    two-phrase map at 1088x1920: levels 136x240, 68x120, 34x60 and 17x30
    (ceil division)."""
    tok = jtok.HashTokenizer()
    ids = [(tok.encode(PROMPT) + [tok.pad_token_id] * 77)[:77]]

    def phrase(p):
        return tok.encode(p, add_special_tokens=False)

    h, w = 1088, 1920
    one = {"red cat": dict(two_masks(h, w)["red cat"])}
    for state in (one, two_masks(h, w)):
        want = jregion.encode_region_state([state], ids, phrase, height=h,
                                           width=w)
        got = tregion.encode_region_state([state], ids, phrase, height=h,
                                          width=w)
        assert len(got) == 4
        for r, a, b in zip(tregion.LEVEL_RATIOS, want, got):
            assert b.shape == (2, -(-h // r) * -(-w // r), 77), r
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-6, err_msg=f"ratio {r}")
        assert float(got[-1].abs().max()) > 0


def test_vae_decode_non_square_matches_jax():
    """12x20 latents to a 96x160 image: the mid block's attention over
    240 positions and the nearest 2x upsamples of a non-square map."""
    tp = tvae.vae_init(torch.Generator().manual_seed(2), TTINY.vae,
                       torch.float32, "cpu")
    z = (np.random.default_rng(6).standard_normal((1, 12, 20, 4))
         * 0.5).astype(np.float32)
    want = np.asarray(_jax_decode(to_jax(tp), JTINY.vae,
                                  jnp.asarray(z)))
    got = tvae.vae_decode(tp, TTINY.vae, torch.from_numpy(z))
    assert got.shape == want.shape == (1, 96, 160, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("s_len, d", [
    (12160, 40), (12161, 40), (16384, 40), (32640, 40), (9216, 40),
    (8160, 80), (7936, 160), (7937, 160), (2040, 160)])
def test_k3_count_rule_is_the_jax_packages(monkeypatch, s_len, d):
    """``chip_smoke.jax_streams`` (K2's launches counted as K3) says what
    the JAX package's ``flash_attention`` does at S keys and head dim D:
    traced abstractly, with its streaming body replaced by a recorder."""
    streamed = []

    def record(q, *args, **kwargs):
        streamed.append(True)
        return q

    monkeypatch.setattr(jfa, "_flash_streaming", record)
    q = jax.ShapeDtypeStruct((1, 1, 128, d), jnp.bfloat16)
    kv = jax.ShapeDtypeStruct((1, 1, s_len, d), jnp.bfloat16)
    jax.eval_shape(jfa.flash_attention, q, kv, kv)
    assert bool(streamed) == chip_smoke.jax_streams(s_len, d)
