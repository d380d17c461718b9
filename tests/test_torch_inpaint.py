"""The port's inpaint on a 4-channel UNet (strength 1.0 and 0.75) against
the JAX package on the CPU, its per-sample draws, and the uint8
conversion, bitwise against the JAX package's native codec
(tests/test_torch_img2img.py has the 9-channel and asymmetric-VAE inpaint
and img2img from pixels, with these conventions).

Tiny config, fp32, 64x64, 3 DPM++ 2M steps (a solver without noise), CFG
7.5 and the two-phrase region map. The JAX side draws its noise from its
own keys; the test computes those draws (``_seed_fold_keys`` and
``_keyed_normal``, as the JAX pipeline does) and injects them into the
port's draw function ``seeded_normals``. Tolerance: 1e-4 on fp32 pixels and
latents, as the txt2img and hires slices (tests/test_torch_pipeline.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.pipeline import pipeline as jpipeline
from diffusionspatialcontrol_tpu.pipeline.pipeline import StableDiffusionTPU
from diffusionspatialcontrol_tpu.runtime import native
from diffusionspatialcontrol_tpu.text import tokenizer as jtok
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.models import factory as tfactory
from diffusionspatialcontrol_tpu_torch.models import vae as tvae
from diffusionspatialcontrol_tpu_torch.pipeline import pipeline as tpipeline
from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
    StableDiffusionTorch,
    seeded_normals,
    to_uint8,
)
from diffusionspatialcontrol_tpu_torch.samplers import brownian
from diffusionspatialcontrol_tpu_torch.text import tokenizer as ttok

from test_torch_vae import to_jax

PROMPT = "a red cat sitting on a wooden bench, a blue bird flying"
NEG = "bad quality, low quality, jpeg artifact, cropped"
STEPS = 3


def _two_masks(h, w):
    m1 = np.zeros((h, w), np.float32)
    m1[:, : w // 2] = 1.0
    m2 = np.zeros((h, w), np.float32)
    m2[: h // 3, w // 2:] = 1.0
    return {"red cat": {"mask": m1, "weight": 0.8, "mask_outsides": 0.2},
            "blue bird": {"mask": m2, "weight": 0.7, "mask_outsides": 0.1}}


def _configs(kind):
    """(JAX config, port config) of the tiny model of ``kind``."""
    out = []
    for mod in (jcfg, tcfg):
        cfg = mod.tiny_config()
        if kind in ("nine", "asym"):
            cfg = dataclasses.replace(
                cfg, unet=dataclasses.replace(cfg.unet, in_channels=9))
        if kind == "asym":
            vae = cfg.vae
            cfg = dataclasses.replace(cfg, vae=dataclasses.replace(
                vae, asymmetric=True,
                decoder_block_out_channels=vae.block_out_channels,
                decoder_layers_per_block=vae.layers_per_block + 1))
        out.append(cfg)
    return out


def make_pipes(kinds):
    """kind -> (JAX pipeline, port pipeline) on the same weights."""
    made = {}
    for kind in kinds:
        jc, tc = _configs(kind)
        tp = tfactory.init_pipeline_params(
            {"four": 0, "nine": 1, "asym": 1}[kind], tc, torch.float32,
            device="cpu")
        made[kind] = (
            StableDiffusionTPU(jc, to_jax(tp), tokenizer=jtok.HashTokenizer(),
                               attn_impl="xla"),
            StableDiffusionTorch(tc, tp, tokenizer=ttok.HashTokenizer(),
                                 device="cpu"))
    return made


@pytest.fixture(scope="module")
def pipes():
    return make_pipes(["four"])


def _inputs(b, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (b, 64, 64, 3)).astype(np.float32)
    mask = np.zeros((b, 64, 64), np.float32)
    mask[:, :, 24:] = 1.0
    mask[:, 5:17, 3:11] = 1.0  # not aligned to the 8-pixel latent grid
    return img, mask


def _jax_draws(seed, b, count):
    """The JAX pipeline's inpaint draws for ``seed``: the posterior's (from
    k_enc), the initial latents' (k_lat) and the blend noise (k_blend)."""
    k_enc, k_lat, _, k_blend = jpipeline._seed_fold_keys(seed, 4)
    shape = (b, 8, 8, 4)
    draws = [jpipeline._keyed_normal(k, shape)
             for k in (k_enc, k_lat, k_blend)[:count]]
    return torch.from_numpy(np.stack([np.asarray(d) for d in draws]))


def _inject(monkeypatch, draws):
    def fake(seeds, shape, count, device):
        assert count == draws.shape[0]
        return draws.to(device)

    monkeypatch.setattr(tpipeline, "seeded_normals", fake)


def _gen(mod, dtype):
    return mod.GenerationConfig(height=64, width=64, num_inference_steps=STEPS,
                                dtype=dtype)


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _run_both(pipes, kind, monkeypatch, b, seed, strength=1.0, **kw):
    jpipe, tpipe = pipes[kind]
    img, mask = _inputs(b)
    count = 2 if kind != "four" else 3
    _inject(monkeypatch, _jax_draws(seed, b, count))
    out = []
    for pipe, mod, dt, arr in (
            (jpipe, jcfg, jnp.float32, jnp.asarray),
            (tpipe, tcfg, torch.float32, torch.from_numpy)):
        ctx, ids = pipe.encode_prompt([PROMPT] * b, [NEG] * b)
        rb = pipe.encode_region([_two_masks(64, 64)] * b, ids, 64, 64)
        out.append(pipe.inpaint(ctx, arr(img), arr(mask), _gen(mod, dt),
                                strength=strength, seed=seed,
                                region_biases=rb, **kw))
    return out


@pytest.mark.parametrize("strength,seed", [(1.0, 3), (0.75, [3, 8])],
                         ids=["strength1-history", "strength0.75-seedlist"])
def test_inpaint_four_channel_matches_jax(pipes, monkeypatch, strength,
                                          seed):
    """The blend of the known region at every denoiser call; strength 1.0
    starts from noise (the images, and the per-step history of the
    unblended latents), 0.75 from the init image's latents (the final
    latents, for two seeds)."""
    b = 1 if isinstance(seed, int) else len(seed)
    hist = strength == 1.0
    want, got = _run_both(pipes, "four", monkeypatch, b, seed, strength,
                          return_history=hist, decode=hist)
    if hist:
        (want, jh), (got, th) = want, got
        assert th.shape == (STEPS, 1, 8, 8, 4)
        _close(th, jh)
    assert got.shape == ((b, 64, 64, 3) if hist else (b, 8, 8, 4))
    _close(got, want)


def test_inpaint_draws_are_per_sample(pipes):
    """A seed list gives each sample the draws its seed gives alone, bit for
    bit (so its result does not depend on the batch), a 9-channel
    request's draws are the first two of a 4-channel one's, and the
    solver noise follows them in the same stream."""
    _, tpipe = pipes["four"]
    cpu = torch.device("cpu")
    both = seeded_normals([3, 8], (8, 8, 4), 3, cpu)
    for i, s in enumerate((3, 8)):
        one = seeded_normals([s], (8, 8, 4), 3, cpu)
        assert torch.equal(both[:, i:i + 1], one)
        assert torch.equal(one[:2], seeded_normals([s], (8, 8, 4), 2, cpu))
        g = torch.Generator().manual_seed(s)
        for k in range(3):
            assert torch.equal(torch.randn((8, 8, 4), generator=g), one[k, 0])
        noise = brownian.step_noise([s], 2, 1, (8, 8, 4), cpu, skip=3)
        assert torch.equal(noise[0, 0, 0], torch.randn((8, 8, 4),
                                                       generator=g))
    img, mask = _inputs(2)
    ctx, _ = tpipe.encode_prompt([PROMPT] * 2, [NEG] * 2)
    gen = _gen(tcfg, torch.float32)
    with pytest.raises(ValueError):
        tpipe.inpaint(ctx, img, mask, gen, seed=[1, 2, 3])
    with pytest.raises(ValueError):
        tpipe.inpaint(ctx, img, mask[:, None], gen)


# The two inputs that showed ties rounding the other way
PROBES = np.array([-0.49411765, -0.99607843], np.float32)


def _boundary_inputs():
    """Every fp32 value within 64 ulp of the 255 boundaries between the
    uint8 buckets, x = ((k + 0.5) / 255) 2 - 1."""
    b = (((np.arange(255) + 0.5) / 255.0) * 2.0 - 1.0).astype(np.float32)
    up, down, cols = b, b, [b]
    for _ in range(64):
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(-np.inf))
        cols += [up, down]
    return np.concatenate(cols)


def test_to_uint8_equals_the_native_codec_bitwise():
    """``to_uint8`` rounds as ``runtime/native.tensor_to_u8`` does (v + 0.5
    in fp32, truncated: ties up), not as ``torch.round`` (ties to even),
    which gives another byte for 708 of the 32,895 inputs near the
    boundaries, and for both probes."""
    near = _boundary_inputs()
    assert np.unique(near).size == near.size == 32895
    x = np.concatenate([PROBES, near, np.float32([-1.5, -1.0, 1.0, 2.0])])
    want = native.tensor_to_u8(x)
    got = to_uint8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:2].tolist() == [65, 1]
    even = torch.round(torch.clamp(torch.from_numpy(x) * 0.5 + 0.5, 0, 1)
                       * 255).to(torch.uint8).numpy()
    assert even[:2].tolist() == [64, 0]
    assert int((even[2:-4] != want[2:-4]).sum()) == 708


def test_vae_params_of_the_presets_build():
    """The port builds the asymmetric presets' full decoder depth (three
    resnets a block), which the JAX package's init cannot (40 keys)."""
    cfg = tcfg.sd15_asym_inpaint_config(1.5).vae
    small = dataclasses.replace(
        cfg, block_out_channels=(8, 16, 16, 16),
        decoder_block_out_channels=(12, 24, 24, 24), norm_num_groups=4)
    p = tvae.vae_init(torch.Generator().manual_seed(0), small, torch.float32,
                      "cpu")
    assert len(p["decoder"]["up_blocks"][0]["resnets"]) == 4
    assert len(p["decoder"]["condition_encoder"]["layers"]) == 5
