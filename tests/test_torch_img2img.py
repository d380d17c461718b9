"""The port's images-in paths against the JAX package on the CPU, second
part (tests/test_torch_inpaint.py has the first and the conventions):
``encode_image`` then ``img2img`` as the app runs img2img from pixels,
inpaint on a 9-channel inpaint UNet, and with the asymmetric VAE's
conditioned decode. Tolerance: 1e-4 on fp32 pixels and latents.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.pipeline import pipeline as jpipeline
from diffusionspatialcontrol_tpu.runtime import native
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.models import vae as tvae
from diffusionspatialcontrol_tpu_torch.pipeline import pipeline as tpipeline
from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import to_uint8

from test_torch_inpaint import (
    NEG,
    PROMPT,
    _close,
    _gen,
    _inject,
    _inputs,
    _run_both,
    _two_masks,
    make_pipes,
)


@pytest.fixture(scope="module")
def pipes():
    return make_pipes(["four", "nine", "asym"])


def test_inpaint_nine_channel_matches_jax(pipes, monkeypatch):
    """[mask, masked-image latents] after the c_in scaling, doubled and
    interleaved for CFG; one posterior draw for both of JAX's encodes. The
    final latents (the decode is the 4-channel model's)."""
    want, got = _run_both(pipes, "nine", monkeypatch, 1, 4, decode=False)
    assert got.shape == (1, 8, 8, 4)
    _close(got, want)


def test_inpaint_asymmetric_vae_matches_jax(pipes, monkeypatch):
    """The 9-channel UNet with the asymmetric VAE: latents sampled without
    a decode, then the decode conditioned on the masked init image."""
    want, got = _run_both(pipes, "asym", monkeypatch, 1, 5)
    _close(got, want)
    u8 = to_uint8(got)
    assert torch.equal(u8, torch.from_numpy(native.tensor_to_u8(got.numpy())))


def test_encode_image_then_img2img_matches_jax(pipes, monkeypatch):
    """img2img from pixels as the app runs it: ``encode_image`` with the
    request's seed, then ``img2img`` at strength 0.8 (2 of the 3 steps);
    the encoded and the final latents, and ``decode_latents``."""
    jpipe, tpipe = pipes["four"]
    img, _ = _inputs(1, seed=1)
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(6), (1, 8, 8, 4)))
    noise0 = np.array(jpipeline._keyed_normal(
        jpipeline._seed_fold_keys(6, 2)[0], (1, 8, 8, 4)))
    _inject(monkeypatch, torch.from_numpy(eps[None].copy()))
    monkeypatch.setattr(tpipeline, "initial_noise",
                        lambda seeds, shape, device: torch.from_numpy(noise0))
    out = []
    for pipe, mod, dt, arr in (
            (jpipe, jcfg, jnp.float32, jnp.asarray),
            (tpipe, tcfg, torch.float32, torch.from_numpy)):
        ctx, ids = pipe.encode_prompt([PROMPT], [NEG])
        lat = pipe.encode_image(arr(img), seed=6)
        out.append((lat, pipe.img2img(
            ctx, lat, _gen(mod, dt), strength=0.8, seed=6, decode=False,
            region_biases=pipe.encode_region([_two_masks(64, 64)], ids, 64,
                                             64))))
    (jlat, want), (tlat, got) = out
    _close(tlat, jlat)
    assert got.shape == (1, 8, 8, 4)
    _close(got, want)
    assert torch.equal(tpipe.decode_latents(got), tvae.vae_decode(
        tpipe.params["vae"], tcfg.tiny_config().vae, got))
