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
    _inputs,
    _run_both,
    _two_masks,
    make_pipes,
)

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)


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
    eps = np.array(jax.random.normal(jax.random.PRNGKey(6), (1, 8, 8, 4)))
    noise0 = np.array(jpipeline._keyed_normal(
        jpipeline._seed_fold_keys(6, 2)[0], (1, 8, 8, 4)))
    monkeypatch.setattr(tpipeline, "posterior_noise",
                        lambda seeds, shape, device: torch.from_numpy(eps))
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


class _Stop(Exception):
    pass


def test_encode_image_and_img2img_of_one_seed_share_no_draw(pipes,
                                                            monkeypatch):
    """``encode_image`` draws its posterior from another stream of the seed
    than the one ``img2img`` takes its initial noise from (the JAX package:
    ``PRNGKey(seed)`` and the first of its split), so img2img from the
    latents of one seed does not add the same draw twice: on a 512^2 image
    (64x64x4 latents) the two draws of seeds 0 and 6 correlate by less than
    0.05. ``encode_image`` stays deterministic per seed, and its draws
    differ between seeds."""
    _, tpipe = pipes["four"]
    ctx, _ = tpipe.encode_prompt([PROMPT], [NEG])
    img = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (1, 512, 512, 3)).astype(np.float32))
    eps, noise = [], []
    monkeypatch.setattr(tpipe, "_encode",
                        lambda images, e: eps.append(e) or e)

    def initial(seeds, shape, device):
        noise.append(tpipeline.seeded_normals(seeds, shape, 1, device)[0])
        raise _Stop

    monkeypatch.setattr(tpipeline, "initial_noise", initial)
    for seed in (0, 6, 6):
        lat = tpipe.encode_image(img, seed=seed)
        with pytest.raises(_Stop):
            tpipe.img2img(ctx, lat, _gen(tcfg, torch.float32), seed=seed)
    assert eps[0].shape == noise[0].shape == (1, 64, 64, 4)
    for e, n in zip(eps, noise):
        r = np.corrcoef(e.flatten().numpy(), n.flatten().numpy())[0, 1]
        assert abs(r) < 0.05, r
    assert torch.equal(eps[1], eps[2])
    assert not torch.equal(eps[0], eps[1])
