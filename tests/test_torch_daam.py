"""The port's DAAM heatmaps (``introspect/daam.py``) against the JAX
package's, on the CPU: ``heatmaps_for_state`` and
``heatmaps_for_trajectory`` (with a region map; normalized and not),
``token_heatmap``, ``attention_mass_in_mask`` and ``region_compliance``,
and the UNet's heatmap taps they read (one cross-attention at a time);
and tests/test_introspect.py's cases on the port: the latent history, the
heatmaps' shape and range, and compliance rising with the region weight.

Tiny config, fp32, the port's init moved to the JAX layouts, the same
latents, context and map on both sides; the JAX package's UNet runs jitted
(``tests.test_torch_speed_modes.JAX_UNET``).
Tolerances: heatmaps, sums over 16 cross-attentions of probabilities
summed over 2 heads and resized to the latent grid (rows summing to 32),
atol 1e-4 for one state and 3e-4 summed over three; normalized ones 1e-5;
one cross-attention's probabilities (summed over 2 heads) and attention
shares 1e-5; the UNet's output rtol/atol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.introspect import daam as jdaam
from diffusionspatialcontrol_tpu.models import unet as junet
from diffusionspatialcontrol_tpu.pipeline import pipeline as jpipeline
from diffusionspatialcontrol_tpu.text import tokenizer as jtok
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.introspect import daam as tdaam
from diffusionspatialcontrol_tpu_torch.models import factory as tfactory
from diffusionspatialcontrol_tpu_torch.models import unet as tunet
from diffusionspatialcontrol_tpu_torch.pipeline import pipeline as tpipeline
from diffusionspatialcontrol_tpu_torch.text import tokenizer as ttok
from tests.test_torch_controlnet import to_jax
from tests.test_torch_speed_modes import JAX_UNET

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

JTINY, TTINY = jcfg.tiny_config(), tcfg.tiny_config()
PROMPT = "a red cat on a bench"


@pytest.fixture(scope="module")
def pipes():
    tp = tfactory.init_pipeline_params(0, TTINY, torch.float32, device="cpu")
    jpipe = jpipeline.StableDiffusionTPU(JTINY, to_jax(tp),
                                         tokenizer=jtok.HashTokenizer(),
                                         attn_impl="xla")
    tpipe = tpipeline.StableDiffusionTorch(
        TTINY, tp, tokenizer=ttok.HashTokenizer(), device="cpu")
    return jpipe, tpipe


def _gens(steps=4):
    kw = dict(height=64, width=64, num_inference_steps=steps)
    return (jcfg.GenerationConfig(dtype=jnp.float32, **kw),
            tcfg.GenerationConfig(dtype=torch.float32, **kw))


def _mask(weight):
    m = np.zeros((64, 64), np.float32)
    m[:, :24] = 1.0
    return {"red cat": {"mask": m, "weight": weight, "mask_outsides": 0.0}}


def _inputs(seed=0):
    """A trajectory (4, 1, 8, 8, 4) at sigma-space scale, a cond context
    and the map's cond half at 64^2, as numpy."""
    rng = np.random.default_rng(seed)
    hist = (rng.standard_normal((4, 1, 8, 8, 4)) * 3.0).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 64)).astype(np.float32)
    tok = ttok.HashTokenizer()
    ids = [(tok.encode(PROMPT) + [tok.pad_token_id] * 77)[:77]]
    return hist, ctx, ids


def _biases(pipe, ids, conv):
    full = pipe.encode_region([_mask(0.9)], ids, 64, 64)
    return tuple(conv(np.asarray(b)[1:]) for b in full)  # the cond half


@pytest.mark.parametrize("normalize", [False, True])
def test_heatmaps_match_jax(pipes, monkeypatch, normalize):
    """``heatmaps_for_state`` at one step and ``heatmaps_for_trajectory``
    over three, with the map."""
    jpipe, tpipe = pipes
    monkeypatch.setattr(jdaam, "unet_apply", JAX_UNET)
    hist, ctx, ids = _inputs()
    sigmas, _ = tpipe._schedule(_gens()[1])
    jb = _biases(jpipe, ids, jnp.asarray)
    tb = _biases(tpipe, ids, torch.from_numpy)
    if not normalize:
        want = jdaam.heatmaps_for_state(jpipe.params, JTINY,
                                        jnp.asarray(hist[1]),
                                        float(sigmas[2]), jnp.asarray(ctx),
                                        jb)
        got = tdaam.heatmaps_for_state(tpipe.params, TTINY,
                                       torch.from_numpy(hist[1]),
                                       float(sigmas[2]),
                                       torch.from_numpy(ctx), tb)
        assert got.shape == (1, 8, 8, 77) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)
        # 16 cross-attentions, each row summing to the 2 heads
        torch.testing.assert_close(got.sum(-1), torch.full((1, 8, 8), 32.0))
    want = jdaam.heatmaps_for_trajectory(
        jpipe.params, JTINY, jnp.asarray(hist), sigmas, jnp.asarray(ctx), jb,
        normalize=normalize)
    got = tdaam.heatmaps_for_trajectory(
        tpipe.params, TTINY, torch.from_numpy(hist), sigmas,
        torch.from_numpy(ctx), tb, normalize=normalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 if normalize else 3e-4)
    with pytest.raises(ValueError, match="empty"):
        tdaam.heatmaps_for_trajectory(tpipe.params, TTINY,
                                      torch.from_numpy(hist[:1]), sigmas,
                                      torch.from_numpy(ctx))



def test_unet_heatmap_taps_match_jax(pipes):
    """``unet_apply(collect_heatmaps=True)`` at one state: each
    cross-attention's (level, probabilities summed over its 2 heads)
    against the JAX UNet's, in ``heatmaps_for_state``'s call (the same
    compiled program)."""
    jpipe, tpipe = pipes
    hist, ctx, ids = _inputs()
    x = (hist[1] * 0.3).astype(np.float32)
    jcond = junet.UNetCond(context=jnp.asarray(ctx), region=junet.RegionState(
        _biases(jpipe, ids, jnp.asarray), jnp.float32(2.0)))
    tcond = tunet.UNetCond(context=torch.from_numpy(ctx),
                           region=tunet.RegionState(
                               _biases(tpipe, ids, torch.from_numpy),
                               torch.tensor(2.0)))
    t = np.full((1,), 310.5, np.float32)
    want, jmaps = JAX_UNET(jpipe.params["unet"], JTINY.unet, jnp.asarray(x),
                           jnp.asarray(t), jcond, collect_heatmaps=True)
    out, maps = tunet.unet_apply(tpipe.params["unet"], TTINY.unet,
                                 torch.from_numpy(x), torch.from_numpy(t),
                                 tcond, collect_heatmaps=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert [lv for lv, _ in maps] == [lv for lv, _ in jmaps]
    for (level, m), (_, jm) in zip(maps, jmaps):
        assert tuple(m.shape) == jm.shape == (1, (8 >> level) ** 2, 77)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=0,
                                   atol=1e-5)

def test_token_heatmap_and_mass_in_mask_match_jax():
    rng = np.random.default_rng(1)
    maps = rng.random((2, 8, 8, 77)).astype(np.float32)
    mask = (rng.random((8, 8)) > 0.5).astype(np.float32)
    for pos in ([1, 2], [5], [3, 7, 9]):
        np.testing.assert_allclose(
            tdaam.token_heatmap(torch.from_numpy(maps), pos).numpy(),
            np.asarray(jdaam.token_heatmap(jnp.asarray(maps), pos)),
            rtol=1e-6)
        np.testing.assert_allclose(
            tdaam.attention_mass_in_mask(torch.from_numpy(maps), pos,
                                         mask).numpy(),
            np.asarray(jdaam.attention_mass_in_mask(jnp.asarray(maps), pos,
                                                    jnp.asarray(mask))),
            rtol=0, atol=1e-5)


class _Fixed:
    """A pipeline whose prompt encoding returns a given context and ids,
    and whose txt2img returns a given trajectory: the same inputs for both
    packages' ``region_compliance`` (tests/test_torch_pipeline.py holds
    the sampling itself to the JAX package's)."""

    def __init__(self, pipe, ctx, ids, trajectory):
        self._pipe, self._ctx, self._ids = pipe, ctx, ids
        self._trajectory = trajectory

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def encode_prompt(self, prompts, negatives, **_):
        return self._ctx, self._ids

    def txt2img(self, *args, **kwargs):
        assert kwargs["return_history"] and not kwargs["decode"]
        return self._trajectory


def test_region_compliance_matches_jax(pipes, monkeypatch):
    """The port's trajectory of a mapped txt2img replayed on the cond half
    by both packages, the mask resized (antialiased, 64 -> 8) and
    thresholded at 0.5, the phrase found by its token ids."""
    jpipe, tpipe = pipes
    monkeypatch.setattr(jdaam, "unet_apply", JAX_UNET)
    rng = np.random.default_rng(2)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    _, _, ids = _inputs()
    jgen, tgen = _gens()
    final, hist = tpipe.txt2img(
        torch.from_numpy(ctx), tgen, seed=3, decode=False,
        return_history=True,
        region_biases=tpipe.encode_region([_mask(0.9)], ids, 64, 64))
    want = jdaam.region_compliance(
        _Fixed(jpipe, jnp.asarray(ctx), ids,
               (jnp.asarray(final.numpy()), jnp.asarray(hist.numpy()))),
        jgen, PROMPT, "", _mask(0.9), seed=3)
    got = tdaam.region_compliance(
        _Fixed(tpipe, torch.from_numpy(ctx), ids, (final, hist)), tgen,
        PROMPT, "", _mask(0.9), seed=3)
    assert set(got) == set(want) == {"red cat"}
    assert abs(got["red cat"] - want["red cat"]) < 1e-5, (got, want)
    nan = tdaam.region_compliance(
        _Fixed(tpipe, torch.from_numpy(ctx), ids, (final, hist)), tgen,
        PROMPT, "", {"green dog": _mask(0.5)["red cat"]}, seed=3)
    assert np.isnan(nan["green dog"])


def test_latent_history(pipes):
    """The last history entry is the final latents; the history decodes to
    previews (tests/test_introspect.py)."""
    _, tpipe = pipes
    _, gen = _gens()
    ctx, _ = tpipe.encode_prompt(["a cat"], [""])
    final, hist = tpipe.txt2img(ctx, gen, seed=0, decode=False,
                                return_history=True)
    assert hist.shape == (4, 1, 8, 8, 4)
    assert torch.equal(hist[-1], final)
    assert tpipe.decode_latents(hist[:, 0]).shape == (4, 64, 64, 3)


def test_daam_heatmaps(pipes):
    _, tpipe = pipes
    _, gen = _gens()
    ctx, _ = tpipe.encode_prompt([PROMPT], [""])
    _, hist = tpipe.txt2img(ctx, gen, seed=1, decode=False,
                            return_history=True)
    sigmas, _ = tpipe._schedule(gen)
    maps = tdaam.heatmaps_for_trajectory(tpipe.params, TTINY, hist, sigmas,
                                         ctx[1:])
    assert maps.shape == (1, 8, 8, 77) and torch.isfinite(maps).all()
    assert float(maps.max()) <= 1.0 + 1e-6
    assert tdaam.token_heatmap(maps, [1, 2]).shape == (1, 8, 8)


def test_region_compliance_monotonic_in_weight(pipes):
    """The share of the phrase's attention inside its mask rises with the
    region weight, on random weights too (tests/test_introspect.py)."""
    _, tpipe = pipes
    _, gen = _gens(6)
    fracs = [tdaam.region_compliance(tpipe, gen, PROMPT, "", _mask(w),
                                     seed=3)["red cat"]
             for w in (0.0, 0.45, 0.9)]
    assert all(np.isfinite(fracs))
    assert fracs[0] < fracs[1] < fracs[2], fracs
    assert 0.05 < fracs[0] < 0.8
