"""IP-Adapter through the port (``models/ip_adapter.py``, the UNet's
decoupled attention, the denoiser and the pipeline) against the JAX
package, on the CPU, fp32, tiny config.

Adapters come from ``random_state_dict`` (numpy, the same weights in both
packages); the UNet from the port's init moved to the JAX layout; the
same numpy embeds, tokens, masks, latents and context on both sides.

* every projection variant: rtol/atol 1e-5;
* ``detect_variant``, ``cross_attn_paths`` and the hidden dims equal JAX's;
  install, uninstall and ``copy_tree_containers`` leave the source tree
  untouched;
* ``_downsample_mask`` on square, non-square, padded and
  round-half-to-even cases: atol 1e-6;
* ``unet_apply`` with two adapters (one masked, scales 0.5 and 1.0) and a
  map, against the jitted JAX UNet: rtol/atol 1e-4 (the bound of
  tests/test_torch_units.py);
* ``build_ip_extras`` with and without CFG, and the denoiser against JAX's
  called eagerly with its UNet jitted (the program of the UNet test): 1e-5
  of max abs;
* the slice end to end: tiny txt2img with two IP units and the map, 3
  DPM++ 2M steps, latents passed, against ``StableDiffusionTPU`` (the one
  JAX sampling program of this file): final latents within 1e-5 of max
  abs;
* the port's other sampling methods take the same extras: ``sample_chunked``
  is ``txt2img`` bit for bit, hires reuses the tokens, img2img and inpaint
  are moved by them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.models import ip_adapter as jipa
from diffusionspatialcontrol_tpu.models import unet as junet
from diffusionspatialcontrol_tpu.pipeline import pipeline as jpipeline
from diffusionspatialcontrol_tpu.pipeline.pipeline import StableDiffusionTPU
from diffusionspatialcontrol_tpu.samplers import schedules as jsched
from diffusionspatialcontrol_tpu.text import tokenizer as jtok
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.models import factory as tfactory
from diffusionspatialcontrol_tpu_torch.models import ip_adapter as tipa
from diffusionspatialcontrol_tpu_torch.models import unet as tunet
from diffusionspatialcontrol_tpu_torch.pipeline import pipeline as tpipeline
from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
    StableDiffusionTorch,
)
from diffusionspatialcontrol_tpu_torch.text import tokenizer as ttok
from tests.test_torch_controlnet import to_jax

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

PROMPT = "a red cat sitting on a wooden bench, a blue bird flying"
NEG = "bad quality, low quality, jpeg artifact, cropped"
JTINY, TTINY = jcfg.tiny_config(), tcfg.tiny_config()
EMBED = 32  # the image embeds' width (a tiny image tower's)
SCALES = (0.5, 1.0)


def _masks(h, w):
    m1 = np.zeros((h, w), np.float32)
    m1[:, : w // 2] = 1.0
    m2 = np.zeros((h, w), np.float32)
    m2[: h // 3, w // 2:] = 1.0
    return {"red cat": {"mask": m1, "weight": 0.8, "mask_outsides": 0.2},
            "blue bird": {"mask": m2, "weight": 0.7, "mask_outsides": 0.1}}


def _state_dict(variant, seed):
    return tipa.random_state_dict(TTINY.unet, variant, seed=seed,
                                  embed_dim=EMBED)


def _gate(b=1, h=64, w=48):
    """A (b, h, w) gate: 1 on a non-square block off the latent grid."""
    m = np.zeros((b, h, w), np.float32)
    m[:, 5:40, 11:30] = 1.0
    return m


@pytest.fixture(scope="module")
def models():
    """Both pipelines on the same tiny weights, with two adapters (base and
    Resampler) installed into copies of both UNet trees."""
    tp = tfactory.init_pipeline_params(0, TTINY, torch.float32, device="cpu")
    jp = to_jax(tp)
    sds = [_state_dict("linear", 1), _state_dict("resampler", 2)]
    tunet_ip = tipa.copy_tree_containers(tp["unet"])
    t_ads = tipa.load_ip_adapter(tunet_ip, TTINY.unet, sds, torch.float32,
                                 "cpu")
    junet_ip = jipa.copy_tree_containers(jp["unet"])
    j_ads = jipa.load_ip_adapter(junet_ip, JTINY.unet, sds, jnp.float32)
    jpipe = StableDiffusionTPU(JTINY, {**jp, "unet": junet_ip},
                               tokenizer=jtok.HashTokenizer(),
                               attn_impl="xla")
    tpipe = StableDiffusionTorch(TTINY, {**tp, "unet": tunet_ip},
                                 tokenizer=ttok.HashTokenizer(), device="cpu")
    return jpipe, tpipe, j_ads, t_ads


_jax_unet = jax.jit(junet.unet_apply, static_argnums=(1,), static_argnames=(
    "attn_impl", "axis_name", "conv_impl", "collect_xattn"))


# -- the projections -----------------------------------------------------------

@pytest.mark.parametrize("variant", ["linear", "mlp", "faceid", "resampler"])
def test_projection_matches_jax(variant):
    sd = _state_dict(variant, 3)
    jsd = jipa.random_state_dict(JTINY.unet, variant, seed=3,
                                 embed_dim=EMBED)
    for group in ("image_proj", "ip_adapter"):
        assert list(sd[group]) == list(jsd[group])
        for k in sd[group]:
            assert np.array_equal(sd[group][k], jsd[group][k]), k
    jv, jp, jn = jipa.convert_image_proj(sd["image_proj"], jnp.float32)
    tv, tp, tn = tipa.convert_image_proj(sd["image_proj"], torch.float32,
                                         "cpu")
    assert (tv, tn) == (jv, jn) == (tipa.detect_variant(sd["image_proj"]),
                                    {"linear": 4, "mlp": 1, "faceid": 4,
                                     "resampler": 16}[variant])
    if variant == "resampler":
        assert type(tp["heads"]) is int and tp["heads"] == jp["heads"] == 1
    rng = np.random.default_rng(4)
    width = 512 if variant == "faceid" else EMBED
    shape = (2, 10, width) if variant == "resampler" else (2, width)
    emb = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jipa.LoadedIPAdapter(jv, jp, jn).project(
        jnp.asarray(emb)))
    got = tipa.LoadedIPAdapter(tv, tp, tn).project(torch.from_numpy(emb))
    assert got.shape == want.shape == (2, tn, TTINY.unet.cross_attention_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if variant == "faceid":
        np.testing.assert_allclose(
            tipa.faceid_projection_apply(tp, torch.from_numpy(emb)).numpy(),
            want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="unknown image_proj"):
        tipa.detect_variant({"x.weight": 0})


@pytest.mark.parametrize("preset", ["tiny", "sd15", "sd21"])
def test_paths_and_dims_equal_jax(preset):
    t, j = (getattr(mod, f"{preset}_config")() for mod in (tcfg, jcfg))
    assert tipa.cross_attn_paths(t.unet) == jipa.cross_attn_paths(j.unet)
    assert tipa.cross_attn_hidden_dims(t.unet) == \
        jipa.cross_attn_hidden_dims(j.unet)
    if preset == "sd15":
        paths = tipa.cross_attn_paths(t.unet)
        assert len(paths) == 16 and paths[6][0] == "up_blocks" and \
            paths[-1][0] == "mid_block"


def test_install_uninstall_and_copy_leave_the_source_tree():
    """The installed K/V kernels are the state dict's (out, in) weights,
    untransposed (JAX stores their transpose); ``copy_tree_containers``
    shares the tensors and keeps the source tree free of ``"ip"``."""
    tp = tfactory.init_pipeline_params(0, TTINY, torch.float32, device="cpu")
    sds = [_state_dict("linear", 5)["ip_adapter"],
           _state_dict("mlp", 6)["ip_adapter"]]
    copy = tipa.copy_tree_containers(tp["unet"])
    assert copy["conv_in"]["kernel"] is tp["unet"]["conv_in"]["kernel"]
    tipa.install_ip_adapter_weights(copy, TTINY.unet, sds, torch.float32,
                                    "cpu")
    paths = tipa.cross_attn_paths(TTINY.unet)
    for li, path in enumerate(paths):
        node, src = copy, tp["unet"]
        for p in path:
            node, src = node[p], src[p]
        assert "ip" not in src and len(node["ip"]) == 2
        for a, sd in enumerate(sds):
            want = sd[f"{2 * li + 1}.to_k_ip.weight"]
            assert np.array_equal(node["ip"][a]["to_k"]["kernel"].numpy(),
                                  want)
            assert node["ip"][a]["to_v"]["kernel"].shape == want.shape
    tipa.uninstall_ip_adapter_weights(copy, TTINY.unet)
    for path in paths:
        node = copy
        for p in path:
            node = node[p]
        assert "ip" not in node
    # a file of the split layout loads (tests/test_torch_convert.py holds
    # each variant's file to the JAX package's); a missing one raises
    with pytest.raises(FileNotFoundError):
        tipa.load_ip_adapter_file("no-such-weights.safetensors")
    flat = {"image_proj.proj.weight": 1, "ip_adapter.1.to_k_ip.weight": 2,
            "other.x": 3}
    assert tipa.split_ip_adapter_state_dict(flat) == \
        jipa.split_ip_adapter_state_dict(flat)


@pytest.mark.parametrize("shape,seq_len", [
    ((2, 64, 64), 64),    # square
    ((2, 64, 48), 16),    # non-square
    ((1, 10, 30), 64),    # h * w = 60 < 64: zero-padded
    ((1, 5, 8), 10),      # hm / ratio = 2.5: Python's round gives 2
    ((2, 512, 512), 4096),
    ((1, 37, 91), 1),
])
def test_downsample_mask_matches_jax(shape, seq_len):
    m = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    want = np.asarray(junet._downsample_mask(jnp.asarray(m), seq_len))
    got = tunet._downsample_mask(torch.from_numpy(m), seq_len)
    assert got.shape == want.shape == (shape[0], seq_len)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# -- the UNet ----------------------------------------------------------------

def _tokens(seed, b=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 4, 64)).astype(np.float32),
            rng.standard_normal((b, 16, 64)).astype(np.float32))


def test_unet_apply_with_two_adapters_matches_jax(models):
    """Batch 2, 8 x 8 latents, the map, adapter 0 unmasked at 0.5, adapter
    1 masked at 1.0: the shapes and tree of the denoiser tests below, so
    that they reuse this program. The per-request mask cache gives the
    same output bit for bit and holds one gate a sequence length."""
    jpipe, tpipe, _, _ = models
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    t = np.array([500.0, 31.5], np.float32)
    biases = tuple((rng.standard_normal((2, (8 // 2 ** i) ** 2, 77)) * 0.3
                    ).astype(np.float32) for i in range(4))
    toks = _tokens(1)
    gate = _gate(2)
    jcond = junet.UNetCond(
        context=jnp.asarray(ctx),
        region=junet.RegionState(tuple(map(jnp.asarray, biases)),
                                 jnp.float32(2.0)),
        ip_tokens=tuple(map(jnp.asarray, toks)), ip_scales=SCALES,
        ip_masks=(None, jnp.asarray(gate)))
    want = np.asarray(_jax_unet(
        jpipe.params["unet"], JTINY.unet, jnp.asarray(x), jnp.asarray(t),
        jcond, attn_impl="xla", axis_name=None, conv_impl=None,
        xattn_cache=None))
    tcond = tunet.UNetCond(
        context=torch.from_numpy(ctx),
        region=tunet.RegionState(tuple(map(torch.from_numpy, biases)),
                                 torch.tensor(2.0)),
        ip_tokens=tuple(map(torch.from_numpy, toks)), ip_scales=SCALES,
        ip_masks=(None, torch.from_numpy(gate)))
    args = (tpipe.params["unet"], TTINY.unet, torch.from_numpy(x),
            torch.from_numpy(t))
    got = tunet.unet_apply(*args, tcond)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # the first call filled the cond's gate cache; a call that reads it
    # gives the same output
    assert sorted(tcond.ip_mask_cache) == [(1, 1), (1, 4), (1, 16), (1, 64)]
    assert torch.equal(tunet.unet_apply(*args, tcond), got)
    plain = tunet.unet_apply(*args, dataclasses.replace(tcond,
                                                        ip_tokens=None))
    assert float((plain - got).abs().max()) > 1e-2  # the adapters count


# -- the denoiser and build_ip_extras --------------------------------------

def _extras(pipe, ads, gen_cls, xp, do_cfg, b=1):
    """Both adapters' extras from ``pipe.build_ip_extras``: adapter 0 (base)
    unmasked at 0.5, adapter 1 (Resampler) with the gate at 1.0, given
    uncond embeds for the Resampler, zeros for the base."""
    arr = jnp.asarray if xp == "jax" else torch.from_numpy
    rng = np.random.default_rng(7)
    e0 = rng.standard_normal((b, EMBED)).astype(np.float32)
    e1 = rng.standard_normal((b, 10, EMBED)).astype(np.float32)
    u1 = rng.standard_normal((b, 10, EMBED)).astype(np.float32)
    return pipe.build_ip_extras(
        ads, [arr(e0), arr(e1)], scales=list(SCALES),
        masks=[None, arr(_gate(b))],
        uncond_image_embeds=None if not do_cfg else [arr(np.zeros_like(e0)),
                                                     arr(u1)],
        do_cfg=do_cfg)


@pytest.mark.parametrize("do_cfg", [True, False])
def test_build_ip_extras_matches_jax(models, do_cfg):
    jpipe, tpipe, j_ads, t_ads = models
    j = _extras(jpipe, j_ads, jcfg.GenerationConfig, "jax", do_cfg)
    t = _extras(tpipe, t_ads, tcfg.GenerationConfig, "torch", do_cfg)
    assert t.ip_scales == j.ip_scales == SCALES
    assert t.ip_masks[0] is None and j.ip_masks[0] is None
    assert np.array_equal(t.ip_masks[1].numpy(), np.asarray(j.ip_masks[1]))
    assert t.ip_masks[1].shape[0] == (2 if do_cfg else 1)
    for a, b in zip(t.ip_tokens, j.ip_tokens):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("guidance", [7.5, 1.0])
def test_denoiser_with_ip_matches_jax_eager(models, guidance, monkeypatch):
    """CFG on (one sample, the tokens and the gate interleaved) and off
    (two prompts): every UNet call is at batch 2 with the map, the
    program of ``test_unet_apply_with_two_adapters_matches_jax``."""
    jpipe, tpipe, j_ads, t_ads = models
    monkeypatch.setattr(jpipeline, "unet_apply", _jax_unet)
    batch = 1 if guidance > 1.0 else 2
    sched = jsched.get_sigmas(JTINY, 4, "karras")
    x = np.random.default_rng(20).standard_normal((batch, 8, 8, 4)).astype(
        np.float32)
    outs = []
    for xp, pipe, ads in (("jax", jpipe, j_ads), ("torch", tpipe, t_ads)):
        prompts = [PROMPT, "a blue bird over a red cat"][:batch]
        ctx, ids = pipe.encode_prompt(prompts, [NEG] * batch)
        if guidance <= 1.0:
            ctx = ctx[ctx.shape[0] // 2:]
        rb = pipe.encode_region([_masks(64, 64)] * batch, ids, 64, 64,
                                do_cfg=guidance > 1.0)
        ex = _extras(pipe, ads, None, xp, guidance > 1.0, batch)
        if xp == "jax":
            den = jpipeline.make_denoise_fn(
                pipe.params, JTINY, ctx, rb,
                jnp.asarray(np.log(jsched.ddpm_sigma_table(JTINY)),
                            jnp.float32), guidance, 0.0, "xla",
                compute_dtype=jnp.float32, extras=ex,
                sigma_steps=sched[:-1])
            outs.append([np.asarray(den(jnp.asarray(x * float(s)),
                                        jnp.float32(s)))
                         for s in sched[:2]])
        else:
            den = tpipeline.make_denoise_fn(
                pipe.params, TTINY, ctx, rb, pipe.log_sigma_table, guidance,
                0.0, "pallas", compute_dtype=torch.float32, extras=ex,
                sigma_steps=sched[:-1])
            outs.append([den(torch.from_numpy(x * float(s)),
                             torch.tensor(float(s))).numpy()
                         for s in sched[:2]])
    for want, got in zip(*outs):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


# -- the pipeline ------------------------------------------------------------

def test_txt2img_with_two_ip_units_matches_jax(models):
    """The slice end to end: 3 DPM++ 2M steps, CFG 7.5, the map and both
    adapters; the one JAX sampling program of this file."""
    jpipe, tpipe, j_ads, t_ads = models
    lat = np.random.default_rng(40).standard_normal((1, 8, 8, 4)).astype(
        np.float32)
    out = []
    for xp, pipe, gen_cls, dt, arr, ads in (
            ("jax", jpipe, jcfg.GenerationConfig, jnp.float32, jnp.asarray,
             j_ads),
            ("torch", tpipe, tcfg.GenerationConfig, torch.float32,
             torch.from_numpy, t_ads)):
        gen = gen_cls(height=64, width=64, num_inference_steps=3, dtype=dt)
        ctx, ids = pipe.encode_prompt([PROMPT], [NEG])
        out.append(pipe.txt2img(
            ctx, gen, latents=arr(lat), decode=False,
            extras=_extras(pipe, ads, gen_cls, xp, True),
            region_biases=pipe.encode_region([_masks(64, 64)], ids, 64, 64)))
    want, got = np.asarray(out[0]), out[1]
    assert got.shape == (1, 8, 8, 4) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_every_sampling_method_takes_ip_extras(models):
    """``sample_chunked`` with the IP extras is ``txt2img`` bit for bit;
    hires needs no ``rebuild_extras`` for them (resolution-free) and the
    gate is downsampled at the hires pass's lengths; img2img and inpaint
    are moved by the adapters."""
    _, tpipe, _, t_ads = models
    gen = tcfg.GenerationConfig(height=64, width=64, num_inference_steps=3,
                                dtype=torch.float32)
    ctx, _ = tpipe.encode_prompt([PROMPT], [NEG])
    ex = _extras(tpipe, t_ads, None, "torch", True)
    lat = torch.from_numpy(np.random.default_rng(50).standard_normal(
        (1, 8, 8, 4)).astype(np.float32))
    full = tpipe.txt2img(ctx, gen, latents=lat, extras=ex, decode=False)
    chunked = tpipe.sample_chunked(ctx, gen, latents=lat, extras=ex,
                                   chunk_steps=2, decode=False)
    assert torch.equal(chunked, full)
    assert not torch.allclose(full, tpipe.txt2img(ctx, gen, latents=lat,
                                                  decode=False))
    img = tpipe.txt2img(ctx, gen, extras=ex, hires={
        "scale": 2.0, "strength": 0.5, "steps": 2})
    assert img.shape == (1, 128, 128, 3) and torch.isfinite(img).all()
    init = torch.from_numpy(np.random.default_rng(51).uniform(
        -1, 1, (1, 64, 64, 3)).astype(np.float32))
    mask = torch.zeros(1, 64, 64)
    mask[:, :, 32:] = 1.0
    lats = tpipe.encode_image(init, seed=1)
    for run in (lambda e: tpipe.img2img(ctx, lats, gen, strength=0.7,
                                        extras=e, decode=False),
                lambda e: tpipe.inpaint(ctx, init, mask, gen, extras=e,
                                        decode=False)):
        assert not torch.allclose(run(ex), run(None))
