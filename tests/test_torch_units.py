"""ControlNet and T2I-Adapter units through the port's UNet, denoiser,
pipeline and app helpers, against the JAX package, on the CPU.

Tiny config, fp32; parameters from the port's own init (the ControlNets
with random heads, see tests/test_torch_controlnet.py) moved to the JAX
layout; the same numpy latents, context, maps and control images on both
sides.

* ``unet_apply`` with ControlNet and T2I residuals: rtol/atol 1e-4, as
  tests/test_torch_unet.py holds the UNet;
* the denoiser against JAX's ``make_denoise_fn`` called eagerly (outside a
  sampling program; only its UNet and ControlNet calls are jitted, one
  program each, which takes a third of the time of their op-by-op
  compiles) at several sigmas: inside and outside a unit's window, a
  second-order solver's intermediate sigma, CFG on and off, guess mode, two
  ControlNets with a T2I-Adapter and a map, and a schedule cut by
  img2img's strength. Outputs reach |x| ~ 15, so the bound is 1e-5 of their
  max abs, as for the solvers' latents (tests/test_torch_sampling.py);
* the slice as a whole: one JAX sampling program, txt2img with a ControlNet,
  a T2I-Adapter and a map, 3 steps, latents passed: 1e-4 on pixels;
* ``_fit_unit_image`` against ``jax.image.resize`` (bilinear, its default
  antialias), shrinking and enlarging: 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.app import api as japi
from diffusionspatialcontrol_tpu.models import controlnet as jcn
from diffusionspatialcontrol_tpu.models import t2i_adapter as jt2i
from diffusionspatialcontrol_tpu.models import unet as junet
from diffusionspatialcontrol_tpu.pipeline import pipeline as jpipeline
from diffusionspatialcontrol_tpu.pipeline.pipeline import StableDiffusionTPU
from diffusionspatialcontrol_tpu.samplers import schedules as jsched
from diffusionspatialcontrol_tpu.text import tokenizer as jtok
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.app import api as tapi
from diffusionspatialcontrol_tpu_torch.models import controlnet as tcn
from diffusionspatialcontrol_tpu_torch.models import factory as tfactory
from diffusionspatialcontrol_tpu_torch.models import t2i_adapter as tt2i
from diffusionspatialcontrol_tpu_torch.models import unet as tunet
from diffusionspatialcontrol_tpu_torch.pipeline import pipeline as tpipeline
from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
    StableDiffusionTorch,
)
from diffusionspatialcontrol_tpu_torch.text import tokenizer as ttok
from tests.test_torch_controlnet import controlnet_params, to_jax

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

PROMPT = "a red cat sitting on a wooden bench, a blue bird flying"
NEG = "bad quality, low quality, jpeg artifact, cropped"
JTINY, TTINY = jcfg.tiny_config(), tcfg.tiny_config()


def _masks(h, w):
    m1 = np.zeros((h, w), np.float32)
    m1[:, : w // 2] = 1.0
    m2 = np.zeros((h, w), np.float32)
    m2[: h // 3, w // 2:] = 1.0
    return {"red cat": {"mask": m1, "weight": 0.8, "mask_outsides": 0.2},
            "blue bird": {"mask": m2, "weight": 0.7, "mask_outsides": 0.1}}


@pytest.fixture(scope="module")
def models():
    """Both pipelines on the same weights, two ControlNets with random heads
    and a T2I-Adapter, in both layouts."""
    tp = tfactory.init_pipeline_params(0, TTINY, torch.float32, device="cpu")
    jpipe = StableDiffusionTPU(JTINY, to_jax(tp),
                               tokenizer=jtok.HashTokenizer(),
                               attn_impl="xla")
    tpipe = StableDiffusionTorch(TTINY, tp, tokenizer=ttok.HashTokenizer(),
                                 device="cpu")
    cns = [controlnet_params(seed) for seed in (1, 2)]
    ad = tt2i.t2i_adapter_init(
        torch.Generator().manual_seed(3),
        tcfg.T2IAdapterConfig(channels=TTINY.unet.block_out_channels),
        dtype=torch.float32, device="cpu")
    return jpipe, tpipe, cns, (ad, to_jax(ad))


def _images(seed, n=1, side=64):
    rng = np.random.default_rng(seed)
    return [rng.random((n, side, side, 3)).astype(np.float32)]


_jax_unet = jax.jit(junet.unet_apply, static_argnums=(1,), static_argnames=(
    "attn_impl", "axis_name", "conv_impl", "collect_xattn"))
_jax_controlnet = jax.jit(jcn.controlnet_apply, static_argnums=(1,),
                          static_argnames=("guess_mode",))
# the JAX builder runs its adapters eagerly, one compile an op and shape;
# one program a batch and adapter count takes a third of that
_jax_adapters = jax.jit(jt2i.multi_adapter_apply, static_argnums=(1,))


# -- the UNet ----------------------------------------------------------------

def test_unet_apply_with_residuals_matches_jax(models):
    """At the denoiser tests' shapes (batch 2, 8 x 8 latents), so that they
    reuse this program."""
    jpipe, tpipe, _, _ = models
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    t = np.array([500.0, 31.5], np.float32)
    skips = [(8, 32)] * 3 + [(4, 32), (4, 64), (4, 64), (2, 64), (2, 128),
                             (2, 128), (1, 128), (1, 128), (1, 128)]
    down = [(0.3 * rng.standard_normal((2, s, s, c))).astype(np.float32)
            for s, c in skips]
    mid = (0.3 * rng.standard_normal((2, 1, 1, 128))).astype(np.float32)
    t2i = [(0.3 * rng.standard_normal((2, s, s, c))).astype(np.float32)
           for s, c in ((8, 32), (4, 64), (2, 128), (1, 128))]
    biases = tuple((rng.standard_normal((2, (8 // 2 ** i) ** 2, 77)) * 0.3
                    ).astype(np.float32) for i in range(4))
    jcond = junet.UNetCond(
        context=jnp.asarray(ctx),
        region=junet.RegionState(tuple(map(jnp.asarray, biases)),
                                 jnp.float32(2.0)),
        controlnet_down=tuple(map(jnp.asarray, down)),
        controlnet_mid=jnp.asarray(mid), t2i_residuals=tuple(map(jnp.asarray,
                                                                  t2i)))
    want = np.asarray(_jax_unet(  # the keywords make_denoise_fn passes
        jpipe.params["unet"], JTINY.unet, jnp.asarray(x), jnp.asarray(t),
        jcond, attn_impl="xla", axis_name=None, conv_impl=None,
        xattn_cache=None))
    tcond = tunet.UNetCond(
        context=torch.from_numpy(ctx),
        region=tunet.RegionState(tuple(map(torch.from_numpy, biases)),
                                 torch.tensor(2.0)),
        controlnet_down=tuple(map(torch.from_numpy, down)),
        controlnet_mid=torch.from_numpy(mid),
        t2i_residuals=tuple(map(torch.from_numpy, t2i)))
    args = (tpipe.params["unet"], TTINY.unet, torch.from_numpy(x),
            torch.from_numpy(t))
    got = tunet.unet_apply(*args, tcond)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    plain = tunet.unet_apply(*args, dataclasses.replace(
        tcond, controlnet_down=None, controlnet_mid=None, t2i_residuals=None))
    assert float((plain - got).abs().max()) > 1e-2  # the residuals count
    # bf16 activations take the fp32 residuals rounded at each add
    bf = tunet.unet_apply(
        jax.tree_util.tree_map(lambda a: a.bfloat16(), args[0]), TTINY.unet,
        args[2].bfloat16(), args[3], dataclasses.replace(
            tcond, context=tcond.context.bfloat16(), region=None))
    assert bf.dtype == torch.bfloat16 and torch.isfinite(bf).all()


@pytest.mark.parametrize("steps", [1, 4, 7, 25])
def test_controlnet_keep_schedule_equals_jax(steps):
    grid = np.linspace(0.0, 1.0, 9)
    starts = [s for s in grid for e in grid]
    ends = [e for s in grid for e in grid]
    np.testing.assert_array_equal(
        tpipeline.controlnet_keep_schedule(steps, starts, ends),
        jpipeline.controlnet_keep_schedule(steps, starts, ends))


# -- the denoiser --------------------------------------------------------------

def _build(pipe, gen, cns, ad, case, imgs, xp):
    """The extras of ``case`` built by ``pipe``'s own builders."""
    arr = jnp.asarray if xp == "jax" else torch.from_numpy
    do_cfg = gen.guidance_scale > 1.0
    n_cn = 2 if case == "two_cn_t2i_map" else 1
    guess = case.startswith("guess")
    ex = pipe.build_controlnet_extras(
        gen, [c[0 if xp == "torch" else 1] for c in cns[:n_cn]],
        [arr(i) for i in imgs[:n_cn]], scales=[1.2, 0.6][:n_cn],
        starts=[0.0, 0.25][:n_cn], ends=[0.5, 1.0][:n_cn], guess_mode=guess,
        do_cfg=do_cfg)
    # every case has a T2I-Adapter (with guess mode too): one UNet
    # program (residuals of both kinds, a map) serves them all
    ex = pipe.build_t2i_extras(
        gen, [ad[0 if xp == "torch" else 1]], [arr(imgs[2])],
        scales=[0.9], conditioning_factor=0.5, do_cfg=do_cfg, base=ex)
    return ex


CASES = {  # case: (guidance, map, strength)
    "two_cn_t2i_map": (7.5, True, 1.0),
    "guess": (7.5, True, 1.0),
    "cfg_off": (1.0, True, 1.0),
    "guess_cfg_off": (1.0, True, 1.0),
    "cut_schedule": (7.5, True, 0.5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_denoiser_with_units_matches_jax_eager(models, case, monkeypatch):
    """At each sigma of the sampled schedule the units' scales come from
    that step's column (4 steps: the first ControlNet's window [0, 0.5)
    covers steps 0-1, the second's [0.25, 1] steps 1-3, the adapter's
    factor 0.5 steps 0-1); an intermediate sigma between steps 1 and 2
    lands on the nearer. With strength 0.5 the cut schedule's two steps
    read the first two columns. Guess mode without CFG scales as the
    normal mode does. Without CFG the batch is two samples (two prompts),
    so that every UNet call is at batch 2 and shares JAX's per-op compiles
    with the others."""
    jpipe, tpipe, cns, ad = models
    monkeypatch.setattr(jpipeline, "unet_apply", _jax_unet)
    monkeypatch.setattr(jcn, "controlnet_apply", _jax_controlnet)
    monkeypatch.setattr(jt2i, "multi_adapter_apply", _jax_adapters)
    guidance, mapped, strength = CASES[case]
    batch = 1 if guidance > 1.0 else 2
    imgs = [_images(10 + i, batch)[0] for i in range(3)]
    sigmas = jsched.get_sigmas(JTINY, 4, "karras")
    steps = int(4 * strength)
    sched = sigmas[4 - steps:]
    x = np.random.default_rng(20).standard_normal((batch, 8, 8, 4)).astype(
        np.float32)
    outs = []
    for xp, pipe, gen_cls, dt in (
            ("jax", jpipe, jcfg.GenerationConfig, jnp.float32),
            ("torch", tpipe, tcfg.GenerationConfig, torch.float32)):
        gen = gen_cls(height=64, width=64, num_inference_steps=4,
                      guidance_scale=guidance, dtype=dt)
        prompts = [PROMPT, "a blue bird over a red cat"][:batch]
        ctx, ids = pipe.encode_prompt(prompts, [NEG] * batch)
        if guidance <= 1.0:
            ctx = ctx[ctx.shape[0] // 2:]
        rb = (pipe.encode_region([_masks(64, 64)] * batch, ids, 64, 64,
                                 do_cfg=guidance > 1.0) if mapped else None)
        ex = _build(pipe, gen, cns, ad, case, imgs, xp)
        if xp == "jax":
            den = jpipeline.make_denoise_fn(
                pipe.params, JTINY, ctx, rb,
                jnp.asarray(np.log(jsched.ddpm_sigma_table(JTINY)),
                            jnp.float32), guidance, 0.0, "xla",
                compute_dtype=jnp.float32, extras=ex,
                sigma_steps=sched[:-1])

            def call(s, den=den):
                return np.asarray(den(jnp.asarray(x * float(s)),
                                      jnp.float32(s)))
        else:
            den = tpipeline.make_denoise_fn(
                pipe.params, TTINY, ctx, rb, pipe.log_sigma_table, guidance,
                0.0, "pallas", compute_dtype=torch.float32, extras=ex,
                sigma_steps=sched[:-1])

            def call(s, den=den):
                return den(torch.from_numpy(x * float(s)),
                           torch.tensor(float(s), dtype=torch.float32))
        probe = [sched[0], float(np.sqrt(sched[1] * sched[2]))]
        if case == "two_cn_t2i_map":
            probe.append(sched[3])
        outs.append([call(s) for s in probe])
    for i, (want, got) in enumerate(zip(*outs)):
        assert got.shape == want.shape and torch.isfinite(got).all()
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=1e-5 * float(np.abs(want).max()), err_msg=f"sigma {i}")


def test_cond_embedding_once_is_bitwise_per_call(models, monkeypatch):
    """The denoiser computes each ControlNet's cond embedding once; taking
    it at every call instead gives the same output bit for bit."""
    _, tpipe, cns, _ = models
    gen = tcfg.GenerationConfig(height=64, width=64, num_inference_steps=4,
                                dtype=torch.float32)
    ctx, _ = tpipe.encode_prompt([PROMPT], [NEG])
    sigmas = jsched.get_sigmas(JTINY, 4, "karras")
    ex = tpipe.build_controlnet_extras(gen, [cns[0][0]], _images(30),
                                       scales=[1.0])
    x = torch.from_numpy(np.random.default_rng(31).standard_normal(
        (1, 8, 8, 4)).astype(np.float32))

    def run():
        den = tpipeline.make_denoise_fn(
            tpipe.params, TTINY, ctx, None, tpipe.log_sigma_table, 7.5,
            compute_dtype=torch.float32, extras=ex, sigma_steps=sigmas[:-1])
        return den(x * float(sigmas[1]), torch.tensor(float(sigmas[1])))

    once = run()
    images = []
    monkeypatch.setattr(tpipeline, "controlnet_cond_embedding",
                        lambda p, img, dtype: images.append(img) or img)
    monkeypatch.setattr(
        tpipeline, "controlnet_apply",
        lambda p, cfg, x, t, c, img, **k: tcn.controlnet_apply(
            p, cfg, x, t, c, tcn.controlnet_cond_embedding(p, img, x.dtype),
            **k))
    per_call = run()
    assert len(images) == 1 and torch.equal(per_call, once)


# -- the pipeline --------------------------------------------------------------

def test_txt2img_with_units_matches_jax(models, monkeypatch):
    """The slice end to end: 3 DPM++ 2M steps, a ControlNet (window
    [0, 0.7)) with a T2I-Adapter (factor 0.5) and the map, CFG 7.5, VAE
    decode; the one JAX sampling program of this file."""
    jpipe, tpipe, cns, ad = models
    monkeypatch.setattr(jt2i, "multi_adapter_apply", _jax_adapters)
    lat = np.random.default_rng(40).standard_normal((1, 8, 8, 4)).astype(
        np.float32)
    imgs = _images(41) + _images(42)
    out = []
    for xp, pipe, gen_cls, dt, arr in (
            ("jax", jpipe, jcfg.GenerationConfig, jnp.float32, jnp.asarray),
            ("torch", tpipe, tcfg.GenerationConfig, torch.float32,
             torch.from_numpy)):
        i = 0 if xp == "torch" else 1
        gen = gen_cls(height=64, width=64, num_inference_steps=3, dtype=dt)
        ctx, ids = pipe.encode_prompt([PROMPT], [NEG])
        ex = pipe.build_controlnet_extras(gen, [cns[0][i]], [arr(imgs[0])],
                                          scales=[1.0], ends=[0.7])
        ex = pipe.build_t2i_extras(gen, [ad[i]], [arr(imgs[1])],
                                   scales=[1.0], conditioning_factor=0.5,
                                   base=ex)
        out.append(pipe.txt2img(
            ctx, gen, latents=arr(lat), extras=ex,
            region_biases=pipe.encode_region([_masks(64, 64)], ids, 64, 64)))
    want, got = np.asarray(out[0]), out[1]
    assert got.shape == (1, 64, 64, 3) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_zero_head_controlnet_gives_the_latents_of_none(models):
    _, tpipe, _, _ = models
    fresh = tcn.controlnet_init(torch.Generator().manual_seed(7), TTINY.unet,
                                dtype=torch.float32, device="cpu")
    gen = tcfg.GenerationConfig(height=64, width=64, num_inference_steps=2,
                                dtype=torch.float32)
    ctx, _ = tpipe.encode_prompt([PROMPT], [NEG])
    lat = torch.from_numpy(np.random.default_rng(50).standard_normal(
        (1, 8, 8, 4)).astype(np.float32))
    ex = tpipe.build_controlnet_extras(gen, [fresh], _images(51),
                                       scales=[1.0])
    with_cn = tpipe.txt2img(ctx, gen, latents=lat, extras=ex, decode=False)
    without = tpipe.txt2img(ctx, gen, latents=lat, decode=False)
    assert torch.equal(with_cn, without)


def test_hires_with_units_needs_rebuild_extras(models):
    """Unit extras are bound to the base size: a hires pass without
    ``rebuild_extras`` raises; with it, the hires pass gets the extras it
    returns for the pass's own config (128^2, its own steps)."""
    _, tpipe, cns, ad = models
    gen = tcfg.GenerationConfig(height=64, width=64, num_inference_steps=2,
                                dtype=torch.float32)
    ctx, _ = tpipe.encode_prompt([PROMPT], [NEG])
    ex = tpipe.build_controlnet_extras(gen, [cns[0][0]], _images(60),
                                       scales=[1.0])
    hires = {"scale": 2.0, "strength": 0.5, "steps": 2}
    with pytest.raises(ValueError, match="rebuild_extras"):
        tpipe.txt2img(ctx, gen, extras=ex, hires=hires)
    seen = []

    def rebuild(gen_hr):
        seen.append((gen_hr.height, gen_hr.width, gen_hr.num_inference_steps))
        e = tpipe.build_controlnet_extras(gen_hr, [cns[0][0]],
                                          _images(61, side=128), scales=[1.0])
        return tpipe.build_t2i_extras(gen_hr, [ad[0]], _images(62, side=128),
                                      scales=[1.0], base=e)

    img = tpipe.txt2img(ctx, gen, extras=ex,
                        hires=dict(hires, rebuild_extras=rebuild))
    assert seen == [(128, 128, 2)]
    assert img.shape == (1, 128, 128, 3) and torch.isfinite(img).all()


def test_controlnet_on_a_nine_channel_unet_raises_before_sampling(
        monkeypatch):
    """A ControlNet built for the 9-channel inpaint UNet (as the app builds
    it from the model's config) is fed the 4 latent channels: ValueError
    before the first UNet call (the JAX package fails on the shapes)."""
    nine = dataclasses.replace(
        TTINY, unet=dataclasses.replace(TTINY.unet, in_channels=9))
    pipe = StableDiffusionTorch(
        nine, tfactory.init_pipeline_params(0, nine, torch.float32,
                                            device="cpu"),
        tokenizer=ttok.HashTokenizer(), device="cpu")
    cn9 = tcn.controlnet_init(torch.Generator().manual_seed(0), nine.unet,
                              dtype=torch.float32, device="cpu")
    gen = tcfg.GenerationConfig(height=64, width=64, num_inference_steps=2,
                                dtype=torch.float32)
    ctx, _ = pipe.encode_prompt([PROMPT], [NEG])
    ex = pipe.build_controlnet_extras(gen, [cn9], _images(70), scales=[1.0])
    monkeypatch.setattr(tpipeline, "unet_apply", None)  # never reached
    img = torch.zeros(1, 64, 64, 3)
    mask = torch.ones(1, 64, 64)
    with pytest.raises(ValueError, match="in_channels=9"):
        pipe.inpaint(ctx, img, mask, gen, extras=ex)


def test_unit_builders_match_jax(models, monkeypatch):
    """``build_controlnet_extras`` (images doubled for CFG, not in guess
    mode; the window table) and ``build_t2i_extras`` (the adapters' scaled
    sum, doubled; the active steps) against the JAX package's."""
    jpipe, tpipe, cns, ad = models
    monkeypatch.setattr(jt2i, "multi_adapter_apply", _jax_adapters)
    imgs = _images(80, 2) + _images(81, 2)
    res = {}
    for xp, pipe, gen_cls, arr in (
            ("jax", jpipe, jcfg.GenerationConfig, jnp.asarray),
            ("torch", tpipe, tcfg.GenerationConfig, torch.from_numpy)):
        i = 0 if xp == "torch" else 1
        gen = gen_cls(height=64, width=64, num_inference_steps=7)
        res[xp] = [pipe.build_controlnet_extras(
            gen, [cns[0][i], cns[1][i]], [arr(m) for m in imgs],
            scales=[0.5, 1.5], starts=[0.1, 0.0], ends=[0.9, 0.4],
            guess_mode=guess) for guess in (False, True)]
        res[xp].append(pipe.build_t2i_extras(
            gen, [ad[i], ad[i]], [arr(m) for m in imgs], scales=[0.7, 0.2],
            conditioning_factor=0.6))
    for j, t in zip(res["jax"][:2], res["torch"][:2]):
        np.testing.assert_array_equal(np.asarray(t.controlnet_scales),
                                      np.asarray(j.controlnet_scales))
        assert t.controlnet_guess == j.controlnet_guess
        for a, b in zip(t.controlnet_images, j.controlnet_images):
            assert np.array_equal(a.numpy(), np.asarray(b))
    jt, tt = res["jax"][2], res["torch"][2]
    np.testing.assert_array_equal(np.asarray(tt.t2i_active),
                                  np.asarray(jt.t2i_active))
    for a, b in zip(tt.t2i_residuals, jt.t2i_residuals):
        assert a.shape[0] == 4
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


# -- the app's unit images -----------------------------------------------------

@pytest.mark.parametrize("src,dst", [((96, 96), (64, 64)),
                                     ((48, 40), (64, 64)),
                                     ((100, 60), (64, 48))])
@pytest.mark.parametrize("channels", [3, None])
def test_fit_unit_image_matches_jax(src, dst, channels):
    """Shrinking antialiases (the kernel widens by the ratio), as
    jax.image.resize's default does; a 2-D image gains a channel axis."""
    shape = src + ((channels,) if channels else ())
    img = np.random.default_rng(sum(src)).random(shape).astype(np.float32)
    want = np.asarray(japi._fit_unit_image(img, *dst))
    got = tapi._fit_unit_image(img, *dst)
    assert tuple(got.shape) == want.shape == dst + (channels or 1,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    no_aa = tpipeline.resize_latents(torch.from_numpy(img.reshape(
        (1,) + src + (-1,))), *dst, antialias=False)[0]
    if src[0] > dst[0]:
        assert float((no_aa - got).abs().max()) > 1e-3


def test_unit_images_uint8_and_batch_match_jax():
    img = np.random.default_rng(90).integers(0, 256, (64, 64, 3)).astype(
        np.uint8)
    for cls_t, cls_j in ((tapi.ControlNetUnit, japi.ControlNetUnit),
                         (tapi.T2IAdapterUnit, japi.T2IAdapterUnit)):
        got = tapi._maybe_preprocess(None, cls_t("m", img))
        want = japi._maybe_preprocess(None, cls_j("m", img))
        assert got.dtype == np.float32 and np.array_equal(got, want)
    for n in (1, 3):
        got = tapi._unit_batch(img[..., 0], n)
        want = np.asarray(japi._unit_batch(img[..., 0], n))
        assert np.array_equal(got.numpy(), want)
