"""The opt-in speed modes of the port's pipeline and app layer against the
JAX package's, on the CPU: TGATE, DeepCache, bottleneck sampling and
cfg-tail (``txt2img_tgate``, ``txt2img_deepcache``, ``txt2img_bottleneck``,
``txt2img_cfg_tail``), their identities with ``txt2img``, their rejections
and messages, and ``inference()`` with each mode (tests/test_tgate.py,
test_deepcache.py, test_bottleneck.py and test_app_modes.py, case for case
where a case applies to the port).

Tiny config, fp32, the port's init moved to the JAX layouts, a random
context (no CLIP run) and the two-phrase map on both sides. The JAX
references run the package's own mode methods with the same initial
latents and boundary noise (its ``_keyed_normal`` patched; the port's
``initial_noise`` and ``bottleneck_draws``), eagerly: ``jax_eager`` calls its
jitted cores unjitted, runs ``lax.scan`` as a Python loop over the same
step inputs, and jits only the UNet (one compile a batch, size and option
set, shared by the module's tests), which costs a fraction of compiling
every sampling program. Tolerance on the final latents (magnitude ~1-3
after 6 DPM++ 2M steps through the ~40-layer fp32 UNet, each step summing
in another order on each side): rtol 1e-4, atol 1e-4 times their max abs,
as tests/test_torch_units.py bounds its solver outputs.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.models import unet as junet
from diffusionspatialcontrol_tpu.pipeline import pipeline as jpipeline
from diffusionspatialcontrol_tpu.samplers import solvers as jsolvers
from diffusionspatialcontrol_tpu.text import tokenizer as jtok
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch import registry as tregistry
from diffusionspatialcontrol_tpu_torch.app import api as tapi
from diffusionspatialcontrol_tpu_torch.models import factory as tfactory
from diffusionspatialcontrol_tpu_torch.pipeline import pipeline as tpipeline
from diffusionspatialcontrol_tpu_torch.samplers import solvers as tsolvers
from diffusionspatialcontrol_tpu_torch.text import tokenizer as ttok
from diffusionspatialcontrol_tpu_torch.utils import region_ui
from tests.test_torch_controlnet import to_jax

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

PROMPT = "a red cat sitting on a wooden bench, a blue bird flying"
JTINY, TTINY = jcfg.tiny_config(), tcfg.tiny_config()

# The JAX references' UNet programs. XLA's backend optimization level 0
# halves their compile time on the CPU (11 against 22 s a program on one
# core) and moves their outputs by ~1e-6, a hundredth of the tolerances.
_FAST_COMPILE = {"xla_backend_optimization_level": 0}
JAX_UNET = jax.jit(junet.unet_apply, static_argnums=(1,), static_argnames=(
    "attn_impl", "freeu", "collect_heatmaps", "axis_name", "conv_impl",
    "collect_xattn"), compiler_options=_FAST_COMPILE)
JAX_DEEPCACHE = jax.jit(junet.unet_apply_deepcache, static_argnums=(1,),
                        static_argnames=("attn_impl", "freeu", "axis_name",
                                         "conv_impl"),
                        compiler_options=_FAST_COMPILE)


def pyscan(f, init, xs, length=None, **_):
    """``jax.lax.scan`` as a Python loop: the same body on the same step
    inputs, run eagerly."""
    n = length if xs is None else len(jax.tree_util.tree_leaves(xs)[0])
    carry, ys = init, []
    for i in range(n):
        carry, y = f(carry, None if xs is None else
                     jax.tree_util.tree_map(lambda a: a[i], xs))
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys)


@contextlib.contextmanager
def jax_eager(draws=None):
    """The JAX package's sampling programs run eagerly with a jitted UNet
    (see the module docstring); ``draws``: the arrays its ``_keyed_normal``
    returns, in call order."""
    it = iter(draws or ())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "scan", pyscan)
        mp.setattr(jpipeline, "unet_apply", JAX_UNET)
        mp.setattr(jpipeline, "unet_apply_deepcache", JAX_DEEPCACHE)
        for name in ("_sample_core", "_sample_chunk", "_tgate_core",
                     "_sample_deepcache_core", "_denoise_once"):
            mp.setattr(jpipeline, name, getattr(jpipeline, name).__wrapped__)
        mp.setattr(jpipeline, "_keyed_normal",
                   lambda k, shape, dtype=jnp.float32: jnp.asarray(next(it)))
        yield mp


@contextlib.contextmanager
def torch_draws(latents, boundary=None):
    """The port's seeded draws replaced by the same arrays."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipeline, "initial_noise",
                   lambda seeds, shape, device: torch.from_numpy(latents))
        if boundary is not None:
            mp.setattr(tpipeline, "bottleneck_draws",
                       lambda seeds, low, full, device: tuple(
                           map(torch.from_numpy, (latents,) + boundary)))
        yield


def two_masks(side):
    m1 = np.zeros((side, side), np.float32)
    m1[:, : side // 2] = 1.0
    m2 = np.zeros((side, side), np.float32)
    m2[: side // 3, side // 2:] = 1.0
    return {"red cat": {"mask": m1, "weight": 0.8, "mask_outsides": 0.2},
            "blue bird": {"mask": m2, "weight": 0.7, "mask_outsides": 0.1}}


@pytest.fixture(scope="module")
def pipes():
    """Both pipelines on the same tiny weights, a random (2, 77, 64)
    context [uncond, cond] and the prompt's token ids."""
    tp = tfactory.init_pipeline_params(0, TTINY, torch.float32, device="cpu")
    jpipe = jpipeline.StableDiffusionTPU(JTINY, to_jax(tp),
                                         tokenizer=jtok.HashTokenizer(),
                                         attn_impl="xla")
    tpipe = tpipeline.StableDiffusionTorch(
        TTINY, tp, tokenizer=ttok.HashTokenizer(), device="cpu")
    ctx = np.random.default_rng(0).standard_normal((2, 77, 64)).astype(
        np.float32)
    tok = ttok.HashTokenizer()
    ids = [(tok.encode(PROMPT) + [tok.pad_token_id] * 77)[:77]]
    return jpipe, tpipe, ctx, ids


def gens(side=64, **kw):
    kw = dict(height=side, width=side, num_inference_steps=6, **kw)
    return (jcfg.GenerationConfig(dtype=jnp.float32, **kw),
            tcfg.GenerationConfig(dtype=torch.float32, **kw))


def latents(side, seed=0, n=1):
    return np.random.default_rng(seed).standard_normal(
        (n, side // 8, side // 8, 4)).astype(np.float32)


def assert_latents_close(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def cfg_batch(ctx, ids, side):
    """A CFG batch of two prompts: the context [u0, u1, c0, c1] (the second
    prompt's pair random too), the map and the map mirrored left to right,
    and the ids twice. At batch 1 the interleaved [u0, c0, u1, c1] and the
    blocked row orders are one order; here a slip between them shows."""
    other = np.random.default_rng(1).standard_normal(ctx.shape).astype(
        np.float32)
    state = two_masks(side)
    mirrored = {k: {**v, "mask": v["mask"][:, ::-1].copy()}
                for k, v in state.items()}
    return (np.concatenate([ctx[:1], other[:1], ctx[1:], other[1:]]),
            [state, mirrored], ids + ids)


def spy_xattn_cache(mp, module, seen):
    """Records the frozen cross-attention outputs ``module``'s TGATE tail
    hands to ``make_denoise_fn``."""
    make = module.make_denoise_fn

    def spy(*args, **kwargs):
        if kwargs.get("xattn_cache") is not None:
            seen.append(kwargs["xattn_cache"])
        return make(*args, **kwargs)
    mp.setattr(module, "make_denoise_fn", spy)


# -- TGATE --------------------------------------------------------------------

@pytest.mark.parametrize("sampler", ["dpmpp_2m", "euler"])
def test_tgate_matches_jax(pipes, sampler):
    """The CFG segment, the collect forward (CFG pair averaged), and the
    cond-only tail on frozen cross-attention outputs without the map, at
    batch 2 with CFG (``cfg_batch``). The frozen outputs are held to the JAX
    package's too, at the UNet tolerance (rtol/atol 1e-4): in the tiny
    UNet they move the final latents by less than the latents' tolerance,
    so a pair averaged across the wrong rows would pass on those alone."""
    jpipe, tpipe, ctx, ids = pipes
    ctx, states, ids = cfg_batch(ctx, ids, 64)
    jgen, tgen = gens(sampler=sampler)
    lat = latents(64, n=2)
    jseen, tseen = [], []
    with jax_eager([lat]) as mp:
        spy_xattn_cache(mp, jpipeline, jseen)
        want = jpipe.txt2img_tgate(
            jnp.asarray(ctx), jgen, gate_frac=0.5, seed=7, decode=False,
            batch_size=2,
            region_biases=jpipe.encode_region(states, ids, 64, 64))
    with torch_draws(lat), pytest.MonkeyPatch.context() as mp:
        spy_xattn_cache(mp, tpipeline, tseen)
        got = tpipe.txt2img_tgate(
            torch.from_numpy(ctx), tgen, gate_frac=0.5, seed=7, decode=False,
            batch_size=2,
            region_biases=tpipe.encode_region(states, ids, 64, 64))
    assert_latents_close(got, want)
    (jxa,), (txa,) = jseen, tseen
    assert len(txa) == len(jxa)
    for g, w in zip(txa, jxa):
        assert tuple(g.shape) == w.shape and g.shape[0] == 2
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_tgate_gate1_is_txt2img_and_deterministic(pipes):
    """``gate_frac >= 1`` runs txt2img: the same draws, bit for bit. A gated
    run is deterministic, decodes to uint8 images, and differs from the
    plain run (tests/test_tgate.py)."""
    _, tpipe, ctx, _ = pipes
    _, gen = gens()
    c = torch.from_numpy(ctx)
    plain = tpipe.txt2img(c, gen, seed=3, decode=False)
    for frac in (1.0, 1.5):
        assert torch.equal(
            tpipe.txt2img_tgate(c, gen, gate_frac=frac, seed=3, decode=False),
            plain)
    a = tpipe.txt2img_tgate(c, gen, gate_frac=0.5, seed=3, decode=False)
    assert torch.equal(
        a, tpipe.txt2img_tgate(c, gen, gate_frac=0.5, seed=3, decode=False))
    assert not torch.allclose(a, plain)
    img = tpipe.txt2img_tgate(c, gen, gate_frac=0.5, seed=7,
                              uint8_output=True)
    assert img.shape == (1, 64, 64, 3) and img.dtype == torch.uint8


def test_tgate_no_cfg_and_region(pipes):
    """The map moves a gated run; with guidance off the frozen outputs are
    used as collected, without a pair average (tests/test_tgate.py)."""
    _, tpipe, ctx, ids = pipes
    _, gen = gens()
    c = torch.from_numpy(ctx)
    rb = tpipe.encode_region([two_masks(64)], ids, 64, 64)
    base = tpipe.txt2img_tgate(c, gen, gate_frac=0.5, seed=3, decode=False)
    mapped = tpipe.txt2img_tgate(c, gen, gate_frac=0.5, seed=3,
                                 region_biases=rb, decode=False)
    assert not torch.allclose(base, mapped)
    _, gen1 = gens(guidance_scale=1.0)
    out = tpipe.txt2img_tgate(c[1:], gen1, gate_frac=0.5, seed=3,
                              decode=False)
    assert out.shape == (1, 8, 8, 4) and torch.isfinite(out).all()
    assert not torch.allclose(out, tpipe.txt2img(c[1:], gen1, seed=3,
                                                 decode=False))


def test_tgate_rejects_unsupported_sampler(pipes):
    jpipe, tpipe, ctx, _ = pipes
    jgen, tgen = gens(sampler="dpmpp_2m_sde")
    with pytest.raises(ValueError, match="tgate") as j:
        jpipe.txt2img_tgate(jnp.asarray(ctx), jgen, gate_frac=0.5, seed=0)
    with pytest.raises(ValueError, match="tgate") as t:
        tpipe.txt2img_tgate(torch.from_numpy(ctx), tgen, gate_frac=0.5,
                            seed=0)
    assert str(t.value) == str(j.value)


def test_xattn_cache_needs_guidance_off(pipes):
    _, tpipe, ctx, _ = pipes
    with pytest.raises(ValueError, match="guidance off"):
        tpipeline.make_denoise_fn(
            tpipe.params, TTINY, torch.from_numpy(ctx), None,
            tpipe.log_sigma_table, 7.5, xattn_cache=())


# -- DeepCache ----------------------------------------------------------------

def test_deepcache_matches_jax(pipes):
    """Interval 3 with the map: full steps 0 and 3, reuse steps between; at
    batch 2 with CFG the cache holds the four interleaved rows of two
    prompts, each with its own context and map."""
    jpipe, tpipe, ctx, ids = pipes
    ctx, states, ids = cfg_batch(ctx, ids, 64)
    jgen, tgen = gens()
    lat = latents(64, 2, n=2)
    with jax_eager([lat]):
        want = jpipe.txt2img_deepcache(
            jnp.asarray(ctx), jgen, cache_interval=3, seed=7, decode=False,
            batch_size=2,
            region_biases=jpipe.encode_region(states, ids, 64, 64))
    with torch_draws(lat):
        got = tpipe.txt2img_deepcache(
            torch.from_numpy(ctx), tgen, cache_interval=3, seed=7,
            decode=False, batch_size=2,
            region_biases=tpipe.encode_region(states, ids, 64, 64))
    assert_latents_close(got, want)


@pytest.mark.parametrize("sampler", ["euler", "dpmpp_2m"])
def test_interval_one_matches_txt2img(pipes, sampler):
    """``cache_interval=1`` runs every step in full: the port's full
    DeepCache call is ``unet_apply``'s operations in the same order, so it
    equals txt2img bit for bit (the JAX package holds its own to 2e-4)."""
    _, tpipe, ctx, _ = pipes
    _, gen = gens(sampler=sampler)
    c = torch.from_numpy(ctx)
    assert torch.equal(
        tpipe.txt2img_deepcache(c, gen, cache_interval=1, seed=3,
                                decode=False),
        tpipe.txt2img(c, gen, seed=3, decode=False))


def test_interval_three_close_to_full(pipes):
    """Reuse steps approximate the full run (tests/test_deepcache.py's
    bound) and take the reuse path; the map moves the result."""
    _, tpipe, ctx, ids = pipes
    _, gen = gens()
    c = torch.from_numpy(ctx)
    full = tpipe.txt2img_deepcache(c, gen, cache_interval=1, seed=7,
                                   decode=False)
    fast = tpipe.txt2img_deepcache(c, gen, cache_interval=3, seed=7,
                                   decode=False)
    assert torch.isfinite(fast).all() and not torch.equal(fast, full)
    assert float((fast - full).norm() / full.norm()) < 0.5
    img = tpipe.txt2img_deepcache(c, gen, cache_interval=3, seed=7)
    assert img.shape == (1, 64, 64, 3) and torch.isfinite(img).all()
    rb = tpipe.encode_region([two_masks(64)], ids, 64, 64)
    mapped = tpipe.txt2img_deepcache(c, gen, cache_interval=2, seed=3,
                                     region_biases=rb, decode=False)
    assert not torch.allclose(
        mapped, tpipe.txt2img_deepcache(c, gen, cache_interval=2, seed=3,
                                        decode=False))


def test_deepcache_rejects_units_and_odd_solvers(pipes):
    jpipe, tpipe, ctx, _ = pipes
    jgen, tgen = gens(sampler="dpmpp_2m_sde")
    with pytest.raises(ValueError, match="deepcache supports") as j:
        jpipe.txt2img_deepcache(jnp.asarray(ctx), jgen, seed=0)
    with pytest.raises(ValueError, match="deepcache supports") as t:
        tpipe.txt2img_deepcache(torch.from_numpy(ctx), tgen, seed=0)
    assert str(t.value) == str(j.value)
    t2i = [np.zeros((2, 8 >> i, 8 >> i, c), np.float32)
           for i, c in enumerate(TTINY.unet.block_out_channels)]
    jgen, tgen = gens()
    with jax_eager([latents(64)]), pytest.raises(ValueError,
                                                 match="deepcache") as j:
        jpipe.txt2img_deepcache(jnp.asarray(ctx), jgen, seed=0,
                                extras=jpipeline.DenoiseExtras(
                                    t2i_residuals=tuple(map(jnp.asarray, t2i)),
                                    t2i_active=(1.0,) * 6))
    with pytest.raises(ValueError, match="deepcache") as t:
        tpipe.txt2img_deepcache(torch.from_numpy(ctx), tgen, seed=0,
                                extras=tpipeline.DenoiseExtras(
                                    t2i_residuals=tuple(map(torch.from_numpy,
                                                            t2i)),
                                    t2i_active=np.ones(6)))
    assert str(t.value) == str(j.value)


def test_deepcache_solvers_match_jax_on_toy_denoiser():
    """The port runs DeepCache through the plain solvers with the cache in a
    closure (``pipeline._step_cached``); the JAX package threads it through
    the carry of its own recurrences: a toy denoiser that reads and
    refreshes its cache."""
    sigmas = np.array([14.6, 6.0, 2.5, 1.0, 0.3, 0.0])
    x0 = np.random.default_rng(3).standard_normal((1, 4, 4, 4)).astype(
        np.float32) * 14.6
    use = np.array([0, 1, 1, 0, 1], np.float64)

    def make(xp, where):
        def den(x, s, cache, u):
            fresh = xp.tanh(x) * (0.5 + 0.1 * s)
            cache = where(u > 0.5, cache, fresh)
            return cache * 0.9 + 0.1 * fresh, cache
        return den

    for name in ("euler", "dpmpp_2m"):
        want = jsolvers.DEEPCACHE_SOLVERS[name](
            make(jnp, jnp.where), jnp.asarray(x0), sigmas,
            jnp.zeros_like(x0), use)
        denoise = tpipeline._step_cached(
            make(torch, lambda c, a, b: a if c else b),
            torch.zeros_like(torch.from_numpy(x0)), use)
        got = tsolvers.SOLVERS[name][0](denoise, torch.from_numpy(x0), sigmas)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert sorted(tsolvers.DEEPCACHE_SOLVERS) == sorted(
        jsolvers.DEEPCACHE_SOLVERS)


# -- bottleneck sampling ------------------------------------------------------

def test_bottleneck_matches_jax(pipes):
    """128^2 (latent 16, the middle phase at 8; at 64^2 it would round back
    to 8 and not change size), the map re-encoded at each size, the same
    initial latents and boundary noises; at batch 2 with CFG, one prompt's
    map for two images (num_images_per_prompt 2) beside a context of two
    prompts."""
    jpipe, tpipe, ctx, ids = pipes
    ctx, _, _ = cfg_batch(ctx, ids, 128)
    jgen, tgen = gens(128)
    rng = np.random.default_rng(4)
    lat, low, high = (rng.standard_normal((2,) + s).astype(np.float32)
                      for s in ((16, 16, 4), (8, 8, 4), (16, 16, 4)))
    state = ([two_masks(128)], ids, 2)
    with jax_eager([lat, low, high]):
        want = jpipe.txt2img_bottleneck(jnp.asarray(ctx), jgen, low_scale=0.5,
                                        seed=3, decode=False, batch_size=2,
                                        region_state=state)
    with torch_draws(lat, (low, high)):
        got = tpipe.txt2img_bottleneck(torch.from_numpy(ctx), tgen,
                                       low_scale=0.5, seed=3, decode=False,
                                       batch_size=2, region_state=state)
    assert_latents_close(got, want)


def test_bottleneck_draws_are_per_sample():
    """Each sample's generator: initial latents (``initial_noise``'s draw),
    then the low-resolution boundary noise, then the full-resolution one."""
    lat, low, full = tpipeline.bottleneck_draws([5, 9], (2, 3, 4), (4, 6, 4),
                                                torch.device("cpu"))
    assert low.shape == (2, 2, 3, 4) and full.shape == (2, 4, 6, 4)
    assert torch.equal(lat, tpipeline.initial_noise([5, 9], (4, 6, 4), "cpu"))
    g = torch.Generator().manual_seed(9)
    assert torch.equal(torch.randn((4, 6, 4), generator=g), lat[1])
    assert torch.equal(torch.randn((2, 3, 4), generator=g), low[1])
    assert torch.equal(torch.randn((4, 6, 4), generator=g), full[1])


def test_bottleneck_end_to_end_and_region(pipes):
    """Deterministic, differs from the plain run, decodes at full size; the
    map moves it; with guidance off the re-encoded map is not CFG-doubled
    (tests/test_bottleneck.py)."""
    _, tpipe, ctx, ids = pipes
    _, gen = gens(128)
    c = torch.from_numpy(ctx)
    a = tpipe.txt2img_bottleneck(c, gen, low_scale=0.5, seed=3, decode=False)
    assert torch.equal(a, tpipe.txt2img_bottleneck(c, gen, low_scale=0.5,
                                                   seed=3, decode=False))
    assert not torch.allclose(a, tpipe.txt2img(c, gen, seed=3, decode=False))
    rs = ([two_masks(128)], ids, 1)
    mapped = tpipe.txt2img_bottleneck(c, gen, low_scale=0.5, seed=3,
                                      decode=False, region_state=rs)
    assert not torch.allclose(a, mapped)
    img = tpipe.txt2img_bottleneck(c, gen, low_scale=0.5, seed=7)
    assert img.shape == (1, 128, 128, 3) and torch.isfinite(img).all()
    _, gen1 = gens(128, guidance_scale=1.0)
    out = tpipe.txt2img_bottleneck(c[1:], gen1, low_scale=0.5, seed=3,
                                   decode=False, region_state=rs)
    assert out.shape == (1, 16, 16, 4) and torch.isfinite(out).all()


def test_bottleneck_rejections(pipes):
    """Each with the JAX package's message."""
    jpipe, tpipe, ctx, _ = pipes
    t2i = [np.zeros((2, 16 >> i, 16 >> i, c), np.float32)
           for i, c in enumerate(TTINY.unet.block_out_channels)]
    cases = [
        ({"sampler": "dpmpp_2m_sde"}, {}, {}, "bottleneck"),
        ({}, {"extras": jpipeline.DenoiseExtras(
            t2i_residuals=tuple(map(jnp.asarray, t2i)),
            t2i_active=(1.0,) * 6)},
         {"extras": tpipeline.DenoiseExtras(
             t2i_residuals=tuple(map(torch.from_numpy, t2i)),
             t2i_active=np.ones(6))}, "resolution-bound"),
        ({}, {"region_biases": tuple(jnp.zeros((2, 16, 77))
                                     for _ in range(4))},
         {"region_biases": tuple(torch.zeros(2, 16, 77) for _ in range(4))},
         "region_state"),
        ({}, {"mid_frac": (0.9, 0.1)}, {"mid_frac": (0.9, 0.1)}, "middle"),
    ]
    for gen_kw, jkw, tkw, match in cases:
        jgen, tgen = gens(128, **gen_kw)
        with pytest.raises(ValueError, match=match) as j:
            jpipe.txt2img_bottleneck(jnp.asarray(ctx), jgen, seed=0, **jkw)
        with pytest.raises(ValueError, match=match) as t:
            tpipe.txt2img_bottleneck(torch.from_numpy(ctx), tgen, seed=0,
                                     **tkw)
        assert str(t.value) == str(j.value)


# -- cfg-tail -----------------------------------------------------------------

def test_cfg_tail_matches_jax(pipes):
    """The CFG segment paused at the cutoff, resumed cond-only on the map's
    cond half (6 steps, tail 0.3: 2 steps without CFG), at batch 2 with CFG:
    the cond half of [u0, u1, c0, c1] and of the map's rows."""
    jpipe, tpipe, ctx, ids = pipes
    ctx, states, ids = cfg_batch(ctx, ids, 64)
    jgen, tgen = gens()
    lat = latents(64, 5, n=2)
    with jax_eager([lat, lat]):  # drawn by the pause and by the resume
        want = jpipe.txt2img_cfg_tail(
            jnp.asarray(ctx), jgen, 0.3, seed=7, decode=False, batch_size=2,
            region_biases=jpipe.encode_region(states, ids, 64, 64))
    with torch_draws(lat):
        got = tpipe.txt2img_cfg_tail(
            torch.from_numpy(ctx), tgen, 0.3, seed=7, decode=False,
            batch_size=2,
            region_biases=tpipe.encode_region(states, ids, 64, 64))
    assert_latents_close(got, want)


def test_cfg_tail_identities_and_rejection(pipes):
    """``tail_frac`` 0 (and guidance off) is txt2img bit for bit, and so is
    a pause and resume with guidance kept; a tail differs. A solver that
    cannot run in chunks raises the JAX package's error."""
    jpipe, tpipe, ctx, _ = pipes
    _, gen = gens()
    c = torch.from_numpy(ctx)
    plain = tpipe.txt2img(c, gen, seed=3, decode=False)
    assert torch.equal(tpipe.txt2img_cfg_tail(c, gen, 0.0, seed=3,
                                              decode=False), plain)
    tail = tpipe.txt2img_cfg_tail(c, gen, 0.3, seed=3, decode=False)
    assert not torch.allclose(tail, plain)
    _, gen1 = gens(guidance_scale=1.0)
    assert torch.equal(
        tpipe.txt2img_cfg_tail(c[1:], gen1, 0.5, seed=3, decode=False),
        tpipe.txt2img(c[1:], gen1, seed=3, decode=False))
    jgen, tgen = gens(sampler="dpm_fast")
    with pytest.raises(ValueError) as j:
        jpipe.txt2img_cfg_tail(jnp.asarray(ctx), jgen, 0.5, seed=0)
    with pytest.raises(ValueError) as t:
        tpipe.txt2img_cfg_tail(c, tgen, 0.5, seed=0)
    assert str(t.value) == str(j.value)


def test_cond_half_conditioning_matches_jax():
    rng = np.random.default_rng(6)
    ctx = rng.standard_normal((4, 3, 2)).astype(np.float32)
    rb = tuple(rng.standard_normal((4, 5, 3)).astype(np.float32)
               for _ in range(2))
    arrays = {k: rng.standard_normal((4, 2, 2)).astype(np.float32)
              for k in ("img", "t2i", "tok", "mask", "extra", "inpaint")}

    def extras(pkg, conv, guess):
        return pkg.DenoiseExtras(
            controlnet_images=[conv(arrays["img"])], controlnet_guess=guess,
            t2i_residuals=(conv(arrays["t2i"]),),
            ip_tokens=(conv(arrays["tok"]),),
            ip_masks=(conv(arrays["mask"]), None),
            extra_channels=conv(arrays["extra"]),
            inpaint_mask=conv(arrays["inpaint"]))

    for guess in (False, True):
        j = jpipeline.cond_half_conditioning(
            jnp.asarray(ctx), tuple(map(jnp.asarray, rb)),
            extras(jpipeline, jnp.asarray, guess))
        t = tpipeline.cond_half_conditioning(
            torch.from_numpy(ctx), tuple(map(torch.from_numpy, rb)),
            extras(tpipeline, torch.from_numpy, guess))
        jl = jax.tree_util.tree_leaves(
            (j[0], j[1], [getattr(j[2], f.name) for f in
                          dataclasses.fields(j[2])]))
        tl = [x for x in jax.tree_util.tree_leaves(
            (t[0], t[1], [getattr(t[2], f.name) for f in
                          dataclasses.fields(t[2])]))]
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


# -- inference() --------------------------------------------------------------

@pytest.fixture(scope="module")
def manager():
    m = tapi.ModelManager(dtype=torch.float32, device="cpu")
    m.register_random("tiny", TTINY, seed=0)
    return m


def _mask():
    m = np.zeros((64, 64), np.float32)
    m[:, :32] = 1.0
    return m


@pytest.mark.parametrize("mode,value,sampler,side", [
    ("cfg_tail_frac", 0.5, "Euler Karras", 64),
    ("deepcache_interval", 2, "Euler Karras", 64),
    ("bottleneck_low_scale", 0.5, "Euler Karras", 128),
    ("tgate_gate_frac", 0.5, "Euler", 64)])
def test_inference_speed_mode(manager, mode, value, sampler, side):
    """Each mode through ``inference()`` (tests/test_app_modes.py): uint8
    images of the request's size from the pipeline method it routes to,
    another image than the plain request's; it refuses hires and latent
    previews, and a second mode."""
    kwargs = dict(model="tiny", sampler=sampler, steps=6, width=side,
                  height=side, seed=11, encoding_mode="short",
                  dtype=torch.float32,
                  region_state=region_ui.build_region_state(
                      ["red cat"], [np.kron(_mask(), np.ones((side // 64,
                                                              side // 64)))]))
    base = tapi.inference(manager, prompt="a red cat", **kwargs)
    fast = tapi.inference(manager, prompt="a red cat", **{mode: value},
                          **kwargs)
    assert fast["images"].shape == base["images"].shape == (1, side, side, 3)
    assert fast["images"].dtype == np.uint8
    assert np.any(fast["images"] != base["images"])
    for other in ({"hires_scale": 2.0}, {"latent_preview": True}):
        with pytest.raises(ValueError, match=mode):
            tapi.inference(manager, prompt="a red cat", **{mode: value},
                           **other, **kwargs)
    second = "tgate_gate_frac" if mode != "tgate_gate_frac" else \
        "deepcache_interval"
    with pytest.raises(ValueError):
        tapi.inference(manager, prompt="a red cat", **{mode: value},
                       **{second: 2 if second == "deepcache_interval" else
                          0.5}, **kwargs)


def test_inference_tgate_equals_pipeline(manager):
    """``inference(tgate_gate_frac=...)`` is ``txt2img_tgate`` then the
    uint8 copy, bit for bit."""
    cfg, params, tok = manager.get("tiny")
    pipe = tpipeline.StableDiffusionTorch(cfg, params, tokenizer=tok,
                                          device="cpu")
    out = tapi.inference(manager, PROMPT, "tiny", sampler="Euler", steps=6,
                         width=64, height=64, seed=5, tgate_gate_frac=0.5,
                         encoding_mode="short", dtype=torch.float32)
    ctx, _ = pipe.encode_prompt([PROMPT], [tcfg.DEFAULT_NEGATIVE_PROMPT],
                                clip_skip=2)
    spec = tregistry.resolve_sampler("Euler")
    gen = tcfg.GenerationConfig(height=64, width=64, num_inference_steps=6,
                                sampler=spec.solver, schedule=spec.schedule,
                                dtype=torch.float32)
    want = pipe.txt2img_tgate(ctx, gen, 0.5, seed=5, uint8_output=True)
    np.testing.assert_array_equal(out["images"], want.numpy())


def test_speed_modes_refuse_init_image_and_chunks(manager):
    """The modes are txt2img-only and run in one piece: an init image or
    ``cancel_check_steps`` raises before sampling (tests/test_app_modes.py;
    tests/test_torch_app.py's routing table holds the messages to the JAX
    package's)."""
    init = (np.random.RandomState(0).rand(64, 64, 3) * 255).astype(np.uint8)
    kwargs = dict(model="tiny", sampler="Euler", steps=4, width=64,
                  height=64, encoding_mode="short", dtype=torch.float32)
    for turbo in ({"bottleneck_low_scale": 0.5}, {"deepcache_interval": 2},
                  {"cfg_tail_frac": 0.5}, {"tgate_gate_frac": 0.5}):
        for extra, match in (({"init_image": init}, "init_image"),
                             ({"cancel_check_steps": 2},
                              "cancel_check_steps")):
            with pytest.raises(ValueError, match=match):
                tapi.inference(manager, prompt="a cat", **turbo, **extra,
                               **kwargs)
