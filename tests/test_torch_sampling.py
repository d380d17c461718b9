"""The port's pipeline with every sampler: the tiny UNet against
``StableDiffusionTPU`` for three solvers (an SDE solver, restart, and an
ancestral one as the hires pass's override, with both passes' latent
histories), chunked
sampling with pause and resume, the seeded solver noise, and every name of
the app's sampler table, on the CPU.

Parity tests run both packages in fp32 at 64x64 from the same latents, with
each side's solver noise (and the hires pass's img2img noise) replaced by
the same numpy draw. Tolerance as the slice test's in
tests/test_torch_pipeline.py: 1e-4 on fp32 pixels. Latent histories (the
random UNet's latents reach |x| ~ 30) within 1e-5 of their max abs, as the
solvers' in tests/test_torch_solvers.py. Parameters
come from the port's own init, converted to the JAX layout (the JAX init
takes tens of seconds on the CPU).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.pipeline import pipeline as jpipeline
from diffusionspatialcontrol_tpu.pipeline.pipeline import StableDiffusionTPU
from diffusionspatialcontrol_tpu.samplers import solvers as jsolvers
from diffusionspatialcontrol_tpu.text import tokenizer as jtok
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch import registry as tregistry
from diffusionspatialcontrol_tpu_torch.models import factory as tfactory
from diffusionspatialcontrol_tpu_torch.pipeline import pipeline as tpipeline
from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
    ChunkedPause,
    StableDiffusionTorch,
    initial_noise,
)
from diffusionspatialcontrol_tpu_torch.samplers import brownian
from diffusionspatialcontrol_tpu_torch.samplers import solvers as tsolvers
from diffusionspatialcontrol_tpu_torch.text import tokenizer as ttok

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

PROMPT = "a red cat sitting on a wooden bench, a blue bird flying"
NEG = "bad quality, low quality, jpeg artifact, cropped"


def _to_jax(tree):
    """The port's parameter tree in the JAX package's layout (the inverse of
    ``convert.from_jax.params_from_jax``)."""
    if isinstance(tree, dict):
        return {k: (_leaf(v, k) if isinstance(v, torch.Tensor)
                    else _to_jax(v)) for k, v in tree.items()}
    return [_to_jax(v) if not isinstance(v, torch.Tensor) else _leaf(v, "")
            for v in tree]


def _leaf(t, name):
    if name == "kernel" and t.dim() == 4:
        t = t.permute(2, 3, 1, 0)
    elif name == "kernel" and t.dim() == 2:
        t = t.t()
    return jnp.asarray(t.contiguous().numpy())


@pytest.fixture(scope="module")
def pipes():
    tp = tfactory.init_pipeline_params(0, tcfg.tiny_config(), torch.float32,
                                       device="cpu")
    jpipe = StableDiffusionTPU(jcfg.tiny_config(), _to_jax(tp),
                               tokenizer=jtok.HashTokenizer(),
                               attn_impl="xla")
    tpipe = StableDiffusionTorch(tcfg.tiny_config(), tp,
                                 tokenizer=ttok.HashTokenizer(),
                                 device="cpu")
    return jpipe, tpipe


def _masks(h, w):
    m1 = np.zeros((h, w), np.float32)
    m1[:, : w // 2] = 1.0
    m2 = np.zeros((h, w), np.float32)
    m2[: h // 3, w // 2:] = 1.0
    return {"red cat": {"mask": m1, "weight": 0.8, "mask_outsides": 0.2},
            "blue bird": {"mask": m2, "weight": 0.7, "mask_outsides": 0.1}}


def _table(name, sigmas, shape):
    """The same noise table for both packages: (steps, draws, *shape), from
    a generator keyed by its size."""
    _, draws, _ = jsolvers.SOLVERS[name]
    if draws == 0:
        return None
    n = jsolvers.scan_length(name, sigmas)
    rng = np.random.default_rng(n * 1000 + shape[1])
    return rng.standard_normal((n, draws) + tuple(shape)).astype(np.float32)


def _patch_noise(monkeypatch, jpipe, tpipe):
    def jnoise(rng, sigmas, shape, name):
        t = _table(name, sigmas, shape)
        return None if t is None else jnp.asarray(t)

    def tnoise(seeds, sigmas, shape, name):
        t = _table(name, sigmas, shape)
        return None if t is None else torch.from_numpy(t)

    monkeypatch.setattr(jpipe, "_solver_noise", jnoise)
    monkeypatch.setattr(tpipe, "_solver_noise", tnoise)
    # img2img's noise (the hires pass)
    img_noise = np.random.default_rng(11).standard_normal(
        (1, 16, 16, 4)).astype(np.float32)
    monkeypatch.setattr(
        jpipeline, "_keyed_normal",
        lambda k, shape, dtype=jnp.float32: jnp.asarray(img_noise))
    monkeypatch.setattr(tpipeline, "initial_noise",
                        lambda seeds, shape, device: torch.from_numpy(
                            img_noise))


def _close(got, want, latents=False):
    want = np.asarray(want)
    assert got.shape == want.shape and torch.isfinite(got).all()
    atol = 1e-5 * float(np.abs(want).max()) if latents else 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=0 if latents else
                               1e-4, atol=atol)


@pytest.mark.parametrize("name", ["dpmpp_2m_sde", "restart"])
def test_txt2img_solver_matches_jax(pipes, monkeypatch, name):
    """An SDE solver and restart, 4 steps; the map makes every
    cross-attention K1's. The ancestral solver (Euler a) is the hires pass
    of the next test. Restart's plan restarts from 20 steps on; that plan
    is held against JAX's on the closed-form denoiser
    (tests/test_torch_solvers.py), as a tiny-UNet run of 20 steps costs
    minutes here."""
    jpipe, tpipe = pipes
    _patch_noise(monkeypatch, jpipe, tpipe)
    lat = np.random.default_rng(1).standard_normal((1, 8, 8, 4)).astype(
        np.float32)
    out = []
    for pipe, gen_cls, dt, arr in (
            (jpipe, jcfg.GenerationConfig, jnp.float32, jnp.asarray),
            (tpipe, tcfg.GenerationConfig, torch.float32, torch.from_numpy)):
        ctx, ids = pipe.encode_prompt([PROMPT], [NEG])
        gen = gen_cls(height=64, width=64, num_inference_steps=4,
                      sampler=name, schedule="karras", eta=0.8, dtype=dt)
        out.append(pipe.txt2img(
            ctx, gen, latents=arr(lat),
            region_biases=pipe.encode_region([_masks(64, 64)], ids, 64, 64)))
    _close(out[1], out[0])


def test_hires_sampler_override_and_history_match_jax(pipes, monkeypatch):
    """Base pass DPM++ 2M on Karras sigmas, hires pass Euler a on the
    exponential schedule, with both passes' histories."""
    jpipe, tpipe = pipes
    _patch_noise(monkeypatch, jpipe, tpipe)
    lat = np.random.default_rng(2).standard_normal((1, 8, 8, 4)).astype(
        np.float32)
    out = []
    for pipe, gen_cls, dt, arr in (
            (jpipe, jcfg.GenerationConfig, jnp.float32, jnp.asarray),
            (tpipe, tcfg.GenerationConfig, torch.float32, torch.from_numpy)):
        ctx, _ = pipe.encode_prompt([PROMPT], [NEG])
        gen = gen_cls(height=64, width=64, num_inference_steps=4, dtype=dt)
        out.append(pipe.txt2img(
            ctx, gen, seed=3, latents=arr(lat), return_history=True,
            hires={"scale": 2.0, "strength": 0.6, "steps": 5,
                   "sampler": "euler_ancestral", "schedule": "exponential"}))
    (want, (wb, wh)), (got, (gb, gh)) = out
    assert got.shape == (1, 128, 128, 3)
    assert gb.shape == (4, 1, 8, 8, 4) and gh.shape == (3, 1, 16, 16, 4)
    _close(got, want)
    _close(gb, wb, latents=True)
    _close(gh, wh, latents=True)


def _chunk_pipe():
    cfg = tcfg.tiny_config()
    tp = tfactory.init_pipeline_params(2, cfg, torch.float32, device="cpu")
    pipe = StableDiffusionTorch(cfg, tp, tokenizer=ttok.HashTokenizer(),
                                device="cpu")
    ctx, _ = pipe.encode_prompt([PROMPT], [NEG])
    return pipe, ctx


@pytest.fixture(scope="module")
def chunk_pipe():
    return _chunk_pipe()


def _stand_in(calls=None):
    """A make_denoise_fn whose denoiser is a cheap smooth function of x and
    sigma, for tests of the pipeline's plumbing (the solvers' arithmetic is
    held against JAX in tests/test_torch_solvers.py)."""
    def make(*args, **kwargs):
        def denoise(x, sigma):
            if calls is not None:
                calls.append(float(sigma))
            return x / (1.0 + sigma * sigma) + 0.05 * x / (1.0 + x * x)
        return denoise
    return make


def _pause_resume(pipe, ctx, name):
    """Chunks of 2 steps, paused after the first chunk and resumed, against
    txt2img's latents; on_chunk sees every boundary."""
    gen = tcfg.GenerationConfig(height=64, width=64, num_inference_steps=4,
                                sampler=name, dtype=torch.float32)
    want = pipe.txt2img(ctx, gen, seed=4, decode=False)
    seen = []

    def on_chunk(done, total):
        seen.append((done, total))
        return done != 2  # pause once, after the first chunk

    pause = pipe.sample_chunked(ctx, gen, seed=4, chunk_steps=2,
                                on_chunk=on_chunk, decode=False)
    assert isinstance(pause, ChunkedPause) and pause.pos == 2
    got = pipe.sample_chunked(ctx, gen, seed=4, chunk_steps=2,
                              on_chunk=on_chunk, decode=False, resume=pause)
    assert torch.equal(got, want)
    n = pause.n_total
    assert seen == [(p, n) for p in range(2, n + 1, 2)] + (
        [(n, n)] if n % 2 else [])


@pytest.mark.parametrize("name", sorted(tsolvers.CHUNKABLE))
def test_sample_chunked_pause_resume_is_bitwise(chunk_pipe, monkeypatch,
                                                name):
    """Every chunkable solver through sample_chunked, on the stand-in
    denoiser: bitwise equal to txt2img, paused and resumed."""
    monkeypatch.setattr(tpipeline, "make_denoise_fn", _stand_in())
    _pause_resume(*chunk_pipe, name)


def test_sample_chunked_pause_resume_on_the_unet_is_bitwise(chunk_pipe):
    _pause_resume(*chunk_pipe, "dpmpp_2m_sde")


def test_sample_chunked_refuses_cancels_and_checks(chunk_pipe):
    pipe, ctx = chunk_pipe
    gen = tcfg.GenerationConfig(height=64, width=64, num_inference_steps=4,
                                dtype=torch.float32)
    for name in ("dpm_fast", "dpm_adaptive"):
        with pytest.raises(ValueError):
            pipe.sample_chunked(ctx, dataclasses.replace(gen, sampler=name))

    def cancel(done, total):
        raise TimeoutError("cancelled")

    with pytest.raises(TimeoutError):
        pipe.sample_chunked(ctx, gen, chunk_steps=1, on_chunk=cancel)
    pause = pipe.sample_chunked(ctx, gen, chunk_steps=1, decode=False,
                                on_chunk=lambda d, t: False)
    with pytest.raises(ValueError):
        pipe.sample_chunked(ctx, dataclasses.replace(
            gen, num_inference_steps=6), resume=pause)
    img = pipe.sample_chunked(ctx, gen, chunk_steps=3, uint8_output=True)
    assert img.shape == (1, 64, 64, 3) and img.dtype == torch.uint8


def test_solver_noise_is_per_sample_and_apart_from_the_latents():
    seeds, shape = [5, 9], (4, 4, 4)
    both = brownian.step_noise(seeds, 3, 2, shape, "cpu")
    assert both.shape == (3, 2, 2) + shape
    for i, s in enumerate(seeds):
        one = brownian.step_noise([s], 3, 2, shape, "cpu")
        assert torch.equal(both[:, :, i:i + 1], one)
    lat = initial_noise([5], shape, torch.device("cpu"))
    assert not torch.isclose(both[0, 0, 0], lat[0]).any()


def test_solver_noise_ignores_whether_latents_were_passed(chunk_pipe):
    pipe, ctx = chunk_pipe
    gen = tcfg.GenerationConfig(height=64, width=64, num_inference_steps=3,
                                sampler="euler_ancestral",
                                dtype=torch.float32)
    drawn = pipe.txt2img(ctx, gen, seed=6, decode=False)
    lat = initial_noise([6], (8, 8, 4), torch.device("cpu"))
    passed = pipe.txt2img(ctx, gen, seed=6, latents=lat, decode=False)
    assert torch.equal(drawn, passed)
    other = pipe.txt2img(ctx, gen, seed=7, latents=lat, decode=False)
    assert not torch.equal(drawn, other)


def test_every_sampler_name_runs_through_the_pipeline(chunk_pipe,
                                                      monkeypatch):
    """All 82 names of the app's table, each as (solver, schedule), through
    txt2img's schedule, noise and option plumbing, on the stand-in
    denoiser."""
    pipe, ctx = chunk_pipe
    calls = []
    monkeypatch.setattr(tpipeline, "make_denoise_fn", _stand_in(calls))
    for name, spec in tregistry.SAMPLERS.items():
        gen = tcfg.GenerationConfig(height=64, width=64,
                                    num_inference_steps=5,
                                    sampler=spec.solver,
                                    schedule=spec.schedule,
                                    dtype=torch.float32)
        calls.clear()
        x = pipe.txt2img(ctx, gen, seed=1, decode=False)
        assert x.shape == (1, 8, 8, 4) and torch.isfinite(x).all(), name
        assert len(calls) >= 5, name
        sigmas, _ = pipe._schedule(gen)
        assert calls[0] == pytest.approx(float(sigmas[0]), rel=1e-6), name
