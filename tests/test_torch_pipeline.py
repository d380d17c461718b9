"""The PyTorch port's text front end, region map, schedule, solver, latent
resize and the whole txt2img and hires slices against the JAX package on
the CPU.

The slice test runs tiny-config txt2img in fp32 on both packages (JAX with
``attn_impl="xla"``, the port on its kernel path, i.e. the kernels' plain
versions on CPU tensors) at 64x64, 4 DPM++ 2M steps, CFG 7.5 and a
two-phrase region map, from the same injected latents. Tolerance: the fp32
images agree to 1e-4 and the uint8 images within +-1 (a value that lands on
a rounding boundary may round either way). The hires test adds a 2x latent
upscale and img2img at 128x128, with the hires pass's noise patched to the
same numpy draw on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.models import factory as jfactory
from diffusionspatialcontrol_tpu.ops import region_map as jregion
from diffusionspatialcontrol_tpu.ops import resize as jresize
from diffusionspatialcontrol_tpu.pipeline import pipeline as jpipeline
from diffusionspatialcontrol_tpu.pipeline.pipeline import StableDiffusionTPU
from diffusionspatialcontrol_tpu.samplers import schedules as jsched
from diffusionspatialcontrol_tpu.samplers import solvers as jsolvers
from diffusionspatialcontrol_tpu.text import tokenizer as jtok
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.convert.from_jax import params_from_jax
from diffusionspatialcontrol_tpu_torch.models import factory as tfactory
from diffusionspatialcontrol_tpu_torch.ops import region_map as tregion
from diffusionspatialcontrol_tpu_torch.ops import resize as tresize
from diffusionspatialcontrol_tpu_torch.pipeline import pipeline as tpipeline
from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
    StableDiffusionTorch,
    initial_noise,
)
from diffusionspatialcontrol_tpu_torch.samplers import schedules as tsched
from diffusionspatialcontrol_tpu_torch.samplers import solvers as tsolvers
from diffusionspatialcontrol_tpu_torch.text import tokenizer as ttok
from tests.test_torch_controlnet import to_jax

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

PROMPT = "a red cat sitting on a wooden bench, a blue bird flying"
NEG = "bad quality, low quality, jpeg artifact, cropped"


def _two_masks(h, w):
    m1 = np.zeros((h, w), np.float32)
    m1[:, : w // 2] = 1.0
    m2 = np.zeros((h, w), np.float32)
    m2[: h // 3, w // 2:] = 1.0
    return {"red cat": {"mask": m1, "weight": 0.8, "mask_outsides": 0.2},
            "blue bird": {"mask": m2, "weight": 0.7, "mask_outsides": 0.1}}


@pytest.fixture(scope="module")
def params():
    """The tiny pipeline's weights in both packages' layouts, from the
    port's init (seed 0; the JAX init's tree, shapes and bounds, which
    ``test_init_pipeline_params_matches_converted_tree`` holds it to). The
    JAX package's own init compiles each of its random ops: ~40 s of a
    worker."""
    tp = tfactory.init_pipeline_params(0, tcfg.tiny_config(), torch.float32,
                                       device="cpu")
    return to_jax(tp), tp


@pytest.fixture(scope="module")
def jax_init_tree():
    """The tree of the JAX package's ``init_pipeline_params`` at the tiny
    config with zeros for values (its shapes by ``jax.eval_shape``, which
    compiles nothing)."""
    shapes = jax.eval_shape(lambda: jfactory.init_pipeline_params(
        jax.random.PRNGKey(0), jcfg.tiny_config(), jnp.float32))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


@pytest.mark.parametrize("text", [
    PROMPT, NEG, "  Mixed   CASE,, commas ,and   spaces ", "", "é ünïcode"])
def test_hash_tokenizer_ids_match_jax(text):
    j, t = jtok.HashTokenizer(), ttok.HashTokenizer()
    for kw in ({}, {"add_special_tokens": False},
               {"truncation": True, "max_length": 5}):
        assert t.encode(text, **kw) == j.encode(text, **kw)


def test_clip_tokenizer_ids_match_jax():
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1, ",</w>": 2}
    chars = sorted(set("abcdefghijklmnopqrstuvwxyz"))
    for c in chars:
        vocab.setdefault(c, len(vocab))
        vocab.setdefault(c + "</w>", len(vocab))
    merges = [("c", "a"), ("ca", "t</w>"), ("r", "e"), ("re", "d</w>")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    j = jtok.CLIPTokenizer(vocab, merges)
    t = ttok.CLIPTokenizer(vocab, merges)
    for text in ("a red cat, red", "cat  cats", "xyz"):
        assert t.encode(text) == j.encode(text)


def test_encode_region_state_512_matches_jax():
    """A 512^2 two-phrase map at all four levels; the resize must
    antialias like jax.image.resize or pixels flip at ratios 8 and 16."""
    tok = jtok.HashTokenizer()
    ids = [(tok.encode(PROMPT) + [tok.pad_token_id] * 77)[:77]]
    state = _two_masks(512, 512)

    def phrase(p):
        return tok.encode(p, add_special_tokens=False)

    want = jregion.encode_region_state([state], ids, phrase, height=512,
                                       width=512)
    got = tregion.encode_region_state([state], ids, phrase, height=512,
                                      width=512)
    assert len(got) == 4
    for r, a, b in zip(tregion.LEVEL_RATIOS, want, got):
        assert b.shape == (2, (512 // r) ** 2, 77), r
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6, err_msg=f"ratio {r}")
    assert float(got[0].abs().max()) > 0


@pytest.mark.parametrize("steps", [4, 25])
def test_karras_sigmas_match_jax(steps):
    for cfg in (jcfg.sd15_config(), jcfg.tiny_config()):
        want = jsched.get_sigmas(cfg, steps, "karras")
        got = tsched.get_sigmas(tcfg.sd15_config(), steps, "karras")
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tsched.ddpm_sigma_table(tcfg.sd15_config()),
        jsched.ddpm_sigma_table(jcfg.sd15_config()))


def test_sample_dpmpp_2m_matches_jax_on_toy_denoiser():
    """A smooth nonlinear toy denoiser exercises the multistep update, its
    first-step and last-step (sigma_next = 0) branches."""
    sigmas = jsched.get_sigmas(jcfg.sd15_config(), 10, "karras")
    x0 = np.random.default_rng(3).standard_normal((2, 4, 4, 4)).astype(
        np.float32) * float(sigmas[0])

    def jden(x, s):
        return jnp.tanh(x) * (0.5 + 0.1 * s)

    def tden(x, s):
        return torch.tanh(x) * (0.5 + 0.1 * s)

    want = np.asarray(jsolvers.sample_dpmpp_2m(jden, jnp.asarray(x0), sigmas))
    got = tsolvers.sample_dpmpp_2m(tden, torch.from_numpy(x0), sigmas)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_params_from_jax_keeps_tree_and_shapes(jax_init_tree):
    jp = jax_init_tree
    tp = params_from_jax(jp, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) > 300
    for path, leaf in jleaves:
        node = tp
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        name = getattr(path[-1], "key", None)
        shape = tuple(leaf.shape)
        if name == "kernel" and len(shape) == 4:
            shape = (shape[3], shape[2], shape[0], shape[1])
        elif name == "kernel" and len(shape) == 2:
            shape = shape[::-1]
        assert tuple(node.shape) == shape, jax.tree_util.keystr(path)


def test_init_pipeline_params_matches_converted_tree(jax_init_tree):
    """The port's own random init has the converted tree's structure,
    shapes and dtype, the JAX init's bounds, and finite values."""
    conv = params_from_jax(jax_init_tree, device="cpu")
    own = tfactory.init_pipeline_params(0, tcfg.tiny_config(), torch.float32,
                                        device="cpu")

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            assert a.shape == b.shape and a.dtype == b.dtype, path
            assert torch.isfinite(a).all(), path

    walk(own, conv)
    k = own["unet"]["conv_in"]["kernel"]  # fan_in 4*3*3: U(+-1/6)
    assert 0.1 < float(k.abs().max()) <= 1 / 6
    assert float(own["unet"]["conv_in"]["bias"].abs().max()) == 0.0


def test_txt2img_slice_matches_jax(params):
    jp, tp = params
    jpipe = StableDiffusionTPU(jcfg.tiny_config(), jp,
                               tokenizer=jtok.HashTokenizer(),
                               attn_impl="xla")
    tpipe = StableDiffusionTorch(tcfg.tiny_config(), tp,
                                 tokenizer=ttok.HashTokenizer(),
                                 device="cpu")
    jctx, jids = jpipe.encode_prompt([PROMPT], [NEG])
    tctx, tids = tpipe.encode_prompt([PROMPT], [NEG])
    assert tids == [[int(i) for i in r] for r in jids]
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), rtol=1e-4,
                               atol=1e-5)
    state = _two_masks(64, 64)
    jb = jpipe.encode_region([state], jids, 64, 64)
    tb = tpipe.encode_region([state], tids, 64, 64)
    lat = np.random.default_rng(0).standard_normal((1, 8, 8, 4)).astype(
        np.float32)
    jgen = jcfg.GenerationConfig(height=64, width=64, num_inference_steps=4,
                                 dtype=jnp.float32)
    tgen = tcfg.GenerationConfig(height=64, width=64, num_inference_steps=4,
                                 dtype=torch.float32)
    want = np.asarray(jpipe.txt2img(jctx, jgen, latents=jnp.asarray(lat),
                                    region_biases=jb))
    got = tpipe.txt2img(tctx, tgen, latents=torch.from_numpy(lat),
                        region_biases=tb)
    assert got.shape == (1, 64, 64, 3) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    want_u8 = np.round(np.clip(want * 0.5 + 0.5, 0, 1) * 255).astype(np.uint8)
    got_u8 = tpipe.to_uint8(got).numpy()
    assert got_u8.dtype == np.uint8
    assert np.abs(got_u8.astype(int) - want_u8.astype(int)).max() <= 1


@pytest.mark.parametrize("name", tresize.UPSCALE_MODES)
def test_resize_latents_matches_jax(name):
    """Every hires upscale mode at 2x (the hires default) and at 1.5x, to
    fp32 rounding: the port uses jax.image's own weights."""
    mode, antialias = tresize.parse_upscale_mode(name)
    assert (mode, antialias) == jresize.parse_upscale_mode(name)
    x = np.random.default_rng(4).standard_normal((2, 8, 12, 4)).astype(
        np.float32)
    for new_h, new_w in ((16, 24), (12, 18)):
        want = np.asarray(jresize.resize_latents(
            jnp.asarray(x), new_h, new_w, mode=mode, antialias=antialias))
        got = tresize.resize_latents(torch.from_numpy(x), new_h, new_w,
                                     mode=mode, antialias=antialias)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-6)


def test_hires_slice_matches_jax(params, monkeypatch):
    """txt2img(hires=...) 64^2 -> 128^2 with the region map re-encoded at
    the target size: 4 base steps, then img2img at strength 0.6 (2 steps)."""
    jp, tp = params
    jpipe = StableDiffusionTPU(jcfg.tiny_config(), jp,
                               tokenizer=jtok.HashTokenizer(),
                               attn_impl="xla")
    tpipe = StableDiffusionTorch(tcfg.tiny_config(), tp,
                                 tokenizer=ttok.HashTokenizer(),
                                 device="cpu")
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    noise = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    monkeypatch.setattr(jpipeline, "_keyed_normal",
                        lambda k, shape, dtype=jnp.float32: jnp.asarray(noise))
    monkeypatch.setattr(tpipeline, "initial_noise",
                        lambda seeds, shape, device: torch.from_numpy(noise))
    state = _two_masks(64, 64)
    out = []
    for pipe, gen_cls, dt, arr in (
            (jpipe, jcfg.GenerationConfig, jnp.float32, jnp.asarray),
            (tpipe, tcfg.GenerationConfig, torch.float32, torch.from_numpy)):
        ctx, ids = pipe.encode_prompt([PROMPT], [NEG])
        gen = gen_cls(height=64, width=64, num_inference_steps=4, dtype=dt)
        out.append(pipe.txt2img(
            ctx, gen, seed=3, latents=arr(lat),
            region_biases=pipe.encode_region([state], ids, 64, 64),
            hires={"scale": 2.0, "strength": 0.6,
                   "region_state": ([state], ids, 1)}))
    want, got = np.asarray(out[0]), out[1]
    assert got.shape == (1, 128, 128, 3) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    want_u8 = np.round(np.clip(want * 0.5 + 0.5, 0, 1) * 255).astype(np.uint8)
    got_u8 = tpipe.to_uint8(got).numpy()
    assert np.abs(got_u8.astype(int) - want_u8.astype(int)).max() <= 1


def test_seed_list_is_batch_invariant():
    """Each sample's latents come from its own generator: a batch of seeds
    gives what the seeds give one at a time."""
    cfg = tcfg.tiny_config()
    tp = tfactory.init_pipeline_params(1, cfg, torch.float32, device="cpu")
    pipe = StableDiffusionTorch(cfg, tp, tokenizer=ttok.HashTokenizer(),
                                device="cpu")
    gen = tcfg.GenerationConfig(height=64, width=64, num_inference_steps=2,
                                dtype=torch.float32)
    ctx2, _ = pipe.encode_prompt([PROMPT] * 2, [NEG])
    ctx1, _ = pipe.encode_prompt([PROMPT], [NEG])
    noise = initial_noise([5, 9], (8, 8, 4), torch.device("cpu"))
    both = pipe.txt2img(ctx2, gen, seed=[5, 9], decode=False)
    for i, s in enumerate((5, 9)):
        assert torch.equal(noise[i:i + 1],
                           initial_noise([s], (8, 8, 4), torch.device("cpu")))
        one = pipe.txt2img(ctx1, gen, seed=s, decode=False)
        # the draws are equal bit for bit; the CPU's batched convolutions
        # sum in another order at batch 2 than at batch 1
        torch.testing.assert_close(both[i:i + 1], one, rtol=1e-3, atol=1e-3)


def test_unported_paths_raise(params):
    """What raised before now runs or raises what the JAX package raises:
    the prompt modes, samplers, hires overrides and history; unit extras
    (ControlNet, T2I-Adapter), which a hires pass takes only through
    hires['rebuild_extras'] (ValueError without it, as in the JAX
    package); an unknown keyword is a TypeError like any other call's."""
    _, tp = params
    pipe = StableDiffusionTorch(tcfg.tiny_config(), tp,
                                tokenizer=ttok.HashTokenizer(), device="cpu")
    ctx_a, ids_a = pipe.encode_prompt([PROMPT], [NEG], mode="a1111")
    assert ctx_a.shape == (2, 77, 64) and len(ids_a[0]) == 77
    ctx, _ = pipe.encode_prompt([PROMPT], [NEG])
    gen = tcfg.GenerationConfig(height=64, width=64, num_inference_steps=2,
                                dtype=torch.float32)
    t2i = tpipeline.DenoiseExtras(t2i_residuals=(), t2i_active=np.ones(2))
    with pytest.raises(ValueError, match="rebuild_extras"):
        pipe.txt2img(ctx, gen, extras=t2i, hires={"scale": 1.0})
    rebuilt = []
    img = pipe.txt2img(ctx, gen, hires={
        "scale": 1.0, "steps": 2, "strength": 0.5,
        "rebuild_extras": lambda g: rebuilt.append(g) or None})
    assert [g.num_inference_steps for g in rebuilt] == [2]
    assert img.shape == (1, 64, 64, 3) and torch.isfinite(img).all()
    with pytest.raises(TypeError):
        pipe.txt2img(ctx, gen, freeu=object())
    with pytest.raises(KeyError):
        pipe.txt2img(ctx, tcfg.GenerationConfig(sampler="no_such_solver"))
    img, (base, hr) = pipe.txt2img(
        ctx, gen, return_history=True,
        hires={"scale": 1.0, "steps": 2, "strength": 0.5,
               "sampler": "euler", "schedule": "exponential"})
    assert img.shape == (1, 64, 64, 3) and torch.isfinite(img).all()
    assert base.shape == (2, 1, 8, 8, 4) and hr.shape == (1, 1, 8, 8, 4)
    x = pipe.txt2img(ctx, dataclasses.replace(gen, sampler="euler"),
                     decode=False)
    assert x.shape == (1, 8, 8, 4) and torch.isfinite(x).all()
    long_text = PROMPT + ", " + " ".join(f"w{i}" for i in range(80))
    ctx_l, ids_l = pipe.encode_prompt([long_text], [NEG], mode="long")
    assert ctx_l.shape[1] == 154 and len(ids_l[0]) == 152
    rb = pipe.encode_region([_two_masks(64, 64)], ids_l, 64, 64)
    with pytest.raises(ValueError):  # the JAX package fails here too
        pipe.txt2img(ctx_l, gen, region_biases=rb)


def test_pipeline_takes_only_kernel_attention(params):
    _, tp = params
    with pytest.raises(ValueError):
        StableDiffusionTorch(tcfg.tiny_config(), tp, attn_impl="xla",
                             device="cpu")
    pipe = StableDiffusionTorch(tcfg.tiny_config(), tp,
                                attn_impl="pallas+qkbf16+exp2", device="cpu")
    assert pipe.attn_impl == "pallas+qkbf16+exp2"
