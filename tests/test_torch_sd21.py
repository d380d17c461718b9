"""The SD2.x code paths of the port against the JAX package on the CPU: a
tiny config with SD2.1's three departures from SD1.5 switched on (gelu in
the text encoder, linear transformer projections, v-prediction), with a
constant head width as SD2.1 has, run through txt2img with the region map
and ``guidance_rescale`` 0.7.

fp32, 64x64, 4 DPM++ 2M steps, CFG 7.5, the same injected latents; the
final latents are compared (the VAE is SD1.5's). Tolerance: 1e-4, as the
SD1.5 slice (tests/test_torch_pipeline.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.pipeline.pipeline import StableDiffusionTPU
from diffusionspatialcontrol_tpu.text import tokenizer as jtok
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.models import factory as tfactory
from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
    StableDiffusionTorch,
)
from diffusionspatialcontrol_tpu_torch.text import tokenizer as ttok

from test_torch_inpaint import NEG, PROMPT, _two_masks
from test_torch_vae import to_jax

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)


def _tiny_sd21(mod):
    cfg = mod.tiny_config()
    return dataclasses.replace(
        cfg, name="tiny-sd21-v",
        clip=dataclasses.replace(cfg.clip, hidden_act="gelu"),
        unet=dataclasses.replace(cfg.unet, num_attention_heads=(1, 2, 4, 4),
                                 use_linear_projection=True),
        prediction_type="v_prediction")


def test_sd21_style_txt2img_matches_jax():
    tc = _tiny_sd21(tcfg)
    sd21 = tcfg.sd21_config(True)
    assert (tc.clip.hidden_act, tc.unet.use_linear_projection,
            tc.prediction_type) == (sd21.clip.hidden_act,
                                    sd21.unet.use_linear_projection,
                                    sd21.prediction_type)
    tp = tfactory.init_pipeline_params(2, tc, torch.float32, device="cpu")
    assert "kernel" in tp["unet"]["mid_block"]["attention"]["proj_in"]
    assert tp["unet"]["mid_block"]["attention"]["proj_in"]["kernel"].dim() \
        == 2
    lat = np.random.default_rng(7).standard_normal((1, 8, 8, 4)).astype(
        np.float32)
    out = []
    for pipe, mod, dt, arr in (
            (StableDiffusionTPU(_tiny_sd21(jcfg), to_jax(tp),
                                tokenizer=jtok.HashTokenizer(),
                                attn_impl="xla"),
             jcfg, jnp.float32, jnp.asarray),
            (StableDiffusionTorch(tc, tp, tokenizer=ttok.HashTokenizer(),
                                  device="cpu"),
             tcfg, torch.float32, torch.from_numpy)):
        ctx, ids = pipe.encode_prompt([PROMPT], [NEG])
        gen = mod.GenerationConfig(height=64, width=64,
                                   num_inference_steps=4,
                                   guidance_rescale=0.7, dtype=dt)
        out.append(pipe.txt2img(
            ctx, gen, latents=arr(lat), decode=False,
            region_biases=pipe.encode_region([_two_masks(64, 64)], ids, 64,
                                             64)))
    want, got = np.asarray(out[0]), out[1]
    assert got.shape == (1, 8, 8, 4) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
