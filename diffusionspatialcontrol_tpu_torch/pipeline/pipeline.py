"""txt2img with region control (port of ``pipeline/pipeline.py``).

``StableDiffusionTorch`` is the counterpart of ``StableDiffusionTPU`` on the
main path: prompt and region encoding, the sigma-space denoiser with CFG,
the DPM++ 2M loop on Karras sigmas, VAE decode and uint8 conversion.

Math parity notes (as in the JAX package):
  * initial latents are scaled by (sigma_0^2 + 1)^0.5;
  * CFG mixes *denoised* outputs, u + g*(c-u), then ``guidance_rescale``;
  * the denoiser wraps an epsilon or v prediction UNet as k-diffusion's
    CompVisDenoiser / CompVisVDenoiser do, with c_in = 1/sqrt(sigma^2+1) and
    the fractional timestep from log-sigma interpolation.

Randomness: each sample draws its initial latents from its own
``torch.Generator``, so a sample's result depends only on its seed, not on
the batch it rides in. The streams differ from JAX's threefry streams; tests
pass ``latents=`` to compare the two packages.

Not ported yet: img2img, inpaint, hires, the other 21 solvers, ControlNet,
T2I-Adapter, IP-Adapter, chunked sampling and the speed modes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import GenerationConfig, ModelConfig
from ..device import resolve_device
from ..models.unet import RegionState, UNetCond, flash_options, unet_apply
from ..models.vae import vae_decode
from ..samplers import schedules, solvers

SeedT = Union[int, Sequence[int]]


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale: float):
    """The reference's rescale_noise_cfg (arXiv:2305.08891 section 3.4)."""
    dims = tuple(range(1, noise_pred_text.dim()))
    std_text = noise_pred_text.std(dim=dims, keepdim=True)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1 - guidance_rescale) * noise_cfg


def _sigma_to_t(sigma: torch.Tensor, log_sigma_table: torch.Tensor
                ) -> torch.Tensor:
    """``jnp.interp(log(max(sigma, 1e-10)), log_table, arange(n))`` on the
    device, fp32: the fractional train timestep of a sigma."""
    x = torch.log(torch.clamp(sigma, min=1e-10)).reshape(1)
    xp = log_sigma_table
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    x0, x1 = xp[i - 1], xp[i]
    t = (i - 1).float() + (x - x0) / (x1 - x0)
    return torch.clamp(t, 0.0, float(n - 1)).reshape(())


def _interleave_cfg(a: torch.Tensor) -> torch.Tensor:
    """[u0..uB, c0..cB] -> [u0, c0, u1, c1, ...] (the JAX package's CFG
    layout; per-sample outputs do not depend on batch order)."""
    half = a.shape[0] // 2
    return a.reshape((2, half) + tuple(a.shape[1:])).transpose(0, 1).reshape(
        (-1,) + tuple(a.shape[1:]))


def make_denoise_fn(
    params: Dict[str, Any],
    model_cfg: ModelConfig,
    context: torch.Tensor,  # (B or 2B, S, D) [uncond..., cond...] with CFG
    region_biases: Optional[Tuple[torch.Tensor, ...]],
    log_sigma_table: torch.Tensor,
    guidance_scale: float,
    guidance_rescale: float = 0.0,
    attn_impl: str = "pallas",
    compute_dtype=torch.bfloat16,
):
    """The sigma-space denoiser D(x; sigma); sigma is a 0-d fp32 tensor."""
    do_cfg = guidance_scale > 1.0
    context = context.to(compute_dtype)
    if do_cfg:
        context = _interleave_cfg(context)
        if region_biases is not None:
            region_biases = tuple(_interleave_cfg(b) for b in region_biases)

    def denoise(x, sigma):
        x_in = (torch.stack([x, x], dim=1).reshape((-1,) + tuple(x.shape[1:]))
                if do_cfg else x)
        c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        t = _sigma_to_t(sigma, log_sigma_table)
        t_b = t.expand(x_in.shape[0])
        model_in = (x_in * c_in).to(compute_dtype)
        region = (None if region_biases is None
                  else RegionState(region_biases, sigma))
        out = unet_apply(params["unet"], model_cfg.unet, model_in, t_b,
                         UNetCond(context=context, region=region),
                         attn_impl=attn_impl).float()
        if model_cfg.prediction_type == "v_prediction":
            c_skip = 1.0 / (sigma ** 2 + 1.0)
            c_out = -sigma / torch.sqrt(sigma ** 2 + 1.0)
            denoised = out * c_out + x_in * c_skip
        else:
            denoised = x_in - out * sigma
        if not do_cfg:
            return denoised
        pair = denoised.reshape((x.shape[0], 2) + tuple(denoised.shape[1:]))
        d_u, d_c = pair[:, 0], pair[:, 1]
        mixed = d_u + guidance_scale * (d_c - d_u)
        if guidance_rescale > 0.0:
            mixed = rescale_noise_cfg(mixed, d_c, guidance_rescale)
        return mixed

    return denoise


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] fp32 images -> uint8, on the images' device."""
    if images.dtype == torch.uint8:
        return images
    return torch.round(
        torch.clamp(images * 0.5 + 0.5, 0.0, 1.0) * 255.0).to(torch.uint8)


def initial_noise(seeds: Sequence[int], shape: Tuple[int, ...],
                  device: torch.device) -> torch.Tensor:
    """Standard-normal latents (len(seeds),) + shape, one generator a
    sample."""
    draws = []
    for s in seeds:
        g = torch.Generator(device=device).manual_seed(int(s))
        draws.append(torch.randn(shape, generator=g, device=device,
                                 dtype=torch.float32))
    return torch.stack(draws)


class StableDiffusionTorch:
    """txt2img with optional region control.

    ``device`` defaults to CUDA and raises when there is none; CPU runs pass
    ``device="cpu"``. ``attn_impl`` takes the JAX package's kernel strings,
    "pallas[+qkbf16][+pvbf16][+exp2]" (see ``models.unet.flash_options``);
    anything else raises."""

    def __init__(self, model_cfg: ModelConfig, params: Dict[str, Any],
                 tokenizer=None, attn_impl: str = "pallas",
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.params = params
        self.tokenizer = tokenizer
        flash_options(attn_impl)  # raises on a string the port does not take
        self.attn_impl = attn_impl
        self.sigma_table = schedules.ddpm_sigma_table(model_cfg)
        self.log_sigma_table = torch.tensor(
            np.log(self.sigma_table), dtype=torch.float32, device=self.device)

    # -- prompt encoding ----------------------------------------------------

    @torch.inference_mode()
    def encode_prompt(self, prompts: Sequence[str],
                      negative_prompts: Sequence[str], clip_skip: int = 2,
                      mode: str = "short", num_images_per_prompt: int = 1
                      ) -> Tuple[torch.Tensor, List[List[int]]]:
        """(context (2B, S, D) [uncond..., cond...], cond token ids per
        prompt for region matching)."""
        from ..text.encoder import encode_prompts

        return encode_prompts(
            self.params["clip"], self.model_cfg.clip, self.tokenizer,
            list(prompts), list(negative_prompts), clip_skip=clip_skip,
            mode=mode, num_images_per_prompt=num_images_per_prompt,
            device=self.device)

    # -- region state -------------------------------------------------------

    def encode_region(self, region_states: Sequence[Optional[dict]],
                      prompt_ids: Sequence[Sequence[int]], height: int,
                      width: int, num_images_per_prompt: int = 1,
                      do_cfg: bool = True):
        from ..ops.region_map import encode_region_state

        if not any(region_states):
            return None

        def tok(phrase: str) -> List[int]:
            return self.tokenizer.encode(phrase, add_special_tokens=False)

        return encode_region_state(
            region_states, prompt_ids, tok, height=height, width=width,
            num_images_per_prompt=num_images_per_prompt, do_cfg=do_cfg,
            device=self.device)

    # -- sampling -----------------------------------------------------------

    def _schedule(self, gen: GenerationConfig) -> np.ndarray:
        if gen.sampler != "dpmpp_2m":
            raise NotImplementedError(
                f"sampler {gen.sampler!r} is not ported yet; use 'dpmpp_2m'")
        return schedules.get_sigmas(self.model_cfg, gen.num_inference_steps,
                                    gen.schedule)

    @torch.inference_mode()
    def txt2img(self, context: torch.Tensor, gen: GenerationConfig,
                seed: SeedT = 0, region_biases=None, batch_size: int = 1,
                decode: bool = True, latents: Optional[torch.Tensor] = None,
                uint8_output: bool = False, **unsupported):
        """txt2img on a pre-encoded context. Returns images (B, H, W, 3),
        fp32 in [-1, 1] (uint8 with ``uint8_output``), or the final latents
        with ``decode=False``.

        ``seed``: an int, or a list with one seed per sample. An int seed
        with ``batch_size`` B seeds the samples with seed, seed+1, ...
        ``latents``: (B, h, w, 4) standard-normal initial latents to use
        instead of the seeded draw; they are scaled by sqrt(sigma_0^2+1)."""
        if any(v not in (None, False) for v in unsupported.values()):
            raise NotImplementedError(
                f"not ported yet: {sorted(unsupported)} (hires, extras and "
                f"history come with later slices)")
        sigmas = self._schedule(gen)
        if isinstance(seed, (list, tuple, np.ndarray)):
            seeds = [int(s) for s in seed]
        else:
            seeds = [int(seed) + i for i in range(batch_size)]
        shape = (gen.latent_height, gen.latent_width, 4)
        if latents is None:
            latents = initial_noise(seeds, shape, self.device)
        else:
            latents = torch.as_tensor(latents, dtype=torch.float32,
                                      device=self.device)
        x = latents * float(np.sqrt(sigmas[0] ** 2 + 1.0))

        denoise = make_denoise_fn(
            self.params, self.model_cfg, context.to(self.device),
            region_biases, self.log_sigma_table, gen.guidance_scale,
            gen.guidance_rescale, self.attn_impl, compute_dtype=gen.dtype)
        x = solvers.sample_dpmpp_2m(denoise, x, sigmas)
        if not decode:
            return x
        images = vae_decode(self.params["vae"], self.model_cfg.vae, x)
        return to_uint8(images) if uint8_output else images

    to_uint8 = staticmethod(to_uint8)
