"""txt2img, img2img and inpaint with region control, ControlNet,
T2I-Adapter and IP-Adapter units, hires fix and chunked sampling (port of
``pipeline/pipeline.py``).

``StableDiffusionTorch`` is the counterpart of ``StableDiffusionTPU``:
prompt encoding in the three modes, region encoding, the sigma-space
denoiser with CFG, every solver of ``samplers.solvers.SOLVERS`` on each of
the four schedules, VAE encode and decode and uint8 conversion; img2img
from images (``encode_image`` then ``img2img``); inpaint on 4-channel
UNets (the known region blended back at every denoiser call) and on
9-channel inpaint UNets (mask and masked-image latents as extra input
channels), with the asymmetric VAE's mask-conditioned decode; ControlNet,
T2I-Adapter and IP-Adapter units (``build_controlnet_extras``,
``build_t2i_extras``, ``build_ip_extras``, then ``extras=`` on every
sampling method); hires fix (latent upscale, then
img2img on the latents at the target size, optionally with another sampler
and schedule, the units' inputs rebuilt at that size); per-step latent
history; ``sample_chunked``, which returns to the caller between chunks
of steps to report progress, cancel or pause; and the opt-in speed modes,
which have no reference counterpart: ``txt2img_cfg_tail`` (the last steps
without the uncond half), ``txt2img_tgate`` (cross-attention frozen after a
gate step), ``txt2img_deepcache`` (the UNet's deep branch reused between
full steps) and ``txt2img_bottleneck`` (the middle steps at a lower
resolution).

Math parity notes (as in the JAX package):
  * initial latents are scaled by (sigma_0^2 + 1)^0.5;
  * CFG mixes *denoised* outputs, u + g*(c-u), then ``guidance_rescale``;
  * the denoiser wraps an epsilon or v prediction UNet as k-diffusion's
    CompVisDenoiser / CompVisVDenoiser do, with c_in = 1/sqrt(sigma^2+1) and
    the fractional timestep from log-sigma interpolation.

Randomness: each sample draws from its own CPU ``torch.Generator``
(``samplers.brownian``), in a fixed order: txt2img its initial latents,
img2img its noise, then the solver noise; inpaint the posterior draw, the
initial latents, the blend noise (4-channel UNets only), then the solver
noise. ``encode_image`` takes its posterior draw from another stream of
the seed (``posterior_noise``), so img2img from its latents with the same
seed does not add the same draw twice. The speed modes draw as
txt2img does (cfg-tail, TGATE and DeepCache draw nothing else; TGATE and
cfg-tail resume the same solver noise after their switch), and bottleneck
sampling, whose solvers draw no noise, then draws its two boundary noises,
the low-resolution one first (``bottleneck_draws``). So a sample's result
depends only on its seed, not on the batch it rides in, on the device or on
whether latents were passed. The streams differ from JAX's threefry
streams; tests pass ``latents=`` and patch ``initial_noise``,
``seeded_normals``, ``posterior_noise``, ``bottleneck_draws`` and
``_solver_noise`` to compare the two packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import GenerationConfig, ModelConfig, T2IAdapterConfig
from ..device import resolve_device
from ..models.controlnet import (
    check_input_channels,
    controlnet_apply,
    controlnet_cond_embedding,
)
from ..models.layers import check_conv_impl
from ..models.t2i_adapter import multi_adapter_apply
from ..models.unet import (
    RegionState,
    UNetCond,
    deepcache_shape,
    flash_options,
    unet_apply,
    unet_apply_deepcache,
)
from ..models.vae import vae_decode, vae_encode
from ..ops.resize import resize_latents
from ..samplers import brownian, schedules, solvers

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


def controlnet_keep_schedule(steps: int, starts: Sequence[float],
                             ends: Sequence[float]) -> np.ndarray:
    """(n_units, steps) keep mask: 1 where the step lies inside the unit's
    [start, end) fraction of the run (diffusers' formula)."""
    keeps = np.zeros((len(starts), steps), np.float32)
    for u, (s, e) in enumerate(zip(starts, ends)):
        for i in range(steps):
            keeps[u, i] = 1.0 - float(i / steps < s or (i + 1) / steps > e)
    return keeps


def on_device(x, device) -> torch.Tensor:
    """A tensor or array on ``device``; numpy float64 becomes fp32, as
    ``jnp.asarray`` makes it."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        x = torch.from_numpy(np.ascontiguousarray(
            x.astype(np.float32) if x.dtype == np.float64 else x))
    return x.to(device)


def _interleave_cfg(a: torch.Tensor) -> torch.Tensor:
    """[u0..uB, c0..cB] -> [u0, c0, u1, c1, ...] (the JAX package's CFG
    layout; per-sample outputs do not depend on batch order)."""
    half = a.shape[0] // 2
    return a.reshape((2, half) + tuple(a.shape[1:])).transpose(0, 1).reshape(
        (-1,) + tuple(a.shape[1:]))


@dataclasses.dataclass
class DenoiseExtras:
    """Per-generation conditioning the denoiser consumes: ControlNet,
    T2I-Adapter and IP-Adapter units and the inpaint inputs. Tensors are
    CFG-doubled ([uncond..., cond...]) where guidance needs it."""

    # ControlNet: parallel lists over units
    controlnet_params: Optional[List[Any]] = None
    controlnet_images: Optional[List[torch.Tensor]] = None  # (B_cfg, H, W, 3)
    controlnet_scales: Optional[np.ndarray] = None  # (n_units, n_steps)
    controlnet_guess: bool = False
    # T2I-Adapter: the residuals, computed once (CFG-doubled)
    t2i_residuals: Optional[Tuple[torch.Tensor, ...]] = None
    t2i_active: Optional[np.ndarray] = None  # (n_steps,) 0/1
    # IP-Adapter: a adapter, its (B_cfg, n_tokens, cross_dim) tokens, its
    # scale and its optional (B_cfg, Hm, Wm) mask
    ip_tokens: Optional[Tuple[torch.Tensor, ...]] = None
    ip_scales: Optional[Tuple[float, ...]] = None
    ip_masks: Optional[Tuple[Optional[torch.Tensor], ...]] = None
    # 4-channel inpaint blend
    inpaint_mask: Optional[torch.Tensor] = None  # (B, h, w, 1), 1 = regenerate
    inpaint_image_latents: Optional[torch.Tensor] = None  # (B, h, w, 4)
    inpaint_noise: Optional[torch.Tensor] = None  # (B, h, w, 4)
    # 9-channel inpaint UNet input [mask, masked-image latents]
    extra_channels: Optional[torch.Tensor] = None  # (B_cfg, h, w, 5)


def cond_half_conditioning(context: torch.Tensor,
                           region_biases: Optional[Tuple[torch.Tensor, ...]],
                           extras: Optional[DenoiseExtras]):
    """Every CFG-doubled ([uncond..., cond...]) conditioning tensor cut to
    its cond half, for a segment with guidance off. What is never
    CFG-doubled (the inpaint mask, latents and noise; guess-mode ControlNet
    images) passes as it is."""
    def half(a):
        return a[a.shape[0] // 2:]

    rb = (None if region_biases is None
          else tuple(half(b) for b in region_biases))
    ex = extras
    if extras is not None:
        ex = dataclasses.replace(
            extras,
            controlnet_images=(
                extras.controlnet_images
                if extras.controlnet_images is None or extras.controlnet_guess
                else [half(i) for i in extras.controlnet_images]),
            t2i_residuals=(None if extras.t2i_residuals is None
                           else tuple(half(f) for f in extras.t2i_residuals)),
            ip_tokens=(None if extras.ip_tokens is None
                       else tuple(half(t) for t in extras.ip_tokens)),
            ip_masks=(None if extras.ip_masks is None
                      else tuple(None if m is None else half(m)
                                 for m in extras.ip_masks)),
            extra_channels=(None if extras.extra_channels is None
                            else half(extras.extra_channels)))
    return half(context), rb, ex


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
    conv_impl: str = "xla",
    extras: Optional[DenoiseExtras] = None,
    sigma_steps: Optional[np.ndarray] = None,
    xattn_cache: Optional[Tuple[torch.Tensor, ...]] = None,
    collect_xattn: bool = False,
    mesh=None,
):
    """The sigma-space denoiser D(x; sigma); sigma is a 0-d fp32 tensor.

    ``extras`` (inpaint): with ``inpaint_mask``, every call first blends
    the known region back into x, ``m x + (1 - m)(image_latents + sigma
    noise)``, before the CFG duplication; with ``extra_channels``, they are
    appended to the UNet's input after the c_in scaling, in the compute
    dtype.

    ``extras`` (units): each call takes the step index of sigma, the
    nearest entry of ``sigma_steps`` (the sampled schedule's sigmas without
    the last; a second-order solver's intermediate sigma lands on the
    nearest step), and gathers the units' per-step scales there on the
    device (``index_select``: no host read, so the host launches on while
    the card runs). Every ControlNet runs on the scaled
    latents (never a 9-channel UNet's extra channels) and the context; in
    guess mode with CFG only on the cond rows, its residuals interleaved
    with zeros. The units' residuals are summed in fp32 and rounded once at
    the add into the UNet. The cond embedding of each ControlNet's image
    depends on the image and the weights only, so it is computed once here
    (``controlnet_cond_embedding``), not at every call.

    ``extras`` (IP-Adapter): the tokens are cast to the compute dtype and,
    with the masks, CFG-interleaved where their batch is the CFG batch; the
    masks stay fp32, downsampled once a request to each attention's
    sequence length (``UNetCond.ip_mask_cache``).

    TGATE (``models.unet.unet_apply``): with ``collect_xattn`` the denoiser
    returns ``(denoised, cross-attention outputs)``; ``xattn_cache`` feeds
    such outputs to every call in place of the cross-attentions, and needs
    guidance off (the TGATE tail runs cond-only: with a shared frozen
    cross-attention the CFG halves are identical).

    ``mesh`` (``parallel.mesh.Mesh``; the JAX package's ``axis_name``): x,
    the context and every conditioning tensor are this rank's shard of a
    data-parallel batch, and the region std is all-reduced over the mesh
    in every mapped cross-attention (``models.unet.unet_apply``)."""
    if xattn_cache is not None and guidance_scale > 1.0:
        raise ValueError(
            "xattn_cache requires guidance off (the TGATE tail runs "
            "cond-only; with a shared frozen cross-attention the CFG "
            "halves are identical)")

    def unet(model_in, t_b, cond):
        out = unet_apply(params["unet"], model_cfg.unet, model_in, t_b, cond,
                         attn_impl=attn_impl, conv_impl=conv_impl,
                         xattn_cache=xattn_cache, collect_xattn=collect_xattn,
                         mesh=mesh)
        return out if collect_xattn else (out, None)

    denoise = _make_denoiser(params, model_cfg, context, region_biases,
                             log_sigma_table, guidance_scale,
                             guidance_rescale, attn_impl, compute_dtype,
                             conv_impl, extras, sigma_steps, unet)
    if collect_xattn:
        return denoise
    return lambda x, sigma: denoise(x, sigma)[0]


def _make_denoiser(params, model_cfg: ModelConfig, context, region_biases,
                   log_sigma_table, guidance_scale, guidance_rescale,
                   attn_impl, compute_dtype, conv_impl, extras, sigma_steps,
                   unet):
    """The body of ``make_denoise_fn``, also DeepCache's denoiser:
    ``denoise(x, sigma) -> (denoised, aux)``, where
    ``unet(model_in, t_b, cond) -> (out, aux)`` runs the UNet."""
    do_cfg = guidance_scale > 1.0
    ex = extras or DenoiseExtras()
    dev = log_sigma_table.device
    context = context.to(compute_dtype)
    cfg_batch = context.shape[0]

    def _maybe(a):
        """The CFG interleave of a CFG-doubled tensor."""
        if do_cfg and a is not None and a.shape[0] == cfg_batch:
            return _interleave_cfg(a)
        return a

    extra = (None if ex.extra_channels is None
             else _maybe(ex.extra_channels.to(compute_dtype)))
    ip_tokens = ip_masks = None
    if ex.ip_tokens is not None:
        ip_tokens = tuple(_maybe(t.to(device=dev, dtype=compute_dtype))
                          for t in ex.ip_tokens)
    if ex.ip_masks is not None:
        ip_masks = tuple(None if m is None else _maybe(m.to(dev))
                         for m in ex.ip_masks)
    ip_mask_cache = {}
    if region_biases is not None and region_biases[0].shape[-1] != \
            context.shape[1]:
        raise ValueError(
            f"the region map was built for {region_biases[0].shape[-1]} "
            f"token ids but the context has {context.shape[1]} positions; "
            f"prompt mode 'long' returns the ids of its 75 n + 2 layout for "
            f"a context of 77 n, so its ids cannot build a map (nor can they "
            f"in the JAX package)")
    if do_cfg:
        context = _interleave_cfg(context)
        if region_biases is not None:
            region_biases = tuple(_interleave_cfg(b) for b in region_biases)
    guess = ex.controlnet_guess and do_cfg
    units = []  # (params, cond embedding, scale row) per ControlNet
    if ex.controlnet_params is not None:
        scale_tab = torch.tensor(np.asarray(ex.controlnet_scales, np.float32),
                                 device=dev)
        for u, (cn_p, img) in enumerate(zip(ex.controlnet_params,
                                            ex.controlnet_images)):
            check_input_channels(cn_p, model_cfg.unet.out_channels)
            img = _maybe(img.to(dev))
            if guess and img.shape[0] == cfg_batch:
                img = img[1::2]  # the cond rows
            units.append((cn_p, controlnet_cond_embedding(cn_p, img,
                                                          compute_dtype),
                          scale_tab[u]))
    t2i = None
    if ex.t2i_residuals is not None:
        t2i = (tuple(_maybe(r) for r in ex.t2i_residuals),
               torch.tensor(np.asarray(ex.t2i_active, np.float32),
                            device=dev))
    sig_steps = None
    if units or t2i:
        if sigma_steps is None:
            raise ValueError("ControlNet/T2I extras need sigma_steps (the "
                             "sampled schedule) for their per-step scales")
        sig_steps = torch.tensor(np.asarray(sigma_steps, np.float32),
                                 device=dev)

    def _at(table, i):
        """``table[i]`` for a 0-d index tensor on the device: a gather, as
        indexing with a 0-d tensor reads the index on the host."""
        return table.index_select(0, i.reshape(1)).reshape(())

    def _zero_interleave(r):
        return torch.stack([torch.zeros_like(r), r], dim=1).reshape(
            (-1,) + tuple(r.shape[1:]))

    def denoise(x, sigma):
        if ex.inpaint_mask is not None:
            m = ex.inpaint_mask
            proper = ex.inpaint_image_latents + sigma * ex.inpaint_noise
            x = m * x + (1.0 - m) * proper
        x_in = (torch.stack([x, x], dim=1).reshape((-1,) + tuple(x.shape[1:]))
                if do_cfg else x)
        c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        t = _sigma_to_t(sigma, log_sigma_table)
        t_b = t.expand(x_in.shape[0])
        scaled_in = (x_in * c_in).to(compute_dtype)
        model_in = scaled_in
        if extra is not None:
            model_in = torch.cat([model_in, extra], dim=-1)
        region = (None if region_biases is None
                  else RegionState(region_biases, sigma))
        cond = UNetCond(context=context, region=region, ip_tokens=ip_tokens,
                        ip_scales=ex.ip_scales, ip_masks=ip_masks,
                        ip_mask_cache=ip_mask_cache)
        if sig_steps is not None:
            idx = torch.argmin(torch.abs(sig_steps - sigma))
        for cn_p, emb, scales in units:
            if guess:
                d_res, m_res = controlnet_apply(
                    cn_p, model_cfg.unet, scaled_in[1::2], t_b[1::2],
                    context[1::2], emb, conditioning_scale=_at(scales, idx),
                    guess_mode=True)
                d_res = tuple(_zero_interleave(r) for r in d_res)
                m_res = _zero_interleave(m_res)
            else:
                d_res, m_res = controlnet_apply(
                    cn_p, model_cfg.unet, scaled_in, t_b, context, emb,
                    conditioning_scale=_at(scales, idx))
            if cond.controlnet_down is None:
                cond.controlnet_down, cond.controlnet_mid = d_res, m_res
            else:
                cond.controlnet_down = tuple(
                    a + b for a, b in zip(cond.controlnet_down, d_res))
                cond.controlnet_mid = cond.controlnet_mid + m_res
        if t2i is not None:
            active = _at(t2i[1], idx)
            cond.t2i_residuals = tuple(r.float() * active for r in t2i[0])
        out, aux = unet(model_in, t_b, cond)
        out = out.float()
        if model_cfg.prediction_type == "v_prediction":
            c_skip = 1.0 / (sigma ** 2 + 1.0)
            c_out = -sigma / torch.sqrt(sigma ** 2 + 1.0)
            denoised = out * c_out + x_in * c_skip
        else:
            denoised = x_in - out * sigma
        if not do_cfg:
            return denoised, aux
        pair = denoised.reshape((x.shape[0], 2) + tuple(denoised.shape[1:]))
        d_u, d_c = pair[:, 0], pair[:, 1]
        mixed = d_u + guidance_scale * (d_c - d_u)
        if guidance_rescale > 0.0:
            mixed = rescale_noise_cfg(mixed, d_c, guidance_rescale)
        return mixed, aux

    return denoise


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images -> uint8, on the images' device, as the JAX package's
    native codec converts them: ``v = clamp(x 0.5 + 0.5, 0, 1) 255 + 0.5``
    in fp32, truncated, so ties round up (separate fp32 ops, no fused
    multiply-add, as the codec is compiled)."""
    if images.dtype == torch.uint8:
        return images
    v = torch.clamp(images.float() * 0.5 + 0.5, 0.0, 1.0) * 255.0
    return (v + 0.5).to(torch.uint8)


def seeded_normals(seeds: Sequence[int], shape: Tuple[int, ...], count: int,
                   device: torch.device) -> torch.Tensor:
    """The first ``count`` standard-normal draws of ``shape`` from each
    sample's generator, (count, len(seeds)) + shape: an inpaint request's
    posterior draw, initial latents and blend noise, in that order. Drawn
    on the CPU, so that a seed gives the same noise on every device."""
    draws = []
    for s in seeds:
        g = torch.Generator().manual_seed(int(s))
        draws.append(torch.stack([
            torch.randn(shape, generator=g, dtype=torch.float32)
            for _ in range(count)]))
    return torch.stack(draws, dim=1).to(device)


def initial_noise(seeds: Sequence[int], shape: Tuple[int, ...],
                  device: torch.device) -> torch.Tensor:
    """Standard-normal latents (len(seeds),) + shape, the first draw of each
    sample's generator: txt2img's initial latents and img2img's noise."""
    return seeded_normals(seeds, shape, 1, device)[0]


def posterior_noise(seeds: Sequence[int], shape: Tuple[int, ...],
                    device: torch.device) -> torch.Tensor:
    """``encode_image``'s posterior draws, (len(seeds),) + shape: for each
    seed the first standard-normal draw of numpy's PCG64 generator of that
    seed. txt2img, img2img and inpaint draw from the seed's torch generator
    (an MT19937), so this stream is one they never use, as the JAX package
    draws ``encode_image``'s posterior from ``PRNGKey(seed)`` and img2img's
    noise from a split of it. Drawn on the CPU, as every draw."""
    return torch.from_numpy(np.stack([
        np.random.default_rng(int(s) % 2 ** 64).standard_normal(
            shape, dtype=np.float32) for s in seeds])).to(device)


def bottleneck_draws(seeds: Sequence[int], low_shape: Tuple[int, ...],
                     full_shape: Tuple[int, ...], device: torch.device):
    """Bottleneck sampling's draws, (len(seeds),) + shape each, in the order
    of each sample's generator: the initial latents (``full_shape``, as
    ``initial_noise`` draws them), the low-resolution boundary's noise,
    then the full-resolution boundary's. Its solvers draw no noise."""
    draws = ([], [], [])
    for s in seeds:
        g = torch.Generator().manual_seed(int(s))
        for out, shape in zip(draws, (full_shape, low_shape, full_shape)):
            out.append(torch.randn(shape, generator=g, dtype=torch.float32))
    return tuple(torch.stack(d).to(device) for d in draws)


def _seed_list(seed: SeedT, batch: int) -> List[int]:
    """One seed a sample: a list as given, or seed, seed + 1, ..."""
    if isinstance(seed, (list, tuple, np.ndarray)):
        return [int(s) for s in seed]
    return [int(seed) + i for i in range(batch)]


def _batch_seeds(seed: SeedT, batch: int, what: str) -> List[int]:
    """``_seed_list`` for a batch of ``batch`` given inputs: a seed list
    must have one seed a sample."""
    seeds = _seed_list(seed, batch)
    if len(seeds) != batch:
        raise ValueError(f"{what} seed list length {len(seeds)} != batch "
                         f"{batch}")
    return seeds


def _next_seed(seed: SeedT) -> SeedT:
    """seed + 1, elementwise for per-sample seed lists: the hires pass's
    seed, as in the JAX package."""
    if isinstance(seed, (list, tuple, np.ndarray)):
        return [int(s) + 1 for s in seed]
    return int(seed) + 1


@dataclasses.dataclass
class ChunkedPause:
    """The solver state at a chunk boundary of
    :meth:`StableDiffusionTorch.sample_chunked`. The schedule, the noise
    table and the initial latents follow from the call's arguments, so
    resuming with the same arguments and this state gives the same result,
    bit for bit, as a run that never paused."""

    x: torch.Tensor  # current latents (sigma space)
    carry: Any  # the solver's carry
    pos: int  # steps done
    n_total: int  # steps of the schedule (checked on resume)


def _sigma_tensor(sigma: float, device) -> torch.Tensor:
    """A schedule's sigma as the 0-d fp32 tensor the denoisers take."""
    return torch.tensor([sigma], dtype=torch.float32).to(device)[0]


def _tgate_core(params, latents, context, region_biases, noise, extras, *,
                model_cfg: ModelConfig, solver_name: str, sigmas: np.ndarray,
                gate: int, guidance_scale: float, guidance_rescale: float,
                attn_impl: str, conv_impl: str, solver_opts: dict,
                log_sigma_table: torch.Tensor, compute_dtype):
    """TGATE on scaled initial latents: steps [0, gate) with the full
    conditioning; one forward at sigmas[gate] that collects every
    cross-attention output (with CFG, each pair averaged in the compute
    dtype); then the rest of the steps cond-only, resuming the same solver
    carry and noise, with the frozen outputs in place of every
    cross-attention (the region biases and IP tokens are dropped: nothing
    reads them past the gate; ControlNet and T2I residuals stay live).
    Returns the final latents."""
    n_total = len(sigmas) - 1
    solver_fn = solvers.SOLVERS[solver_name][0]

    def denoiser(ctx, biases, g, g_rescale, ex, sigma_steps, **kw):
        return make_denoise_fn(
            params, model_cfg, ctx, biases, log_sigma_table, g, g_rescale,
            attn_impl, compute_dtype=compute_dtype, conv_impl=conv_impl,
            extras=ex, sigma_steps=sigma_steps, **kw)

    x1, carry = solver_fn(
        denoiser(context, region_biases, guidance_scale, guidance_rescale,
                 extras, sigmas[:-1]),
        latents, sigmas, noise=noise, segment=(0, gate), return_carry=True,
        **solver_opts)
    # the collect forward's unit scales are read at column 0 of their
    # per-step tables, as in the JAX package (its schedule is [sigma_gate])
    collect = denoiser(context, region_biases, guidance_scale,
                       guidance_rescale, extras, sigmas[gate:gate + 1],
                       collect_xattn=True)
    _, xa = collect(x1, _sigma_tensor(sigmas[gate], latents.device))
    if guidance_scale > 1.0:
        # interleaved CFG rows [u0, c0, ...]: average each pair
        xa = tuple(0.5 * (e[0::2] + e[1::2]) for e in xa)
        ctx2, _, ex2 = cond_half_conditioning(context, None, extras)
    else:
        ctx2, ex2 = context, extras
    if ex2 is not None and ex2.ip_tokens is not None:
        ex2 = dataclasses.replace(ex2, ip_tokens=None, ip_scales=None,
                                  ip_masks=None)
    return solver_fn(
        denoiser(ctx2, None, 1.0, 0.0, ex2, sigmas[:-1], xattn_cache=xa),
        x1, sigmas, noise=noise, carry_in=carry,
        segment=(gate, n_total - gate), **solver_opts)


def _step_cached(fn, cache0, use_cache: np.ndarray):
    """``fn(*args, cache, use) -> (out, cache)`` as ``f(*args) -> out``: the
    closure holds the cache, and its i-th call passes ``use_cache[i]``.
    DeepCache's solvers call the denoiser once a step, so the plain
    recurrences run it unchanged."""
    state = {"cache": cache0, "i": 0}

    def f(*args):
        out, state["cache"] = fn(*args, state["cache"],
                                 use_cache[state["i"]])
        state["i"] += 1
        return out
    return f


def _sample_deepcache_core(params, latents, context, region_biases, extras,
                           *, model_cfg: ModelConfig, solver_name: str,
                           sigmas: np.ndarray, guidance_scale: float,
                           guidance_rescale: float, attn_impl: str,
                           cache_interval: int, conv_impl: str,
                           log_sigma_table: torch.Tensor, compute_dtype):
    """DeepCache on scaled initial latents: step i runs the full UNet and
    refreshes the deep-feature cache when i % cache_interval == 0 (step 0
    always), and reuses the cache otherwise
    (``models.unet.unet_apply_deepcache``, in ``make_denoise_fn``'s denoiser
    and the plain solver). The schedule is numpy on the host, so the choice
    reads nothing from the device. ControlNet and T2I-Adapter residuals
    inject into the cached deep branch and are rejected. Returns the final
    latents."""
    ex = extras or DenoiseExtras()
    if ex.controlnet_params is not None or ex.t2i_residuals is not None:
        raise ValueError(
            "deepcache does not support ControlNet/T2I-Adapter units")
    n = solvers.scan_length(solver_name, sigmas)
    use_cache = (np.arange(n) % int(cache_interval) != 0).astype(np.float64)
    b_in = latents.shape[0] * (2 if guidance_scale > 1.0 else 1)
    cache0 = torch.zeros(deepcache_shape(model_cfg.unet, b_in,
                                         latents.shape[1], latents.shape[2]),
                         dtype=compute_dtype, device=latents.device)
    cached = _step_cached(
        lambda model_in, t_b, cond, cache, use: unet_apply_deepcache(
            params["unet"], model_cfg.unet, model_in, t_b, cond, cache, use,
            attn_impl=attn_impl, conv_impl=conv_impl),
        cache0, use_cache)
    denoise = _make_denoiser(
        params, model_cfg, context, region_biases, log_sigma_table,
        guidance_scale, guidance_rescale, attn_impl, compute_dtype,
        conv_impl, extras, None,
        lambda model_in, t_b, cond: (cached(model_in, t_b, cond), None))
    return solvers.SOLVERS[solver_name][0](
        lambda x, sigma: denoise(x, sigma)[0], latents, sigmas)


def _denoise_once(params, x, context, region_biases, extras, *,
                  model_cfg: ModelConfig, sigma: float,
                  guidance_scale: float, guidance_rescale: float,
                  attn_impl: str, conv_impl: str,
                  log_sigma_table: torch.Tensor, compute_dtype):
    """One CFG-mixed denoised estimate x0_hat(x, sigma): the solvers'
    denoiser called once (bottleneck sampling's boundaries)."""
    denoise = make_denoise_fn(
        params, model_cfg, context, region_biases, log_sigma_table,
        guidance_scale, guidance_rescale, attn_impl,
        compute_dtype=compute_dtype, conv_impl=conv_impl, extras=extras,
        sigma_steps=np.asarray([sigma], np.float64))
    return denoise(x, _sigma_tensor(sigma, x.device))


class StableDiffusionTorch:
    """txt2img, img2img (on latents, or on images through ``encode_image``)
    and inpaint with optional region control, every solver and schedule of
    the app's sampler table, hires fix and chunked sampling.

    ``device`` defaults to CUDA and raises when there is none; CPU runs pass
    ``device="cpu"``. ``attn_impl`` takes the JAX package's kernel strings,
    "pallas[+qkbf16][+pvbf16][+exp2]" (see ``models.unet.flash_options``);
    ``conv_impl`` the resnet conv path, "xla" (the default: plain convs),
    "xla_bf16" (plain convs, output rounded to the compute dtype before the
    bias), "pallas" (K4) or "pallas2" (K5), for the UNet and both halves of
    the VAE alike. Anything else raises."""

    def __init__(self, model_cfg: ModelConfig, params: Dict[str, Any],
                 tokenizer=None, attn_impl: str = "pallas",
                 conv_impl: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.params = params
        self.tokenizer = tokenizer
        flash_options(attn_impl)  # raises on a string the port does not take
        self.attn_impl = attn_impl
        self.conv_impl = check_conv_impl(conv_impl)
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

    # -- conditioning units -------------------------------------------------

    def build_controlnet_extras(
        self, gen: GenerationConfig, controlnet_params: Sequence,
        cond_images: Sequence[torch.Tensor], scales: Sequence[float],
        starts: Optional[Sequence[float]] = None,
        ends: Optional[Sequence[float]] = None, guess_mode: bool = False,
        do_cfg: bool = True) -> DenoiseExtras:
        """ControlNet units: each image (B, H, W, 3) in [0, 1] at the
        request's size, moved to the device in fp32 and, with CFG and not in
        guess mode, doubled for the uncond half; a (units, steps) table of
        each unit's scale inside its [start, end) window, 0 outside."""
        n = len(controlnet_params)
        starts = list(starts or [0.0] * n)
        ends = list(ends or [1.0] * n)
        keeps = controlnet_keep_schedule(gen.num_inference_steps, starts,
                                         ends)
        imgs = []
        for img in cond_images:
            img = torch.as_tensor(img, dtype=torch.float32,
                                  device=self.device)
            if do_cfg and not guess_mode:
                img = torch.cat([img, img], dim=0)
            imgs.append(img)
        return DenoiseExtras(
            controlnet_params=list(controlnet_params),
            controlnet_images=imgs,
            controlnet_scales=keeps * np.asarray(scales, np.float32)[:, None],
            controlnet_guess=guess_mode)

    @torch.inference_mode()
    def build_t2i_extras(
        self, gen: GenerationConfig, adapter_params: Sequence,
        cond_images: Sequence[torch.Tensor], scales: Sequence[float],
        conditioning_factor: float = 1.0, do_cfg: bool = True,
        base: Optional[DenoiseExtras] = None,
        adapter_cfg: Optional[T2IAdapterConfig] = None) -> DenoiseExtras:
        """T2I-Adapter units: the adapters run once, here, in fp32 on the
        fp32 images (their weights cast up), and their scaled sum is kept
        (CFG-doubled with guidance); the residuals are active on the steps
        before ``int(steps * conditioning_factor)``. ``base``: extras to add
        them to (a request's ControlNet units)."""
        if adapter_cfg is None:  # the trunk's widths mirror the UNet's
            adapter_cfg = T2IAdapterConfig(
                channels=self.model_cfg.unet.block_out_channels)
        feats = multi_adapter_apply(
            adapter_params, adapter_cfg,
            [torch.as_tensor(i, dtype=torch.float32, device=self.device)
             for i in cond_images], scales)
        if do_cfg:
            feats = tuple(torch.cat([f, f], dim=0) for f in feats)
        steps = gen.num_inference_steps
        active = (np.arange(steps) < int(steps * conditioning_factor)
                  ).astype(np.float32)
        return dataclasses.replace(base or DenoiseExtras(),
                                   t2i_residuals=feats, t2i_active=active)

    @torch.inference_mode()
    def build_ip_extras(
        self, adapters: Sequence, image_embeds: Sequence,
        scales: Sequence[float], masks: Optional[Sequence] = None,
        uncond_image_embeds: Optional[Sequence] = None, do_cfg: bool = True,
        base: Optional[DenoiseExtras] = None) -> DenoiseExtras:
        """IP-Adapter units: each adapter (``models.ip_adapter
        .LoadedIPAdapter``) projects its image embeds ((B, D), or (B, P, D)
        for the Resampler) to tokens, with CFG [uncond tokens, cond tokens]
        (the uncond embeds as given, else zeros of the embeds); ``masks``:
        per adapter an optional (B, H, W) gate, doubled with CFG. The tokens
        and masks do not depend on the resolution, so a hires pass reuses
        them."""
        ip_tokens = []
        for i, (ad, emb) in enumerate(zip(adapters, image_embeds)):
            emb = on_device(emb, self.device)
            tok = ad.project(emb)
            if do_cfg:
                u_emb = (on_device(uncond_image_embeds[i], self.device)
                         if uncond_image_embeds is not None
                         else torch.zeros_like(emb))
                tok = torch.cat([ad.project(u_emb), tok], dim=0)
            ip_tokens.append(tok)
        mask_tuple = None
        if masks is not None:
            mask_tuple = tuple(
                None if m is None
                else torch.cat([on_device(m, self.device)]
                               * (2 if do_cfg else 1))
                for m in masks)
        return dataclasses.replace(
            base or DenoiseExtras(), ip_tokens=tuple(ip_tokens),
            ip_scales=tuple(float(s) for s in scales), ip_masks=mask_tuple)

    # -- sampling -----------------------------------------------------------

    def _schedule(self, gen: GenerationConfig):
        """(sigmas, the solver's default options)."""
        _, _, defaults = solvers.SOLVERS[gen.sampler]
        sigmas = schedules.get_sigmas(
            self.model_cfg, gen.num_inference_steps, gen.schedule,
            defaults.get("discard_next_to_last_sigma", False))
        return sigmas, defaults

    def _cut_schedule(self, gen: GenerationConfig, strength: float):
        """The sigmas of the last ``strength`` of the schedule (img2img and
        inpaint)."""
        sigmas, _ = self._schedule(gen)
        steps = gen.num_inference_steps
        return sigmas[max(steps - min(int(steps * strength), steps), 0):]

    def _solver_noise(self, seeds: Sequence[int], sigmas: np.ndarray,
                      shape: Tuple[int, ...], solver_name: str,
                      skip: int = 1):
        """The per-step noise table of ``shape`` = (B, h, w, 4), or None for
        a deterministic solver; ``skip``: the draws each stream made before
        it (``brownian.step_noise``)."""
        _, draws, _ = solvers.SOLVERS[solver_name]
        if draws == 0:
            return None
        return brownian.step_noise(
            seeds, solvers.scan_length(solver_name, sigmas), draws,
            tuple(shape[1:]), self.device, skip=skip)

    def _solver_opts(self, gen: GenerationConfig, defaults: dict) -> dict:
        opts = {k: v for k, v in defaults.items()
                if k not in ("discard_next_to_last_sigma", "brownian")}
        if gen.sampler in ("euler_ancestral", "dpm_2_ancestral",
                           "dpmpp_2s_ancestral", "dpmpp_sde", "dpmpp_2m_sde",
                           "dpmpp_2m_sde_heun", "dpmpp_3m_sde"):
            opts["eta"] = gen.eta
        return opts

    def _denoiser(self, context, region_biases, gen, sigmas, extras=None,
                  mesh=None):
        return make_denoise_fn(
            self.params, self.model_cfg, context.to(self.device),
            region_biases, self.log_sigma_table, gen.guidance_scale,
            gen.guidance_rescale, self.attn_impl, compute_dtype=gen.dtype,
            conv_impl=self.conv_impl, extras=extras,
            sigma_steps=sigmas[:-1], mesh=mesh)

    def _decode(self, x, uint8_output, cond_image=None, cond_mask=None):
        images = vae_decode(self.params["vae"], self.model_cfg.vae, x,
                            cond_image=cond_image, cond_mask=cond_mask,
                            conv_impl=self.conv_impl)
        return to_uint8(images) if uint8_output else images

    def _sample(self, x, context, region_biases, sigmas, gen, noise, decode,
                uint8_output, return_history=False, extras=None, mesh=None):
        solver_fn, _, defaults = solvers.SOLVERS[gen.sampler]
        res = solver_fn(self._denoiser(context, region_biases, gen, sigmas,
                                       extras, mesh),
                        x, sigmas, noise=noise,
                        return_history=return_history,
                        **self._solver_opts(gen, defaults))
        x, hist = res if return_history else (res, None)
        if decode:
            x = self._decode(x, uint8_output)
        return (x, hist) if return_history else x

    def _init(self, gen, sigmas, seed, batch_size, latents):
        """(seeds, scaled initial latents, solver noise) of a txt2img run."""
        if latents is not None:
            latents = torch.as_tensor(latents, dtype=torch.float32,
                                      device=self.device)
            batch_size = latents.shape[0]
        seeds = _seed_list(seed, batch_size)
        shape = (gen.latent_height, gen.latent_width, 4)
        if latents is None:
            latents = initial_noise(seeds, shape, self.device)
        if len(seeds) != latents.shape[0]:
            raise ValueError(f"seed list length {len(seeds)} != batch "
                             f"{latents.shape[0]}")
        x = latents * float(np.sqrt(sigmas[0] ** 2 + 1.0))
        noise = self._solver_noise(seeds, sigmas, (len(seeds),) + shape,
                                   gen.sampler)
        return x, noise

    @torch.inference_mode()
    def txt2img(self, context: torch.Tensor, gen: GenerationConfig,
                seed: SeedT = 0, region_biases=None, batch_size: int = 1,
                decode: bool = True, latents: Optional[torch.Tensor] = None,
                extras: Optional[DenoiseExtras] = None,
                hires: Optional[dict] = None, return_history: bool = False,
                uint8_output: bool = False, mesh=None):
        """txt2img on a pre-encoded context. Returns images (B, H, W, 3),
        fp32 in [-1, 1] (uint8 with ``uint8_output``), or the final latents
        with ``decode=False``. ``gen.sampler`` names a solver of
        ``samplers.solvers.SOLVERS`` and ``gen.schedule`` its schedule (the
        app's sampler names map to both through ``registry.SAMPLERS``).

        ``seed``: an int, or a list with one seed per sample. An int seed
        with ``batch_size`` B seeds the samples with seed, seed+1, ...
        ``latents``: (B, h, w, 4) standard-normal initial latents to use
        instead of the seeded draw; they are scaled by sqrt(sigma_0^2+1).
        The solver noise comes from the seeds either way.
        ``extras``: the units' inputs (``build_controlnet_extras``,
        ``build_t2i_extras``, ``build_ip_extras``).

        ``hires``: optional dict(scale=2.0, strength=0.6, steps=None,
        mode="bilinear", antialias=False, sampler=None, schedule=None,
        region_state=None, rebuild_extras=None), as in the JAX package: the
        base pass's latents are resized by ``scale`` (modes of
        ``ops.resize``) and refined by ``img2img`` at the target size, with
        the seed ``_next_seed(seed)`` and, where given, another solver and
        schedule. ``region_state`` = (states, prompt ids,
        num_images_per_prompt) re-encodes the region map at the target
        size; without it the hires pass runs without region control. The
        ControlNet images and T2I residuals are bound to the base size:
        ``rebuild_extras`` = fn(the hires pass's GenerationConfig) ->
        ``DenoiseExtras`` rebuilds them for the hires pass, and such
        extras without it raise ``ValueError``; IP-Adapter tokens and masks
        pass to the hires pass as they are. The ``uint8_output`` flag applies
        to the hires pass's images.

        ``return_history``: also return the latents after every step,
        (n_steps, B, h, w, 4); with hires, ``(images, [base history, hires
        history])``.

        ``mesh`` (``parallel.mesh.Mesh``): this rank's part of a
        data-parallel batch. Every input is the rank's own shard (its
        samples' context and biases in the [uncond..., cond...] layout,
        their seeds, units and latents) and so is the result; the region
        std is all-reduced over the mesh, so it stays global over the whole
        batch (``parallel.batched.generate_grid`` shards and gathers)."""
        sigmas, _ = self._schedule(gen)
        x, noise = self._init(gen, sigmas, seed, batch_size, latents)
        out = self._sample(x, context, region_biases, sigmas, gen, noise,
                           decode and hires is None, uint8_output,
                           return_history, extras, mesh)
        if hires is None:
            return out
        base_history = None
        if return_history:
            out, base_history = out

        scale = float(hires.get("scale", 2.0))
        new_h = int(gen.height * scale) // 8
        new_w = int(gen.width * scale) // 8
        up = resize_latents(out, new_h, new_w,
                            mode=hires.get("mode", "bilinear"),
                            antialias=bool(hires.get("antialias", False)))
        gen_hr = dataclasses.replace(
            gen, height=new_h * 8, width=new_w * 8,
            num_inference_steps=hires.get("steps") or gen.num_inference_steps,
            sampler=hires.get("sampler") or gen.sampler,
            schedule=hires.get("schedule") or gen.schedule)
        hr_biases = None
        if hires.get("region_state") is not None:
            states, ids, nipp = hires["region_state"]
            hr_biases = self.encode_region(
                states, ids, height=gen_hr.height, width=gen_hr.width,
                num_images_per_prompt=nipp,
                do_cfg=gen_hr.guidance_scale > 1.0)
        hr_extras = extras
        if hires.get("rebuild_extras") is not None:
            hr_extras = hires["rebuild_extras"](gen_hr)
        elif extras is not None and (extras.controlnet_images is not None
                                     or extras.t2i_residuals is not None):
            raise ValueError(
                "hires with ControlNet/T2I units needs "
                "hires['rebuild_extras'] (a fn(gen_hr) -> DenoiseExtras "
                "re-preparing the unit images at the target resolution); "
                "base-resolution extras cannot drive the hires pass")
        hr_out = self.img2img(context, up, gen_hr,
                              strength=float(hires.get("strength", 0.6)),
                              seed=_next_seed(seed), region_biases=hr_biases,
                              decode=decode, extras=hr_extras,
                              uint8_output=uint8_output,
                              return_history=return_history, mesh=mesh)
        if return_history:
            hr_out, hr_history = hr_out
            return hr_out, [base_history, hr_history]
        return hr_out

    @torch.inference_mode()
    def img2img(self, context: torch.Tensor, init_latents: torch.Tensor,
                gen: GenerationConfig, strength: float = 0.8,
                seed: SeedT = 0, region_biases=None, decode: bool = True,
                extras: Optional[DenoiseExtras] = None,
                return_history: bool = False, uint8_output: bool = False,
                mesh=None):
        """img2img on latents: the schedule is cut by ``strength`` and the
        init latents are noised to its first sigma. ``init_latents`` are
        (B, h, w, 4) *scaled* latents; ``seed``, ``extras`` and ``mesh`` as
        in ``txt2img``. The units' per-step tables have a column a step of
        ``gen``; the cut schedule's steps read their first columns, as in
        the JAX package. Returns what ``txt2img`` returns."""
        sigma_sched = self._cut_schedule(gen, strength)
        init = torch.as_tensor(init_latents, dtype=torch.float32,
                               device=self.device)
        seeds = _batch_seeds(seed, init.shape[0], "img2img")
        noise0 = initial_noise(seeds, tuple(init.shape[1:]), self.device)
        x = init + noise0 * float(np.sqrt(sigma_sched[0] ** 2 + 1.0))
        noise = self._solver_noise(seeds, sigma_sched, tuple(init.shape),
                                   gen.sampler)
        return self._sample(x, context, region_biases, sigma_sched, gen,
                            noise, decode, uint8_output, return_history,
                            extras, mesh)

    @torch.inference_mode()
    def inpaint(self, context: torch.Tensor, init_image: torch.Tensor,
                mask: torch.Tensor, gen: GenerationConfig,
                strength: float = 1.0, seed: SeedT = 0, region_biases=None,
                decode: bool = True, extras: Optional[DenoiseExtras] = None,
                return_history: bool = False, uint8_output: bool = False):
        """Inpaint ``init_image`` (B, H, W, 3) in [-1, 1] where ``mask``
        (B, H, W) is 1 (regenerate); ``seed`` as in ``txt2img``.

        The schedule is cut by ``strength`` as in img2img. A 4-channel UNet
        gets the known region blended back at every denoiser call (the
        latents the solver returns stay unblended, as in the JAX package); a
        9-channel inpaint UNet gets [mask, masked-image latents] as extra
        input channels. The latents start from pure noise when ``strength``
        >= 1 or the UNet has 9 channels, else from the init image's latents
        noised to the first sigma. An asymmetric VAE decodes with the masked
        init image and the mask as its condition. ``extras`` (units) are
        merged with the inpaint fields.

        Each sample's generator draws, in order: the posterior draw (shared
        by both encodes of a 9-channel request, as JAX shares its key), the
        initial latents, the blend noise (4-channel UNets only), then the
        solver noise. A 9-channel request never reads the unmasked image's
        latents, so it does not encode the unmasked image.

        Returns what ``txt2img`` returns (with ``return_history``, the
        history of the unblended latents)."""
        init = torch.as_tensor(init_image, dtype=torch.float32,
                               device=self.device)
        mask = torch.as_tensor(mask, dtype=torch.float32, device=self.device)
        b, h, w, _ = init.shape
        if tuple(mask.shape) != (b, h, w):
            raise ValueError(f"mask {tuple(mask.shape)} must be (B, H, W) = "
                             f"{(b, h, w)}")
        seeds = _batch_seeds(seed, b, "inpaint")
        latent_shape = (h // 8, w // 8, 4)
        nine_channel = self.model_cfg.unet.in_channels == 9
        draws = seeded_normals(seeds, latent_shape, 2 if nine_channel else 3,
                               self.device)
        eps, noise0 = draws[0], draws[1]
        sigma_sched = self._cut_schedule(gen, strength)
        mask_full = mask[..., None]
        mask_l = resize_latents(mask_full, h // 8, w // 8, mode="nearest")
        masked_image = init * (1.0 - mask_full)
        image_latents = None
        extras = extras or DenoiseExtras()
        if nine_channel:
            extra = torch.cat([mask_l, self._encode(masked_image, eps)],
                              dim=-1)
            if gen.guidance_scale > 1.0:
                extra = torch.cat([extra, extra], dim=0)
            extras = dataclasses.replace(extras, extra_channels=extra)
        else:
            image_latents = self._encode(init, eps)
            extras = dataclasses.replace(
                extras, inpaint_mask=mask_l,
                inpaint_image_latents=image_latents, inpaint_noise=draws[2])
        x = noise0 * float(np.sqrt(sigma_sched[0] ** 2 + 1.0))
        if strength < 1.0 and not nine_channel:
            x = image_latents + x
        noise = self._solver_noise(seeds, sigma_sched, (b,) + latent_shape,
                                   gen.sampler, skip=draws.shape[0])
        asym = self.model_cfg.vae.asymmetric
        out = self._sample(x, context, region_biases, sigma_sched, gen, noise,
                           decode and not asym, uint8_output, return_history,
                           extras)
        if not (decode and asym):
            return out
        out, history = out if return_history else (out, None)
        out = self._decode(out, uint8_output, cond_image=masked_image,
                           cond_mask=mask_full)
        return (out, history) if return_history else out

    # -- codecs -------------------------------------------------------------

    def _encode(self, images, eps):
        return vae_encode(self.params["vae"], self.model_cfg.vae, images,
                          eps=eps, conv_impl=self.conv_impl)

    @torch.inference_mode()
    def encode_image(self, images: torch.Tensor, seed: SeedT = 0
                     ) -> torch.Tensor:
        """images (B, H, W, 3) in [-1, 1] -> scaled latents (B, H/8, W/8, 4),
        one posterior draw a sample (``posterior_noise``) for seed, seed +
        1, ... (or for each seed of a list): a stream that ``img2img`` and
        ``txt2img`` of the same seed never draw from."""
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device)
        b, h, w, _ = images.shape
        seeds = _batch_seeds(seed, b, "encode_image")
        eps = posterior_noise(seeds, (h // 8, w // 8, 4), self.device)
        return self._encode(images, eps)

    @torch.inference_mode()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, h, w, 4) -> fp32 images (B, 8h, 8w, 3) in
        [-1, 1]."""
        return self._decode(torch.as_tensor(latents, device=self.device),
                            False)

    @torch.inference_mode()
    def sample_chunked(self, context: torch.Tensor, gen: GenerationConfig,
                       seed: SeedT = 0, region_biases=None,
                       batch_size: int = 1,
                       extras: Optional[DenoiseExtras] = None,
                       chunk_steps: int = 8, on_chunk=None,
                       latents: Optional[torch.Tensor] = None,
                       decode: bool = True, uint8_output: bool = False,
                       resume: Optional[ChunkedPause] = None):
        """txt2img that returns to the caller every ``chunk_steps`` solver
        steps: after each chunk it waits for the device and calls
        ``on_chunk(steps_done, steps_total)``, which may raise to cancel the
        run or return ``False`` to pause it; a paused run returns a
        :class:`ChunkedPause`, and passing that back as ``resume=`` with the
        same other arguments continues it. The chunks run the same step loop
        over slices of the full schedule with the solver's carry passed
        through, so the result is bitwise equal to ``txt2img``'s, paused or
        not. ``dpm_fast`` and ``dpm_adaptive`` have no fixed steps to slice
        and raise ``ValueError``. The units' step index (``extras``) is taken
        on the full schedule."""
        if gen.sampler not in solvers.CHUNKABLE:
            raise ValueError(
                f"solver {gen.sampler!r} does not support chunked execution "
                f"(host-unrolled or adaptive)")
        sigmas, defaults = self._schedule(gen)
        latents, noise = self._init(gen, sigmas, seed, batch_size, latents)
        n_total = solvers.scan_length(gen.sampler, sigmas)
        if resume is not None:
            if resume.n_total != n_total:
                raise ValueError(
                    "resume state was captured under a different schedule "
                    f"({resume.n_total} steps vs {n_total})")
            carry, x, pos = resume.carry, resume.x, int(resume.pos)
        else:
            carry, x, pos = None, latents, 0
        solver_fn = solvers.SOLVERS[gen.sampler][0]
        denoise = self._denoiser(context, region_biases, gen, sigmas, extras)
        opts = self._solver_opts(gen, defaults)
        while pos < n_total:
            size = min(int(chunk_steps), n_total - pos)
            x, carry = solver_fn(denoise, latents, sigmas, noise=noise,
                                 carry_in=carry, segment=(pos, size),
                                 return_carry=True, **opts)
            if x.is_cuda:  # the re-entry point: the chunk has run
                torch.cuda.synchronize(x.device)
            pos += size
            if on_chunk is not None and on_chunk(pos, n_total) is False \
                    and pos < n_total:
                return ChunkedPause(x=x, carry=carry, pos=pos,
                                    n_total=n_total)
        return self._decode(x, uint8_output) if decode else x

    # -- opt-in speed modes (no reference counterpart) ----------------------

    def _core_statics(self, gen: GenerationConfig, sigmas) -> dict:
        """The keyword arguments the mode cores share."""
        return dict(model_cfg=self.model_cfg, solver_name=gen.sampler,
                    sigmas=sigmas, guidance_scale=gen.guidance_scale,
                    guidance_rescale=gen.guidance_rescale,
                    attn_impl=self.attn_impl, conv_impl=self.conv_impl,
                    log_sigma_table=self.log_sigma_table,
                    compute_dtype=gen.dtype)

    @torch.inference_mode()
    def txt2img_cfg_tail(self, context: torch.Tensor, gen: GenerationConfig,
                         tail_frac: float, seed: SeedT = 0,
                         region_biases=None, batch_size: int = 1,
                         extras: Optional[DenoiseExtras] = None,
                         decode: bool = True, uint8_output: bool = False):
        """txt2img with the last ``tail_frac`` of the solver steps run on the
        cond half alone, guidance off: ``sample_chunked`` paused at the
        cutoff, then resumed (the same carry and noise) on
        ``cond_half_conditioning``. At least one step keeps CFG;
        ``tail_frac`` that leaves no tail, or guidance already off, is
        ``txt2img`` itself, bit for bit."""
        sigmas, _ = self._schedule(gen)
        n_total = solvers.scan_length(gen.sampler, sigmas)
        n_tail = int(round(n_total * float(tail_frac)))
        cutoff = max(1, n_total - n_tail)  # keep >= 1 CFG step
        if cutoff >= n_total or gen.guidance_scale <= 1.0:
            return self.txt2img(context, gen, seed=seed,
                                region_biases=region_biases,
                                batch_size=batch_size, extras=extras,
                                decode=decode, uint8_output=uint8_output)
        pause = self.sample_chunked(
            context, gen, seed=seed, region_biases=region_biases,
            batch_size=batch_size, extras=extras, chunk_steps=cutoff,
            on_chunk=lambda done, total: done < cutoff, decode=False)
        ctx2, rb2, ex2 = cond_half_conditioning(context, region_biases,
                                                extras)
        return self.sample_chunked(
            ctx2, dataclasses.replace(gen, guidance_scale=1.0), seed=seed,
            region_biases=rb2, batch_size=batch_size, extras=ex2,
            chunk_steps=n_total, resume=pause, decode=decode,
            uint8_output=uint8_output)

    @torch.inference_mode()
    def txt2img_tgate(self, context: torch.Tensor, gen: GenerationConfig,
                      gate_frac: float = 0.5, seed: SeedT = 0,
                      region_biases=None, batch_size: int = 1,
                      extras: Optional[DenoiseExtras] = None,
                      decode: bool = True, uint8_output: bool = False):
        """TGATE (temporal attention decomposition, ``_tgate_core``): the
        cross-attention outputs are frozen after round(gate_frac * steps)
        steps (at least 1) and the uncond half is dropped. ``gate_frac``
        >= 1 is ``txt2img`` itself, bit for bit. Euler and DPM++ 2M only
        (the gate's sigma must be the step's)."""
        sigmas, defaults = self._schedule(gen)
        n_total = solvers.scan_length(gen.sampler, sigmas)
        gate = int(round(n_total * float(gate_frac)))
        if gate >= n_total:
            return self.txt2img(context, gen, seed=seed,
                                region_biases=region_biases,
                                batch_size=batch_size, extras=extras,
                                decode=decode, uint8_output=uint8_output)
        gate = max(1, gate)
        if gen.sampler not in solvers.DEEPCACHE_SOLVERS:
            raise ValueError(
                f"tgate supports {sorted(solvers.DEEPCACHE_SOLVERS)}, "
                f"not {gen.sampler!r}")
        x, noise = self._init(gen, sigmas, seed, batch_size, None)
        x = _tgate_core(self.params, x, context.to(self.device),
                        region_biases, noise, extras, gate=gate,
                        solver_opts=self._solver_opts(gen, defaults),
                        **self._core_statics(gen, sigmas))
        return self._decode(x, uint8_output) if decode else x

    @torch.inference_mode()
    def txt2img_deepcache(self, context: torch.Tensor, gen: GenerationConfig,
                          cache_interval: int = 3, seed: SeedT = 0,
                          region_biases=None, batch_size: int = 1,
                          extras: Optional[DenoiseExtras] = None,
                          decode: bool = True, uint8_output: bool = False):
        """txt2img with DeepCache's deep-feature reuse
        (``_sample_deepcache_core``): every ``cache_interval``-th step runs
        the full UNet, the others its shallow layers. ``cache_interval=1``
        runs every step in full and equals ``txt2img`` but for rounding.
        Euler and DPM++ 2M only; ControlNet / T2I-Adapter units raise."""
        if gen.sampler not in solvers.DEEPCACHE_SOLVERS:
            raise ValueError(
                f"deepcache supports {sorted(solvers.DEEPCACHE_SOLVERS)}, "
                f"not {gen.sampler!r}")
        sigmas, _ = self._schedule(gen)
        x, _ = self._init(gen, sigmas, seed, batch_size, None)
        x = _sample_deepcache_core(
            self.params, x, context.to(self.device), region_biases, extras,
            cache_interval=int(cache_interval),
            **self._core_statics(gen, sigmas))
        return self._decode(x, uint8_output) if decode else x

    @torch.inference_mode()
    def txt2img_bottleneck(self, context: torch.Tensor,
                           gen: GenerationConfig, low_scale: float = 0.5,
                           mid_frac: Tuple[float, float] = (0.2, 0.8),
                           seed: SeedT = 0, region_biases=None,
                           region_state=None, batch_size: int = 1,
                           extras: Optional[DenoiseExtras] = None,
                           decode: bool = True, uint8_output: bool = False):
        """Bottleneck sampling: the first ``mid_frac[0]`` of the schedule at
        full resolution, the middle at ``low_scale`` of the latent size
        (8-aligned, at least 8), the tail at full size again. Each phase
        restarts the solver; at each boundary the denoised estimate x0_hat
        (``_denoise_once``) is resized bilinearly (``resize_latents``, no
        antialiasing, as the JAX package's) and re-noised at the boundary
        sigma with ``bottleneck_draws``'s draws. ``region_state`` = (states,
        prompt ids, num_images_per_prompt) re-encodes the map at each size;
        precomputed ``region_biases`` alone raise, as do resolution-bound
        extras (ControlNet, T2I-Adapter, inpaint); IP tokens pass. Euler
        and DPM++ 2M only."""
        if gen.sampler not in solvers.DEEPCACHE_SOLVERS:
            raise ValueError(
                f"bottleneck sampling supports "
                f"{sorted(solvers.DEEPCACHE_SOLVERS)}, not {gen.sampler!r}")
        ex = extras or DenoiseExtras()
        if (ex.controlnet_params is not None or ex.t2i_residuals is not None
                or ex.inpaint_mask is not None
                or ex.extra_channels is not None):
            raise ValueError(
                "bottleneck sampling does not support resolution-bound "
                "extras (ControlNet / T2I-Adapter / inpaint)")
        if region_biases is not None and region_state is None:
            raise ValueError(
                "bottleneck sampling needs region_state (raw states + "
                "prompt ids) to re-encode biases at the low resolution; "
                "precomputed region_biases alone cannot serve both sizes")
        sigmas, _ = self._schedule(gen)
        n = len(sigmas) - 1
        i1 = max(1, int(round(n * float(mid_frac[0]))))
        i2 = min(n - 1, int(round(n * float(mid_frac[1]))))
        if not i1 < i2:
            raise ValueError(f"mid_frac {mid_frac} leaves no middle phase "
                             f"for {n} steps")
        lh, lw = gen.latent_height, gen.latent_width
        # the UNet downsamples 3x: keep the low-res latent 8-aligned
        bh = max(8, int(round(lh * float(low_scale) / 8)) * 8)
        bw = max(8, int(round(lw * float(low_scale) / 8)) * 8)
        seeds = _seed_list(seed, batch_size)
        latents, eps_lo, eps_hi = bottleneck_draws(
            seeds, (bh, bw, 4), (lh, lw, 4), self.device)
        x, _ = self._init(gen, sigmas, seeds, batch_size, latents)
        hi_biases, lo_biases = region_biases, None
        if region_state is not None:
            states, ids, nipp = region_state
            do_cfg = gen.guidance_scale > 1.0
            hi_biases = self.encode_region(
                states, ids, height=lh * 8, width=lw * 8,
                num_images_per_prompt=nipp, do_cfg=do_cfg)
            lo_biases = self.encode_region(
                states, ids, height=bh * 8, width=bw * 8,
                num_images_per_prompt=nipp, do_cfg=do_cfg)
        statics = self._core_statics(gen, sigmas)
        for k in ("solver_name", "sigmas"):
            statics.pop(k)

        def boundary(x, sigma, new_h, new_w, biases, eps):
            x0 = _denoise_once(self.params, x, context.to(self.device),
                               biases, extras, sigma=float(sigma), **statics)
            return (resize_latents(x0, new_h, new_w, mode="bilinear")
                    + float(sigma) * eps)

        x = self._sample(x, context, hi_biases, sigmas[:i1 + 1], gen, None,
                         False, False, extras=extras)
        x = boundary(x, sigmas[i1], bh, bw, hi_biases, eps_lo)
        x = self._sample(x, context, lo_biases, sigmas[i1:i2 + 1], gen, None,
                         False, False, extras=extras)
        x = boundary(x, sigmas[i2], lh, lw, lo_biases, eps_hi)
        return self._sample(x, context, hi_biases, sigmas[i2:], gen, None,
                            decode, uint8_output, extras=extras)

    to_uint8 = staticmethod(to_uint8)
