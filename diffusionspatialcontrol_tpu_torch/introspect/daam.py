"""DAAM-style cross-attention heatmaps (port of ``introspect/daam.py``).

Given the latent trajectory of a generation (any solver, through
``return_history=True``), the UNet is run again at chosen steps with its
heatmap taps on (``unet_apply(collect_heatmaps=True)``: the attention
outputs still come from the kernels, the probabilities from
``ops.attention.attention_probs`` in plain torch), and each token's
attention mass over all cross-attention layers is summed, upsampled to the
latent grid. The replay keeps the sampling loop free of introspection cost
and works for every solver.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..models.unet import RegionState, UNetCond, unet_apply
from ..ops.region_map import phrase_token_counts
from ..ops.resize import resize
from ..pipeline.pipeline import _sigma_tensor, _sigma_to_t
from ..samplers import schedules


@torch.inference_mode()
def heatmaps_for_state(
    params,
    model_cfg: ModelConfig,
    x: torch.Tensor,  # (B, h, w, 4) sigma-space latents at this step
    sigma: float,
    context: torch.Tensor,  # (B, S, D) cond-half context
    region_biases: Optional[Tuple[torch.Tensor, ...]] = None,
) -> torch.Tensor:
    """(B, h, w, S) fp32 attention mass of one denoising state, summed over
    heads and layers, each layer's map resized bilinearly to the latent
    grid. The UNet runs on ``x``'s device in ``context``'s dtype."""
    b, h, w, _ = x.shape
    dev = x.device
    log_table = torch.tensor(np.log(schedules.ddpm_sigma_table(model_cfg)),
                             dtype=torch.float32, device=dev)
    sig = _sigma_tensor(sigma, dev)
    c_in = 1.0 / torch.sqrt(sig ** 2 + 1.0)
    t_b = _sigma_to_t(sig, log_table).expand(b)
    region = None if region_biases is None else RegionState(region_biases,
                                                            sig)
    _, maps = unet_apply(params["unet"], model_cfg.unet,
                         (x * c_in).to(context.dtype), t_b,
                         UNetCond(context=context, region=region),
                         collect_heatmaps=True)
    s_len = maps[0][1].shape[-1]
    acc = torch.zeros((b, h, w, s_len), dtype=torch.float32, device=dev)
    for level, m in maps:
        m = m.reshape(b, h // 2 ** level, w // 2 ** level, s_len)
        acc = acc + resize(m, (b, h, w, s_len), "linear")
    return acc


def heatmaps_for_trajectory(
    params,
    model_cfg: ModelConfig,
    history: torch.Tensor,  # (n_steps, B, h, w, 4) from return_history=True
    sigmas: Sequence[float],  # the schedule (its first n_steps are read)
    context: torch.Tensor,
    region_biases=None,
    step_stride: int = 1,
    normalize: bool = True,
) -> torch.Tensor:
    """Heatmaps summed over a generation, (B, h, w, S). ``history[i]`` is
    the latent after step i, so the model state at step i + 1 is
    (history[i], sigmas[i + 1]); every ``step_stride``-th of them is
    replayed. ``normalize`` divides each map by its maximum."""
    acc = None
    for i in range(0, history.shape[0] - 1, step_stride):
        hm = heatmaps_for_state(params, model_cfg, history[i],
                                float(sigmas[i + 1]), context, region_biases)
        acc = hm if acc is None else acc + hm
    if acc is None:
        raise ValueError("empty trajectory")
    if normalize:
        mx = acc.amax(dim=(1, 2), keepdim=True)
        acc = acc / torch.clamp(mx, min=1e-8)
    return acc


def token_heatmap(heatmaps: torch.Tensor, token_positions: Sequence[int]):
    """The heatmap of a phrase at the given token positions, (B, h, w)."""
    return heatmaps[..., list(token_positions)].sum(-1)


def attention_mass_in_mask(heatmaps: torch.Tensor,
                           token_positions: Sequence[int],
                           mask_latent) -> torch.Tensor:
    """The share of a phrase's attention mass inside its mask, (B,).
    ``heatmaps``: (B, h, w, S), not normalized; ``mask_latent``: (h, w) in
    [0, 1]."""
    tok = token_heatmap(heatmaps, token_positions)
    m = torch.as_tensor(mask_latent, dtype=torch.float32,
                        device=tok.device)[None]
    inside = (tok * m).sum(dim=(1, 2))
    total = tok.sum(dim=(1, 2))
    return inside / torch.clamp(total, min=1e-12)


def region_compliance(
    pipe,
    gen,
    prompt: str,
    neg_prompt: str,
    state: Optional[dict],
    seed=0,
    encoding_mode: str = "short",
    step_stride: int = 1,
):
    """For each phrase of ``state`` ({phrase: {mask, weight,
    mask_outsides}}), the share of its cross-attention mass inside its mask
    over one generation of batch item 0: txt2img with the map (without one
    when every weight is 0), its trajectory replayed through the heatmaps on
    the cond half. The masks say where the share is measured, the weights
    how strong the control is; a larger weight must pull more mass into the
    mask. Returns {phrase: float} (NaN for a phrase not in the prompt)."""
    ctx, ids = pipe.encode_prompt([prompt], [neg_prompt],
                                  clip_skip=gen.clip_skip,
                                  mode=encoding_mode)
    any_weight = state and any(
        float(v.get("weight", 0.0)) != 0.0 for v in state.values())
    biases = None
    if any_weight:
        biases = pipe.encode_region([state], ids, height=gen.height,
                                    width=gen.width, do_cfg=True)
    _, hist = pipe.txt2img(ctx, gen, seed=seed, decode=False,
                           return_history=True, region_biases=biases)
    sigmas, _ = pipe._schedule(gen)
    half = ctx.shape[0] // 2
    cond_biases = None
    if biases is not None:
        cond_biases = tuple(b[b.shape[0] // 2:] for b in biases)
    maps = heatmaps_for_trajectory(
        pipe.params, pipe.model_cfg, hist, sigmas,
        ctx[half:].to(hist.device), cond_biases, step_stride=step_stride,
        normalize=False)
    h, w = gen.latent_height, gen.latent_width
    out = {}
    for phrase, spec in (state or {}).items():
        p_ids = pipe.tokenizer.encode(phrase, add_special_tokens=False)
        counts = phrase_token_counts(ids[0], [p_ids])[0]
        positions = [i for i, c in enumerate(counts) if c > 0]
        if not positions:
            out[phrase] = float("nan")
            continue
        mask = torch.from_numpy(np.asarray(spec["mask"], np.float32))
        mask_lat = (resize(mask, (h, w), "linear") >= 0.5).float()
        frac = attention_mass_in_mask(maps, positions, mask_lat)
        out[phrase] = float(frac[0])
    return out
