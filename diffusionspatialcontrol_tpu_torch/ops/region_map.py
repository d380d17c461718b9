"""Region-map encoding: phrase masks -> per-resolution cross-attention biases
(port of ``ops/region_map.py``).

Host side, n-gram matching of each phrase's token ids in the prompt ids
gives a per-phrase token-count row. Then each mask is binarized,
bicubic-resized to every UNet level (ratios 8, 16, 32, 64), rounded and
re-binarized against its maximum (the reference's uint8 resize + ``== max``),
given strength S inside and -S' outside, and contracted with the counts into
an (L_r, S_text) bias.

``jax.image.resize(..., "cubic")`` antialiases when it downsamples (Keys
cubic, a = -0.5, widened by the ratio); ``F.interpolate(mode="bicubic",
antialias=True)`` computes the same filter. Without ``antialias`` the
binarized pixels flip at ratios 8 and 16.

The uncond half of the CFG batch gets the same bias as the cond half (the
reference replaces the negative-prompt ids by the positive ones before
matching).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LEVEL_RATIOS = (8, 16, 32, 64)


def phrase_token_counts(prompt_ids: Sequence[int],
                        phrase_ids: Sequence[Sequence[int]]) -> np.ndarray:
    """(P, S) matrix: counts[p, s] = occurrences of phrase p's token n-gram
    covering prompt position s."""
    prompt_ids = list(prompt_ids)
    s_len = len(prompt_ids)
    counts = np.zeros((len(phrase_ids), s_len), np.float32)
    for p, ids in enumerate(phrase_ids):
        ids = list(ids)
        n = len(ids)
        if n == 0:
            continue
        for idx in range(s_len):
            if prompt_ids[idx: idx + n] == ids:
                counts[p, idx: idx + n] += 1.0
    return counts


def level_shape(height: int, width: int, ratio: int) -> Tuple[int, int]:
    """ceil(H/r), ceil(W/r)."""
    return (-(-height // ratio), -(-width // ratio))


def rasterize_region_biases(masks: torch.Tensor, weights: torch.Tensor,
                            mask_outsides: torch.Tensor,
                            token_counts: torch.Tensor, *, height: int,
                            width: int) -> Tuple[torch.Tensor, ...]:
    """masks (P, Hm, Wm) binary; weights, mask_outsides (P,); token_counts
    (P, S_text). Returns one (L_r, S_text) fp32 bias per level ratio."""
    p = masks.shape[0]
    masks = masks.float()
    out = []
    for ratio in LEVEL_RATIOS:
        h_r, w_r = level_shape(height, width, ratio)
        # in float64, then rounded to fp32: a pixel the filter centres on a
        # mask's edge is 0.5 exactly and rounds (half to even) to 0, where
        # an fp32 sum lands an ulp either side (JAX's fp32 resize does not
        # sum in torch's order)
        m = F.interpolate(masks[None].double(), size=(h_r, w_r),
                          mode="bicubic", align_corners=False,
                          antialias=True)[0].float()
        m = torch.round(torch.clamp(m, 0.0, 255.0))
        mx = m.amax(dim=(1, 2), keepdim=True)
        m = (m == mx).float()
        pix = m * weights[:, None, None] + (1.0 - m) * (
            -mask_outsides[:, None, None])
        pix = pix.reshape(p, h_r * w_r)
        out.append(torch.einsum("pl,ps->ls", pix, token_counts.float()))
    return tuple(out)


def encode_region_state(
    states: Sequence[Optional[Dict]],
    prompt_ids_per_prompt: Sequence[Sequence[int]],
    phrase_tokenize,  # callable: str -> List[int] (no special tokens)
    *,
    height: int,
    width: int,
    num_images_per_prompt: int = 1,
    do_cfg: bool = True,
    device=None,
) -> Tuple[torch.Tensor, ...]:
    """Per-level bias tensors (B_cfg, L_r, S_text) consumed by the UNet's
    cross-attentions; the batch axis is [uncond..., cond...] when
    ``do_cfg``. ``states``: one per prompt, each mapping phrase -> dict with
    ``mask`` ((H, W), 1 = inside), ``weight`` (S) and ``mask_outsides``
    (S'). The biases are rasterized on the CPU and moved to ``device``."""
    n_prompts = len(prompt_ids_per_prompt)
    states = list(states) + [None] * (n_prompts - len(states))
    s_text = len(prompt_ids_per_prompt[0])

    per_prompt: List[Tuple[torch.Tensor, ...]] = []
    for state, ids in zip(states, prompt_ids_per_prompt):
        if not state:
            per_prompt.append(tuple(
                torch.zeros(level_shape(height, width, r)[0]
                            * level_shape(height, width, r)[1], s_text)
                for r in LEVEL_RATIOS))
            continue
        phrases = [k for k, v in state.items() if v.get("mask") is not None]
        masks = np.stack([np.asarray(state[k]["mask"], np.float32)
                          for k in phrases])
        weights = np.array([float(state[k]["weight"]) for k in phrases],
                           np.float32)
        outs = np.array([float(state[k].get("mask_outsides", 0.0))
                         for k in phrases], np.float32)
        counts = phrase_token_counts(ids, [phrase_tokenize(k)
                                           for k in phrases])
        per_prompt.append(rasterize_region_biases(
            torch.from_numpy(masks), torch.from_numpy(weights),
            torch.from_numpy(outs), torch.from_numpy(counts),
            height=height, width=width))

    levels = []
    for li in range(len(LEVEL_RATIOS)):
        stacked = torch.stack([pp[li] for pp in per_prompt])  # (N, L, S)
        if do_cfg:
            stacked = torch.cat([stacked, stacked], dim=0)
        stacked = torch.repeat_interleave(stacked, num_images_per_prompt,
                                          dim=0)
        levels.append(stacked.to(device) if device is not None else stacked)
    return tuple(levels)
