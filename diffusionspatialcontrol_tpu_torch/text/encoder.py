"""Prompt encoding front end (port of ``text/encoder.py``).

Three modes, as in the JAX package: "a1111" (or "automatic1111": A1111
emphasis and 77-token chunks), "long" (weighted tokens over up to 3 chunks)
and "short" (one 77-token CLIP encode). The first two live in
``text/prompt_parser.py``. Every mode returns ``(context,
cond_ids_per_prompt)``: context stacks [uncond..., cond...] for CFG, and the
raw cond token ids feed the region-map n-gram matcher.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import CLIPTextConfig
from ..models.clip import clip_apply


def tokenize_batch(tokenizer, prompts: Sequence[str],
                   max_length: int = 77) -> np.ndarray:
    rows = []
    for p in prompts:
        ids = tokenizer.encode(p, add_special_tokens=True, truncation=True,
                               max_length=max_length)
        ids = ids + [tokenizer.pad_token_id] * (max_length - len(ids))
        rows.append(ids)
    return np.asarray(rows, np.int64)


def encode_prompts(
    clip_params,
    clip_cfg: CLIPTextConfig,
    tokenizer,
    prompts: List[str],
    negative_prompts: List[str],
    clip_skip: int = 2,
    mode: str = "short",
    num_images_per_prompt: int = 1,
    device=None,
) -> Tuple[torch.Tensor, List[List[int]]]:
    if mode in ("a1111", "automatic1111", "long"):
        from . import prompt_parser

        encode = (prompt_parser.encode_prompt_long if mode == "long"
                  else prompt_parser.encode_prompt_a1111)
        return encode(clip_params, clip_cfg, tokenizer, prompts,
                      negative_prompts, clip_skip=clip_skip,
                      num_images_per_prompt=num_images_per_prompt,
                      device=device)
    if len(negative_prompts) == 1 and len(prompts) > 1:
        negative_prompts = negative_prompts * len(prompts)
    n_pos = clip_cfg.max_position_embeddings
    cond_ids = tokenize_batch(tokenizer, prompts, n_pos)
    uncond_ids = tokenize_batch(tokenizer, negative_prompts, n_pos)
    if device is None:
        device = clip_params["token_embedding"].device
    all_ids = torch.from_numpy(
        np.concatenate([uncond_ids, cond_ids], axis=0)).to(device)
    context = clip_apply(clip_params, clip_cfg, all_ids, clip_skip=clip_skip)
    if num_images_per_prompt > 1:
        context = torch.repeat_interleave(context, num_images_per_prompt,
                                          dim=0)
    return context, [[int(i) for i in r] for r in cond_ids]
