"""Multi-prompt x multi-seed generation (port of ``parallel/batched.py``'s
``generate_grid``) on one device.

Every sample's randomness comes from its own seed's generator
(``samplers/brownian.py``), so a sample of the grid draws the same noise as
a single request with its prompt and seed, whatever the grid's shape. The
JAX package shards the grid over a device mesh; meshes come with the
multi-GPU port (ROADMAP item 22), so ``mesh`` takes only None or "auto",
which resolve to no mesh here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..config import GenerationConfig


def generate_grid(
    pipe,
    prompts: Sequence[str],
    seeds: Sequence[int],
    gen: GenerationConfig,
    negative_prompt: Union[str, Sequence[str]] = "",
    region_states: Optional[Sequence[Optional[dict]]] = None,
    mesh=None,
    decode: bool = True,
    encoding_mode: str = "short",
    extras=None,
    init_images=None,
    strength: float = 0.8,
):
    """Generate len(prompts) * len(seeds) images: prompt-major order.

    Each prompt is encoded once and tiled across its seeds.
    ``negative_prompt`` may be a per-prompt list. ``extras`` must already be
    batched to the whole prompts x seeds fan-out (the port has no
    conditioning units yet, so ``api.inference`` passes None).

    ``init_images``: optional per-prompt init images (each (H, W, 3) in
    [-1, 1]), the batched img2img path. Each (prompt, seed) sample's init
    latents are VAE-encoded under its own seed, so every sample equals the
    single img2img run with that prompt and seed.
    Returns (P*M, H, W, 3) images (or latents)."""
    if mesh not in (None, "auto"):
        raise NotImplementedError(
            "a device mesh for grid mode is not ported yet (multi-GPU, "
            "ROADMAP item 22); pass mesh=None or 'auto'")
    n_p, n_s = len(prompts), len(seeds)
    negs = (
        list(negative_prompt)
        if isinstance(negative_prompt, (list, tuple))
        else [negative_prompt] * n_p
    )
    if len(negs) != n_p:
        raise ValueError(
            f"{len(negs)} negative prompts for {n_p} prompts"
        )
    context, ids = pipe.encode_prompt(
        list(prompts), negs, clip_skip=gen.clip_skip,
        mode=encoding_mode, num_images_per_prompt=n_s,
    )
    do_cfg = gen.guidance_scale > 1.0
    if not do_cfg:
        # no CFG pair: cond half only (matches api.inference)
        context = context[context.shape[0] // 2:]
    region_biases = None
    if region_states and any(region_states):
        region_biases = pipe.encode_region(
            list(region_states), ids, height=gen.height, width=gen.width,
            num_images_per_prompt=n_s, do_cfg=do_cfg,
        )

    all_seeds = [int(s) for p in range(n_p) for s in seeds]

    if init_images is not None:
        if len(init_images) != n_p:
            raise ValueError(
                f"{len(init_images)} init images for {n_p} prompts"
            )
        init_latents = torch.cat(
            [
                pipe.encode_image(init_images[p][None], seed=int(s))
                for p in range(n_p)
                for s in seeds
            ],
            dim=0,
        )
        return pipe.img2img(
            context, init_latents, gen, strength=strength, seed=all_seeds,
            region_biases=region_biases, decode=decode, extras=extras,
        )
    return pipe.txt2img(
        context, gen, seed=all_seeds, region_biases=region_biases,
        decode=decode, extras=extras,
    )
