"""Multi-prompt x multi-seed generation (port of ``parallel/batched.py``'s
``generate_grid``), on one device or over a data-parallel mesh.

Every sample's randomness comes from its own seed's generator
(``samplers/brownian.py``), so a sample of the grid draws the same noise as
a single request with its prompt and seed, whatever the grid's shape and
whatever rank it runs on. On a mesh (``parallel.mesh``) each rank runs its
equal block of the prompt-major samples, the region std is all-reduced over
the ranks so that it stays global over the whole batch, and the result is
gathered on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from ..config import GenerationConfig
from .mesh import resolve_mesh, shard_cfg_batch


def _shard_extras(mesh, extras, batch: int):
    """This rank's shard of a ``DenoiseExtras`` of a batch of ``batch``
    samples: every per-sample tensor split by sample, CFG-aware
    (``shard_cfg_batch``: ControlNet images, T2I residuals, IP tokens and
    masks, the inpaint fields). The ControlNet weight trees stay as they
    are: every rank's manager loaded the same ones, as it did the UNet."""
    def split(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return shard_cfg_batch(mesh, x, batch)
        return type(x)(split(v) for v in x)

    fields = ("controlnet_images", "t2i_residuals", "ip_tokens", "ip_masks",
              "inpaint_mask", "inpaint_image_latents", "inpaint_noise",
              "extra_channels")
    return dataclasses.replace(
        extras, **{f: split(getattr(extras, f)) for f in fields})


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
    ``negative_prompt`` may be a per-prompt list. ``extras`` (ControlNet,
    T2I-Adapter and IP-Adapter units) must already be batched to the whole
    prompts x seeds fan-out, as ``api.inference`` builds them.

    ``mesh``: None (one device), a ``parallel.mesh.Mesh`` whose ranks split
    the P*M samples equally, or "auto" (``mesh.resolve_mesh``: the default
    process group's mesh when it has several ranks and they split the
    samples equally). On a mesh every rank calls this with the same
    arguments; each runs its block of samples (the contexts, region biases
    and units split CFG-aware) and every rank returns the whole grid.

    ``init_images``: optional per-prompt init images (each (H, W, 3) in
    [-1, 1]), the batched img2img path. Each (prompt, seed) sample's init
    latents are VAE-encoded under its own seed, on its rank, so every sample
    equals the single img2img run with that prompt and seed.
    Returns (P*M, H, W, 3) images (or latents)."""
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
    if init_images is not None and len(init_images) != n_p:
        raise ValueError(
            f"{len(init_images)} init images for {n_p} prompts"
        )
    if mesh is not None:
        mesh = resolve_mesh(mesh, n_p * n_s, pipe.device)
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

    samples = [(p, int(s)) for p in range(n_p) for s in seeds]
    if mesh is not None:
        batch = len(samples)
        samples = samples[mesh.rows(batch)]
        context = shard_cfg_batch(mesh, context, batch)
        if region_biases is not None:
            region_biases = tuple(shard_cfg_batch(mesh, b, batch)
                                  for b in region_biases)
        if extras is not None:
            extras = _shard_extras(mesh, extras, batch)
    all_seeds = [s for _, s in samples]
    # on one device, the JAX package's pipeline calls as they are
    on_mesh = {} if mesh is None else {"mesh": mesh}

    if init_images is not None:
        init_latents = torch.cat(
            [pipe.encode_image(init_images[p][None], seed=s)
             for p, s in samples],
            dim=0,
        )
        out = pipe.img2img(
            context, init_latents, gen, strength=strength, seed=all_seeds,
            region_biases=region_biases, decode=decode, extras=extras,
            **on_mesh,
        )
    else:
        out = pipe.txt2img(
            context, gen, seed=all_seeds, region_biases=region_biases,
            decode=decode, extras=extras, **on_mesh,
        )
    return out if mesh is None else mesh.all_gather(out)
