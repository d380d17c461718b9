"""Data-parallel sampling with explicit collectives (port of
``parallel/spmd.py``).

The JAX package pins its sampling program under ``shard_map``: every tensor
batch-sharded, the parameters replicated, and the only collective the psum
of the region std's moments, which ``assert_only_allreduce`` checks in the
compiled HLO. Here each rank of a ``Mesh`` runs its own samples through the
plain solver, and ``sample_spmd(check_collectives=True)`` checks the mesh's
own count instead: one all-reduce per region-mapped cross-attention per
UNet call (16 a call on SD1.5), none without a map, and nothing else until
the one all-gather that returns the whole batch on every rank (the JAX
runner's ``out_specs=P("data")`` global array).

Each rank draws only its own samples' initial latents and solver noise, each
from its own seed's generators, so its draws are the single-device draw's
rows bit for bit, and a sample's result matches the single-device pipeline
up to fp32 reduction order.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import GenerationConfig
from ..pipeline.pipeline import initial_noise
from .mesh import Mesh, shard_batch


def cross_attention_count(unet_params) -> int:
    """The cross-attentions of one UNet call: one a transformer block."""
    down = [a for blk in unet_params["down_blocks"] for a in blk["attentions"]]
    up = [a for blk in unet_params["up_blocks"] for a in blk["attentions"]]
    return sum(len(a["blocks"]) for a in down + up
               + [unet_params["mid_block"]["attention"]])


def _pairs(t: torch.Tensor, batch: int) -> torch.Tensor:
    """(halves * B, ...) in the [uncond..., cond...] layout -> (B, halves,
    ...), one row a sample (the JAX runner's pairs layout)."""
    halves = t.shape[0] // batch
    return t.reshape((halves, batch) + tuple(t.shape[1:])).transpose(0, 1)


def _unpair(p: torch.Tensor) -> torch.Tensor:
    """(B, halves, ...) -> (halves * B, ...) [uncond..., cond...]."""
    return torch.cat(p.unbind(1))


def sample_local(pipe, latents, context_pairs, bias_pairs, noise,
                 gen: GenerationConfig, mesh: Mesh,
                 sigmas=None) -> torch.Tensor:
    """One rank's part of ``sample_spmd`` (the JAX runner's ``local_run``):
    the pipeline's own sampling loop (``_sample``) on this rank's *scaled*
    initial latents (B_r, h, w, 4), with its samples' context pairs
    (B_r, 2, S, D) (or (B_r, 1, S, D) with guidance off), its biases' pairs
    (each (B_r, 2, L, S)) or None and its solver noise
    (``pipe._solver_noise``'s table for its seeds) or None. Returns the
    rank's final latents."""
    if sigmas is None:
        sigmas, _ = pipe._schedule(gen)
    biases = (None if bias_pairs is None
              else tuple(_unpair(b) for b in bias_pairs))
    return pipe._sample(latents, _unpair(context_pairs), biases, sigmas, gen,
                        noise, False, False, mesh=mesh)


@contextlib.contextmanager
def _count_unet_calls(pipe):
    """While entered, every denoiser ``pipe`` builds counts its calls (one
    UNet call each) in the yielded list's first item."""
    calls = [0]
    build = type(pipe)._denoiser

    def counting(*args, **kwargs):
        denoise = build(pipe, *args, **kwargs)

        def counted(x, sigma):
            calls[0] += 1
            return denoise(x, sigma)
        return counted

    pipe._denoiser = counting
    try:
        yield calls
    finally:
        del pipe._denoiser


@torch.inference_mode()
def sample_spmd(pipe, context: torch.Tensor, gen: GenerationConfig, seeds,
                mesh: Mesh,
                region_biases: Optional[Tuple[torch.Tensor, ...]] = None,
                check_collectives: bool = False) -> torch.Tensor:
    """Data-parallel sampling over ``mesh``: every rank calls it with the
    whole batch's context ((2B, S, D) [uncond..., cond...], or (B, S, D)
    with guidance off), seeds and region biases, and runs its own block of
    samples.

    With ``check_collectives`` it raises ``AssertionError`` unless the
    sampling loop issued exactly one all-reduce per region-mapped
    cross-attention per UNet call and no other collective, and the result
    one all-gather.

    Returns the raw latents (B, h, w, 4) of the whole batch on every rank;
    decode with ``pipe.decode_latents``."""
    sigmas, _ = pipe._schedule(gen)
    seeds = [int(s) for s in seeds]
    batch = len(seeds)
    rows = mesh.rows(batch)
    mine = seeds[rows]
    shape = (gen.latent_height, gen.latent_width, 4)
    latents = initial_noise(mine, shape, pipe.device) * float(
        np.sqrt(sigmas[0] ** 2 + 1.0))
    noise = pipe._solver_noise(mine, sigmas, (len(mine),) + shape,
                               gen.sampler)
    # the pairs layout puts a sample's uncond and cond rows on its rank
    pairs = shard_batch(mesh, _pairs(context, batch))
    bias_pairs = (None if region_biases is None else shard_batch(
        mesh, tuple(_pairs(b, batch) for b in region_biases)))

    before = collections.Counter(mesh.counts)
    with _count_unet_calls(pipe) as calls:
        out = sample_local(pipe, latents, pairs, bias_pairs, noise, gen,
                           mesh, sigmas=sigmas)
    if check_collectives:
        issued = mesh.counts - before
        mapped = (0 if region_biases is None
                  else cross_attention_count(pipe.params["unet"]))
        want = collections.Counter(all_reduce=mapped * calls[0])
        if issued != want:
            raise AssertionError(
                f"sampling issued collectives {dict(issued)} in {calls[0]} "
                f"UNet calls; expected {dict(want)} (one all-reduce per "
                f"mapped cross-attention per call, nothing else)")
    before = collections.Counter(mesh.counts)
    out = mesh.all_gather(out)
    if check_collectives and mesh.counts - before != collections.Counter(
            all_gather=1):
        raise AssertionError(f"the gather issued {dict(mesh.counts - before)}")
    return out
