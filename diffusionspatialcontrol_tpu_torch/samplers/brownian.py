"""Per-step solver noise, one generator a sample (port of
``samplers/brownian.py``).

The reference draws the SDE samplers' noise from a Brownian tree so that a
result depends only on its seed, not on the batch it rides in. The JAX
package keeps those guarantees with threefry keys; its streams cannot be
reproduced here, so the port has its own, with the same guarantees:

* deterministic per seed, and the same on every device: every draw is made
  on the CPU by a ``torch.Generator`` and copied to the device once, before
  the step loop;
* independent of batch composition: each sample has its own generator;
* independent of whether the caller passed initial latents.

Seed derivation: sample seed ``s`` owns one stream, the CPU generator
seeded with ``s``. ``pipeline.initial_noise`` takes the first draw of it
(txt2img's initial latents, or img2img's noise); inpaint takes its first
two or three (the posterior draw, the initial latents, the 4-channel
blend's noise: ``pipeline.seeded_normals``). This module skips those draws
and takes the solver noise from what follows. So the noise never repeats
the latents' values for any seed, and it does not depend on whether the
latents were drawn or passed in (the skipped draws are made either way).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def step_noise(seeds: Sequence[int], n_steps: int, draws_per_step: int,
               sample_shape: Tuple[int, ...], device,
               skip: int = 1) -> torch.Tensor:
    """Standard normal noise (n_steps, draws_per_step, B, *sample_shape),
    B = len(seeds); ``sample_shape`` is one sample's latent shape. Each
    stream first skips ``skip`` draws of that shape (the initial latents',
    and an inpaint request's other draws)."""
    per_sample = []
    for s in seeds:
        g = torch.Generator().manual_seed(int(s))
        for _ in range(skip):
            torch.randn(sample_shape, generator=g)
        per_sample.append(torch.randn((n_steps, draws_per_step)
                                      + tuple(sample_shape), generator=g))
    return torch.stack(per_sample, dim=2).to(device)
