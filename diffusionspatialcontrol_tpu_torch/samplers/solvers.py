"""k-diffusion solvers as Python step loops (port of ``samplers/solvers.py``).

``sample_<name>(denoise, x, sigmas)``: ``denoise(x, sigma)`` is the
sigma-space denoiser D(x; sigma) with sigma a 0-d fp32 tensor on x's device,
and ``sigmas`` the numpy schedule (n+1 values, trailing 0). Per-step
coefficients are computed in numpy before the loop exactly as the JAX
package computes them, so the loop never reads a value back from the card.

Only DPM++ 2M (the main path's solver) is ported; the other 21 solvers come
in a later slice.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def dpmpp_2m_coefficients(sigmas: np.ndarray):
    """Per-step (ratio, expm1 term, r, plain-update flag, sigma), float32."""
    n = len(sigmas) - 1
    sig, sig_next = sigmas[:-1], sigmas[1:]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = -np.log(np.maximum(sig, 1e-20))
        t_next = -np.log(np.maximum(sig_next, 1e-20))
    h = t_next - t
    h_last = np.concatenate([[1.0], h[:-1]])
    r = h_last / np.where(h == 0, 1.0, h)
    # first step or final (sigma_next == 0) -> plain update with denoised
    use_plain = np.zeros(n, bool)
    use_plain[0] = True
    use_plain |= sig_next == 0
    expm1_term = np.where(sig_next == 0, -1.0, np.expm1(-h))
    ratio = sig_next / sig
    f32 = np.float32
    return (ratio.astype(f32), expm1_term.astype(f32), r.astype(f32),
            use_plain, sig.astype(f32))


def sample_dpmpp_2m(denoise: DenoiseFn, x: torch.Tensor,
                    sigmas: np.ndarray) -> torch.Tensor:
    """DPM-Solver++(2M), the reference's headline sampler."""
    ratio, em1, r, plain, sig = dpmpp_2m_coefficients(sigmas)
    sig_dev = torch.from_numpy(sig).to(x.device)  # one copy, before the loop
    old_denoised = torch.zeros_like(x)
    for i in range(len(sig)):
        denoised = denoise(x, sig_dev[i])
        if plain[i]:
            d_use = denoised
        else:
            # fp32 scalar arithmetic as in the JAX scan body
            a = np.float32(1) + np.float32(1) / (np.float32(2) * r[i])
            b = np.float32(1) / (np.float32(2) * r[i])
            d_use = float(a) * denoised - float(b) * old_denoised
        x = float(ratio[i]) * x - float(em1[i]) * d_use
        old_denoised = denoised
    return x
