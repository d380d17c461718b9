"""Noise schedules in sigma space (port of ``samplers/schedules.py``).

Host numpy in float64, as in the JAX package: the step count and schedule
are configuration, so the tables are computed once per request.
"""

from __future__ import annotations

import numpy as np

from ..config import ModelConfig


def ddpm_alphas_cumprod(cfg: ModelConfig) -> np.ndarray:
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                            cfg.num_train_timesteps, dtype=np.float64) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end,
                            cfg.num_train_timesteps, dtype=np.float64)
    else:
        raise ValueError(f"unknown beta schedule {cfg.beta_schedule}")
    return np.cumprod(1.0 - betas)


def ddpm_sigma_table(cfg: ModelConfig) -> np.ndarray:
    """Discrete sigma table, ascending (index == train timestep)."""
    ac = ddpm_alphas_cumprod(cfg)
    return np.sqrt((1.0 - ac) / ac)


def append_zero(x: np.ndarray) -> np.ndarray:
    return np.concatenate([x, [0.0]])


def get_sigmas_karras(n: int, sigma_min: float, sigma_max: float,
                      rho: float = 7.0) -> np.ndarray:
    ramp = np.linspace(0, 1, n, dtype=np.float64)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return append_zero(sigmas)


def get_sigmas(cfg: ModelConfig, steps: int, schedule: str = "karras",
               discard_next_to_last_sigma: bool = False) -> np.ndarray:
    """Full schedule including the trailing 0. Only the Karras schedule is
    ported; the exponential, polyexponential and default tables come with
    the other solvers."""
    if schedule != "karras":
        raise NotImplementedError(
            f"schedule {schedule!r} is not ported yet; use 'karras'")
    table = ddpm_sigma_table(cfg)
    n = steps + (1 if discard_next_to_last_sigma else 0)
    sigmas = get_sigmas_karras(n, float(table[0]), float(table[-1]))
    if discard_next_to_last_sigma:
        sigmas = np.concatenate([sigmas[:-2], sigmas[-1:]])
    return sigmas
