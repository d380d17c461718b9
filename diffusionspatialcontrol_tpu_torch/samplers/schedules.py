"""Noise schedules in sigma space (port of ``samplers/schedules.py``).

Host numpy in float64, as in the JAX package (the tables match it bit for
bit): the step count and schedule are configuration, so the tables are
computed once per request.
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


def get_sigmas_exponential(n: int, sigma_min: float,
                           sigma_max: float) -> np.ndarray:
    sigmas = np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min), n,
                                dtype=np.float64))
    return append_zero(sigmas)


def get_sigmas_polyexponential(n: int, sigma_min: float, sigma_max: float,
                               rho: float = 1.0) -> np.ndarray:
    ramp = np.linspace(1, 0, n, dtype=np.float64) ** rho
    sigmas = np.exp(ramp * (np.log(sigma_max) - np.log(sigma_min))
                    + np.log(sigma_min))
    return append_zero(sigmas)


def get_sigmas_default(n: int, sigma_table: np.ndarray) -> np.ndarray:
    """The discrete table resampled to n steps through the log-space
    t <-> sigma map."""
    t_max = len(sigma_table) - 1
    t = np.linspace(t_max, 0, n, dtype=np.float64)
    low_idx = np.floor(t).astype(int)
    high_idx = np.ceil(t).astype(int)
    w = t - low_idx
    log_tab = np.log(sigma_table)
    log_sigma = (1 - w) * log_tab[low_idx] + w * log_tab[high_idx]
    return append_zero(np.exp(log_sigma))


def sigma_to_t(sigma, sigma_table: np.ndarray):
    """The fractional train timestep of a sigma (numpy, float64), by
    log-space interpolation into the table. The denoiser's device-side
    twin is ``pipeline._sigma_to_t``."""
    log_tab = np.log(sigma_table)
    return np.interp(np.log(np.maximum(sigma, 1e-10)), log_tab,
                     np.arange(len(log_tab), dtype=np.float64))


def get_sigmas(cfg: ModelConfig, steps: int, schedule: str = "default",
               discard_next_to_last_sigma: bool = False) -> np.ndarray:
    """Full schedule including the trailing 0: "karras", "exponential",
    "polyexponential", anything else the resampled discrete table.
    ``discard_next_to_last_sigma`` computes one step more and drops the
    penultimate sigma."""
    table = ddpm_sigma_table(cfg)
    n = steps + (1 if discard_next_to_last_sigma else 0)
    sigma_min, sigma_max = float(table[0]), float(table[-1])
    if schedule == "karras":
        sigmas = get_sigmas_karras(n, sigma_min, sigma_max)
    elif schedule == "exponential":
        sigmas = get_sigmas_exponential(n, sigma_min, sigma_max)
    elif schedule == "polyexponential":
        sigmas = get_sigmas_polyexponential(n, sigma_min, sigma_max)
    else:
        sigmas = get_sigmas_default(n, table)
    if discard_next_to_last_sigma:
        sigmas = np.concatenate([sigmas[:-2], sigmas[-1:]])
    return sigmas
