"""k-diffusion-family solvers as Python step loops (port of
``samplers/solvers.py``).

Each solver is

    sample_<name>(denoise, x, sigmas, *, noise=None, return_history=False,
                  carry_in=None, segment=None, return_carry=False, **opts)

where ``denoise(x, sigma)`` is the sigma-space denoiser D(x; sigma) with
sigma a 0-d fp32 tensor on x's device, ``sigmas`` the numpy schedule (n+1
values, trailing 0) and ``noise`` the standard-normal table (n_steps, draws,
*x.shape) that the step loop consumes one slice a step (None: no noise).

Per-step coefficients are computed on the host in numpy before the loop,
in float64 and rounded to float32 exactly as the JAX package builds its scan
inputs; the sigmas the denoiser sees are copied to the device once. The
loop never reads a value back from the device, except in ``dpm_adaptive``,
whose accept test needs the step's error (see there).

Chunked runs: ``segment=(start, size)`` runs steps start..start+size-1 of
the full schedule from ``carry_in`` (the carry a previous run returned with
``return_carry``). Every coefficient comes from the full schedule and the
carry is passed through as is, so a chunked run performs the same
operations in the same order as the plain run and is bitwise equal to it,
for every solver of ``CHUNKABLE`` (heunpp2 included: its per-step branch is
static, so chunked and plain runs make the same calls).

Calls the port skips: the JAX scan bodies compute both sides of a
``jnp.where`` and discard one; the port computes only the side it keeps, so
it makes fewer denoiser calls with the same result. Skipped: the second
call of heun, dpm_2, dpm_2_ancestral, dpmpp_2s_ancestral, dpmpp_sde and
restart on a step that ends at sigma = 0 (dpm_2_ancestral and
dpmpp_2s_ancestral: where sigma_down = 0); heunpp2's second and third calls
on its last step and its third on the step before (the JAX package skips
these too, outside its chunked path); and in dpm_adaptive the third-order
step's first stage, which is the second-order step's stage on the same
inputs. Terms whose host coefficient is exactly 0 (noise on a step without
any, a multistep correction on the first step) are not added either.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .schedules import get_sigmas_karras

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

f32 = np.float32


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float64).astype(np.float32)


def _table(x: torch.Tensor, *cols) -> torch.Tensor:
    """(len(cols), n) fp32 table of per-step sigmas on x's device, copied
    once; indexing it in the loop makes views, not copies."""
    return torch.from_numpy(np.stack([_f32(c) for c in cols])).to(x.device)


def _noise(noise, x: torch.Tensor) -> Optional[torch.Tensor]:
    if noise is None:
        return None
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
    if noise.dim() == x.dim() + 1:
        noise = noise[:, None]
    return noise


def _add_noise(x, noise, i, draw, scale):
    """x + z * scale for the step's draw; nothing when there is no noise or
    the scale is 0."""
    if noise is None or scale == 0:
        return x
    return x + noise[i, draw] * float(scale)


def to_d(x, sigma, denoised):
    """Convert a denoiser output to an ODE derivative (k-diffusion utils)."""
    return (x - denoised) / sigma


def get_ancestral_step(sigma_from, sigma_to, eta=1.0):
    """k-diffusion get_ancestral_step (numpy)."""
    if eta == 0.0:
        return sigma_to, np.zeros_like(sigma_to)
    sigma_up = np.minimum(
        sigma_to,
        eta * np.sqrt(sigma_to ** 2 * (sigma_from ** 2 - sigma_to ** 2)
                      / np.maximum(sigma_from ** 2, 1e-20)))
    sigma_down = np.sqrt(np.maximum(sigma_to ** 2 - sigma_up ** 2, 0.0))
    return sigma_down, sigma_up


def _run(step, init, n, *, carry_in=None, segment=None,
         return_history=False, return_carry=False):
    """Drive ``carry = step(i, carry)`` over the steps of ``segment`` (all n
    by default); ``carry[0]`` is x."""
    carry = init if carry_in is None else carry_in
    start, size = (0, n) if segment is None else segment
    hist = []
    for i in range(int(start), int(start) + int(size)):
        carry = step(i, carry)
        if return_history:
            hist.append(carry[0])
    x = carry[0]
    hist = torch.stack(hist) if return_history else None
    if return_carry:
        return (x, carry, hist) if return_history else (x, carry)
    return (x, hist) if return_history else x


def _no_chunks(name, carry_in, segment, return_carry):
    if segment is not None or carry_in is not None or return_carry:
        raise ValueError(f"{name} does not support chunked execution")


# ---------------------------------------------------------------------------
# First order
# ---------------------------------------------------------------------------


def sample_euler(denoise: DenoiseFn, x, sigmas: np.ndarray, *, noise=None,
                 **kw):
    sig, sig_next = _f32(sigmas[:-1]), _f32(sigmas[1:])
    sig_t = _table(x, sig)

    def step(i, carry):
        (x,) = carry
        denoised = denoise(x, sig_t[0, i])
        d = to_d(x, float(sig[i]), denoised)
        return (x + d * float(sig_next[i] - sig[i]),)

    return _run(step, (x,), len(sig), **kw)


def sample_euler_ancestral(denoise: DenoiseFn, x, sigmas: np.ndarray, *,
                           noise=None, eta=1.0, s_noise=1.0, **kw):
    """noise: (n_steps, *x.shape)."""
    down, up = get_ancestral_step(sigmas[:-1], sigmas[1:], eta)
    sig, down, up = _f32(sigmas[:-1]), _f32(down), _f32(up)
    sig_t = _table(x, sig)
    nz = _noise(noise, x)

    def step(i, carry):
        (x,) = carry
        denoised = denoise(x, sig_t[0, i])
        d = to_d(x, float(sig[i]), denoised)
        x = x + d * float(down[i] - sig[i])
        return (_add_noise(x, nz, i, 0, f32(s_noise) * up[i]),)

    return _run(step, (x,), len(sig), **kw)


def sample_lcm(denoise: DenoiseFn, x, sigmas: np.ndarray, *, noise=None,
               s_noise=1.0, **kw):
    sig, sig_next = _f32(sigmas[:-1]), _f32(sigmas[1:])
    sig_t = _table(x, sig)
    nz = _noise(noise, x)

    def step(i, carry):
        (x,) = carry
        denoised = denoise(x, sig_t[0, i])
        return (_add_noise(denoised, nz, i, 0, max(sig_next[i], f32(0))),)

    return _run(step, (x,), len(sig), **kw)


def sample_ddpm(denoise: DenoiseFn, x, sigmas: np.ndarray, *, noise=None,
                s_noise=1.0, **kw):
    """DDPM ancestral stepping in the sqrt(1 + sigma^2)-rescaled space."""
    sig, sig_next = _f32(sigmas[:-1]), _f32(sigmas[1:])
    sig_t = _table(x, sig)
    nz = _noise(noise, x)
    one = f32(1)

    def step(i, carry):
        (x,) = carry
        s, sn = sig[i], sig_next[i]
        denoised = denoise(x, sig_t[0, i])
        eps = (x - denoised) / float(s)
        xr = x / float(np.sqrt(one + s ** 2))
        ac = one / (s * s + one)
        ac_prev = one / (sn * sn + one)
        alpha = ac / ac_prev
        mu = float(np.sqrt(one / alpha)) * (
            xr - float(one - alpha) * eps / float(np.sqrt(one - ac)))
        add = np.sqrt(max((one - alpha) * (one - ac_prev) / (one - ac),
                          f32(0)))
        if sn > 0:
            mu = _add_noise(mu, nz, i, 0, add)
            mu = mu * float(np.sqrt(one + sn ** 2))
        return (mu,)

    return _run(step, (x,), len(sig), **kw)


# ---------------------------------------------------------------------------
# Second order (Heun / DPM2 family)
# ---------------------------------------------------------------------------


def sample_heun(denoise: DenoiseFn, x, sigmas: np.ndarray, *, noise=None,
                **kw):
    """Skips the correction's denoiser call on a step to sigma = 0."""
    sig, sig_next = _f32(sigmas[:-1]), _f32(sigmas[1:])
    sn_safe = np.maximum(sig_next, f32(1e-10))
    sig_t = _table(x, sig, sn_safe)

    def step(i, carry):
        (x,) = carry
        denoised = denoise(x, sig_t[0, i])
        d = to_d(x, float(sig[i]), denoised)
        dt = float(sig_next[i] - sig[i])
        x_euler = x + d * dt
        if sig_next[i] == 0:
            return (x_euler,)
        d_2 = to_d(x_euler, float(sn_safe[i]), denoise(x_euler, sig_t[1, i]))
        return (x + (d + d_2) / 2 * dt,)

    return _run(step, (x,), len(sig), **kw)


def sample_heunpp2(denoise: DenoiseFn, x, sigmas: np.ndarray, *,
                   noise=None, **kw):
    """Heun++: a third-order weighted step (3 denoiser calls), a weighted
    Heun step (2) on the step before the schedule's end and Euler (1) on
    the last, chosen per step from the schedule, so a canonical n-step
    schedule costs 3n - 3 calls, chunked or not."""
    n = len(sigmas) - 1
    s_end = sigmas[-1]
    # per step: 0 = euler (last), 1 = heun (second to last), 2 = heun++
    branch = np.full(n, 2, dtype=np.int32)
    for i in range(n):
        if sigmas[i + 1] == s_end:
            branch[i] = 0
        elif i + 2 <= n and sigmas[i + 2] == s_end:
            branch[i] = 1
    w_h = f32(2.0 * float(sigmas[0]))
    w_p = f32(3.0 * float(sigmas[0]))
    sig, sig_next = _f32(sigmas[:-1]), _f32(sigmas[1:])
    sig_next2 = _f32(np.concatenate([sigmas[2:], [0.0]])[:n])
    sig_t = _table(x, sig, np.maximum(sig_next, 1e-10),
                   np.maximum(sig_next2, 1e-10))
    one = f32(1)

    def step(i, carry):
        (x,) = carry
        s, sn, sn2 = sig[i], sig_next[i], sig_next2[i]
        denoised = denoise(x, sig_t[0, i])
        d = to_d(x, float(s), denoised)
        dt = float(sn - s)
        x_euler = x + d * dt
        if branch[i] == 0:
            return (x_euler,)
        sn_safe = max(sn, f32(1e-10))
        d_2 = to_d(x_euler, float(sn_safe), denoise(x_euler, sig_t[1, i]))
        if branch[i] == 1:
            w2_h = sn / w_h
            return (x + (d * float(one - w2_h) + d_2 * float(w2_h)) * dt,)
        x_3 = x_euler + d_2 * float(sn2 - sn)
        sn2_safe = max(sn2, f32(1e-10))
        d_3 = to_d(x_3, float(sn2_safe), denoise(x_3, sig_t[2, i]))
        w2, w3 = sn / w_p, sn2 / w_p
        return (x + (d * float(one - w2 - w3) + d_2 * float(w2)
                     + d_3 * float(w3)) * dt,)

    return _run(step, (x,), n, **kw)


def _mid(sig, to):
    """exp of the mean of the logs (sig where ``to`` is 0)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        mid = np.exp(0.5 * (np.log(np.maximum(sig, 1e-20))
                            + np.log(np.maximum(to, 1e-20))))
    return np.where(to == 0, sig, mid)


def sample_dpm_2(denoise: DenoiseFn, x, sigmas: np.ndarray, *, noise=None,
                 **kw):
    """Skips the midpoint call on a step to sigma = 0."""
    mid = _mid(sigmas[:-1], sigmas[1:])
    sig, sig_next, mid = _f32(sigmas[:-1]), _f32(sigmas[1:]), _f32(mid)
    sig_t = _table(x, sig, mid)

    def step(i, carry):
        (x,) = carry
        denoised = denoise(x, sig_t[0, i])
        d = to_d(x, float(sig[i]), denoised)
        dt = float(sig_next[i] - sig[i])
        if sig_next[i] == 0:
            return (x + d * dt,)
        x_2 = x + d * float(mid[i] - sig[i])
        d_2 = to_d(x_2, float(mid[i]), denoise(x_2, sig_t[1, i]))
        return (x + d_2 * dt,)

    return _run(step, (x,), len(sig), **kw)


def sample_dpm_2_ancestral(denoise: DenoiseFn, x, sigmas: np.ndarray, *,
                           noise=None, eta=1.0, s_noise=1.0, **kw):
    """Skips the midpoint call where sigma_down = 0."""
    down, up = get_ancestral_step(sigmas[:-1], sigmas[1:], eta)
    mid = _mid(sigmas[:-1], down)
    sig, down, up, mid = _f32(sigmas[:-1]), _f32(down), _f32(up), _f32(mid)
    sig_t = _table(x, sig, mid)
    nz = _noise(noise, x)

    def step(i, carry):
        (x,) = carry
        denoised = denoise(x, sig_t[0, i])
        d = to_d(x, float(sig[i]), denoised)
        dt = float(down[i] - sig[i])
        if down[i] == 0:
            x = x + d * dt
        else:
            x_2 = x + d * float(mid[i] - sig[i])
            d_2 = to_d(x_2, float(mid[i]), denoise(x_2, sig_t[1, i]))
            x = x + d_2 * dt
        return (_add_noise(x, nz, i, 0, f32(s_noise) * up[i]),)

    return _run(step, (x,), len(sig), **kw)


# ---------------------------------------------------------------------------
# Linear multistep
# ---------------------------------------------------------------------------


def _lms_coeffs(sigmas: np.ndarray, order: int = 4) -> np.ndarray:
    """Adams-Bashforth-style coefficients, integrated exactly with
    numpy.poly1d (k-diffusion's linear_multistep_coeff uses quadrature)."""
    n = len(sigmas) - 1
    coeffs = np.zeros((n, order), dtype=np.float64)
    for i in range(n):
        cur_order = min(i + 1, order)
        for j in range(cur_order):
            poly = np.poly1d([1.0])
            denom = 1.0
            for k in range(cur_order):
                if k == j:
                    continue
                poly *= np.poly1d([1.0, -sigmas[i - k]])
                denom *= sigmas[i - j] - sigmas[i - k]
            anti = poly.integ()
            coeffs[i, j] = (anti(sigmas[i + 1]) - anti(sigmas[i])) / denom
    return coeffs


def _multistep(denoise, x, sigmas, order, kw):
    """x += sum_o c[i, o] * d_{i-o}, the derivatives newest first (LMS and
    DEIS, which differ in name only)."""
    coeffs = _f32(_lms_coeffs(sigmas, order))
    sig = _f32(sigmas[:-1])
    sig_t = _table(x, sig)

    def step(i, carry):
        x, hist = carry
        d = to_d(x, float(sig[i]), denoise(x, sig_t[0, i]))
        hist = (d,) + hist[:order - 1]
        upd = None
        for c, h in zip(coeffs[i], hist):
            if c != 0:
                upd = h * float(c) if upd is None else upd + h * float(c)
        return (x if upd is None else x + upd, hist)

    return _run(step, (x, ()), len(sig), **kw)


def sample_lms(denoise: DenoiseFn, x, sigmas: np.ndarray, *, noise=None,
               order: int = 4, **kw):
    return _multistep(denoise, x, sigmas, order, kw)


# ---------------------------------------------------------------------------
# DPM++ family
# ---------------------------------------------------------------------------


def sample_dpmpp_2s_ancestral(denoise: DenoiseFn, x, sigmas: np.ndarray, *,
                              noise=None, eta=1.0, s_noise=1.0, **kw):
    """Skips the midpoint call where sigma_down = 0."""
    down, up = get_ancestral_step(sigmas[:-1], sigmas[1:], eta)
    sig = sigmas[:-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = -np.log(np.maximum(sig, 1e-20))
        t_next = -np.log(np.maximum(down, 1e-20))
        h = t_next - t
        s_mid = np.exp(-(t + 0.5 * h))
    s_mid = np.where(down == 0, sig, s_mid)
    h = _f32(np.where(down == 0, 0.0, h))
    sig, down, up, s_mid = _f32(sig), _f32(down), _f32(up), _f32(s_mid)
    sig_t = _table(x, sig, np.maximum(s_mid, 1e-10))
    nz = _noise(noise, x)

    def step(i, carry):
        (x,) = carry
        s = sig[i]
        denoised = denoise(x, sig_t[0, i])
        if down[i] == 0:
            x = x + to_d(x, float(s), denoised) * float(down[i] - s)
        else:
            x_2 = (float(s_mid[i] / s) * x
                   - float(np.expm1(f32(-0.5) * h[i])) * denoised)
            denoised_2 = denoise(x_2, sig_t[1, i])
            x = (float(down[i] / s) * x
                 - float(np.expm1(-h[i])) * denoised_2)
        return (_add_noise(x, nz, i, 0, f32(s_noise) * up[i]),)

    return _run(step, (x,), len(sig), **kw)


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
    return (_f32(ratio), _f32(expm1_term), _f32(r), use_plain, _f32(sig))


def sample_dpmpp_2m(denoise: DenoiseFn, x, sigmas: np.ndarray, *,
                    noise=None, **kw):
    """DPM-Solver++(2M), the reference's headline sampler."""
    ratio, em1, r, plain, sig = dpmpp_2m_coefficients(sigmas)
    sig_t = _table(x, sig)
    one, two = f32(1), f32(2)

    def step(i, carry):
        x, old_denoised = carry
        denoised = denoise(x, sig_t[0, i])
        if plain[i]:
            d_use = denoised
        else:
            # fp32 scalar arithmetic as in the JAX scan body
            a = one + one / (two * r[i])
            b = one / (two * r[i])
            d_use = float(a) * denoised - float(b) * old_denoised
        return (float(ratio[i]) * x - float(em1[i]) * d_use, denoised)

    return _run(step, (x, torch.zeros_like(x)), len(sig), **kw)


#: The solvers DeepCache, TGATE and bottleneck sampling take: one denoiser
#: call a step and no noise, so a per-step cache rides in a closure
#: (``pipeline._step_cached``) around the plain recurrence.
DEEPCACHE_SOLVERS = frozenset({"euler", "dpmpp_2m"})


def sample_dpmpp_sde(denoise: DenoiseFn, x, sigmas: np.ndarray, *,
                     noise=None, eta=1.0, s_noise=1.0, r=0.5, **kw):
    """DPM++ SDE. noise: (n_steps, 2, *x.shape), two draws a step. Skips the
    second call on a step to sigma = 0."""
    sig, sig_next = sigmas[:-1], sigmas[1:]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = -np.log(np.maximum(sig, 1e-20))
        t_next = -np.log(np.maximum(sig_next, 1e-20))
        h = t_next - t
        s_mid = np.exp(-(t + h * r))
    fac = 1.0 / (2.0 * r)
    sd1, su1 = get_ancestral_step(sig, s_mid, eta)
    sd2, su2 = get_ancestral_step(sig, sig_next, eta)
    with np.errstate(divide="ignore", invalid="ignore"):
        s_down = -np.log(np.maximum(sd1, 1e-20))
        t_next_down = -np.log(np.maximum(sd2, 1e-20))
        em_mid = np.expm1(t - s_down)
        em_full = np.expm1(t - t_next_down)
    final = sig_next == 0
    ratio1 = _f32(np.where(final, 0.0, sd1 / sig))
    em1 = _f32(np.where(final, 0.0, em_mid))
    su1 = _f32(np.where(final, 0.0, su1))
    ratio2 = _f32(np.where(final, 0.0, sd2 / sig))
    em2 = _f32(np.where(final, -1.0, em_full))
    su2 = _f32(np.where(final, 0.0, su2))
    sig32, sig_next32 = _f32(sig), _f32(sig_next)
    sig_t = _table(x, sig, np.maximum(_f32(s_mid), 1e-10))
    nz = _noise(noise, x)
    sn = f32(s_noise)

    def step(i, carry):
        (x,) = carry
        denoised = denoise(x, sig_t[0, i])
        if final[i]:
            d = to_d(x, float(sig32[i]), denoised)
            return (x + d * float(sig_next32[i] - sig32[i]),)
        x_2 = float(ratio1[i]) * x - float(em1[i]) * denoised
        x_2 = _add_noise(x_2, nz, i, 0, sn * su1[i])
        denoised_2 = denoise(x_2, sig_t[1, i])
        denoised_d = (1 - fac) * denoised + fac * denoised_2
        x = float(ratio2[i]) * x - float(em2[i]) * denoised_d
        return (_add_noise(x, nz, i, 1, sn * su2[i]),)

    return _run(step, (x,), len(sig32), **kw)


def sample_dpmpp_2m_sde(denoise: DenoiseFn, x, sigmas: np.ndarray, *,
                        noise=None, eta=1.0, s_noise=1.0,
                        solver_type="midpoint", **kw):
    if solver_type not in ("midpoint", "heun"):
        raise ValueError(f"invalid solver_type {solver_type}")
    n = len(sigmas) - 1
    sig, sig_next = sigmas[:-1], sigmas[1:]
    final = sig_next == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        h = -np.log(np.maximum(sig_next, 1e-20)) + np.log(
            np.maximum(sig, 1e-20))
    h = np.where(final, 1.0, h)
    eta_h = eta * h
    h_last = np.concatenate([[1.0], h[:-1]])
    r = h_last / h
    first = np.zeros(n, bool)
    first[0] = True
    decay = (sig_next / sig) * np.exp(-eta_h)
    em = -np.expm1(-h - eta_h)
    if solver_type == "heun":
        corr = (em / (-h - eta_h) + 1.0) / r
    else:
        corr = 0.5 * em / r
    noise_std = sig_next * np.sqrt(np.maximum(-np.expm1(-2 * eta_h), 0.0))
    decay = _f32(np.where(final, 0.0, decay))
    em = _f32(np.where(final, 1.0, em))
    corr = _f32(np.where(final | first, 0.0, corr))
    nstd = _f32(np.where(final, 0.0, noise_std))
    sig_t = _table(x, sig)
    nz = _noise(noise, x)

    def step(i, carry):
        x, old_denoised = carry
        denoised = denoise(x, sig_t[0, i])
        x = float(decay[i]) * x + float(em[i]) * denoised
        if corr[i] != 0:
            x = x + float(corr[i]) * (denoised - old_denoised)
        return (_add_noise(x, nz, i, 0, f32(s_noise) * nstd[i]), denoised)

    return _run(step, (x, torch.zeros_like(x)), n, **kw)


def sample_dpmpp_3m_sde(denoise: DenoiseFn, x, sigmas: np.ndarray, *,
                        noise=None, eta=1.0, s_noise=1.0, **kw):
    n = len(sigmas) - 1
    sig, sig_next = sigmas[:-1], sigmas[1:]
    final = sig_next == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        h = -np.log(np.maximum(sig_next, 1e-20)) + np.log(
            np.maximum(sig, 1e-20))
    h = np.where(final, 1.0, h)
    h_eta = h * (eta + 1.0)
    r0 = np.concatenate([[1.0], h[:-1]]) / h
    r1 = np.concatenate([[1.0, 1.0], h[:-2]]) / h
    # multistep order: 0 on the first step, 1 on the second, 2 after; 0 on
    # the final sigma = 0 step
    order = np.where(final, 0, np.minimum(np.arange(n), 2))
    noise_std = sig_next * np.sqrt(np.maximum(-np.expm1(-2 * h * eta), 0.0))
    decay = _f32(np.where(final, 0.0, np.exp(-h_eta)))
    em = _f32(np.where(final, 1.0, -np.expm1(-h_eta)))
    h_eta, r0, r1 = _f32(h_eta), _f32(r0), _f32(r1)
    nstd = _f32(np.where(final, 0.0, noise_std))
    sig_t = _table(x, sig)
    nz = _noise(noise, x)
    half = f32(0.5)

    def step(i, carry):
        x, d1m, d2m = carry
        denoised = denoise(x, sig_t[0, i])
        x = float(decay[i]) * x + float(em[i]) * denoised
        if order[i] >= 1:
            phi_2 = np.expm1(-h_eta[i]) / h_eta[i] + f32(1)
            d1_0 = (denoised - d1m) / float(r0[i])
            if order[i] >= 2:
                phi_3 = phi_2 / h_eta[i] - half
                rs = r0[i] + r1[i]
                d1_1 = (d1m - d2m) / float(r1[i])
                d1 = d1_0 + (d1_0 - d1_1) * float(r0[i]) / float(rs)
                d2 = (d1_0 - d1_1) / float(rs)
                x = x + (float(phi_2) * d1 - float(phi_3) * d2)
            else:
                x = x + float(phi_2) * d1_0
        x = _add_noise(x, nz, i, 0, f32(s_noise) * nstd[i])
        return (x, denoised, d1m)

    zeros = torch.zeros_like(x)
    return _run(step, (x, zeros, zeros), n, **kw)


# ---------------------------------------------------------------------------
# Restart sampling
# ---------------------------------------------------------------------------


def _restart_plan(sigmas: np.ndarray, restart_list=None):
    steps = len(sigmas) - 1
    if restart_list is None:
        if steps >= 20:
            restart_steps = 9
            restart_times = 1
            if steps >= 36:
                restart_steps = steps // 4
                restart_times = 2
            sigmas = get_sigmas_karras(
                steps - restart_steps * restart_times,
                float(sigmas[-2]), float(sigmas[0]))
            restart_list = {0.1: [restart_steps + 1, restart_times, 2]}
        else:
            restart_list = {}
    idx_list = {int(np.argmin(np.abs(sigmas - key))): value
                for key, value in restart_list.items()}
    step_list = []
    for i in range(len(sigmas) - 1):
        step_list.append((sigmas[i], sigmas[i + 1]))
        if i + 1 in idx_list:
            restart_steps, restart_times, restart_max = idx_list[i + 1]
            min_idx = i + 1
            max_idx = int(np.argmin(np.abs(sigmas - restart_max)))
            if max_idx < min_idx:
                sigma_restart = get_sigmas_karras(
                    restart_steps, float(sigmas[min_idx]),
                    float(sigmas[max_idx]))[:-1]
                for _ in range(restart_times):
                    step_list.extend(zip(sigma_restart[:-1],
                                         sigma_restart[1:]))
    return step_list


def restart_plan_len(sigmas: np.ndarray, restart_list=None) -> int:
    return len(_restart_plan(sigmas, restart_list))


def sample_restart(denoise: DenoiseFn, x, sigmas: np.ndarray, *,
                   noise=None, s_noise=1.0, restart_list=None, **kw):
    """noise: (restart_plan_len(sigmas), *x.shape). Heun steps along the
    plan, with noise injected where the plan jumps back up. Skips the
    correction's call on a step to sigma = 0."""
    step_list = _restart_plan(sigmas, restart_list)
    old_s = np.array([s[0] for s in step_list])
    new_s = np.array([s[1] for s in step_list])
    last_s = np.concatenate([[old_s[0]], new_s[:-1]])
    inject = _f32(np.where(
        last_s < old_s, np.sqrt(np.maximum(old_s ** 2 - last_s ** 2, 0.0)),
        0.0))
    old32, new32 = _f32(old_s), _f32(new_s)
    new_safe = np.maximum(new32, f32(1e-10))
    sig_t = _table(x, old_s, new_safe)
    nz = _noise(noise, x)

    def step(i, carry):
        (x,) = carry
        x = _add_noise(x, nz, i, 0, f32(s_noise) * inject[i])
        denoised = denoise(x, sig_t[0, i])
        d = to_d(x, float(old32[i]), denoised)
        dt = float(new32[i] - old32[i])
        x_euler = x + d * dt
        if new32[i] == 0:
            return (x_euler,)
        d_2 = to_d(x_euler, float(new_safe[i]), denoise(x_euler, sig_t[1, i]))
        return (x + (d + d_2) / 2 * dt,)

    return _run(step, (x,), len(step_list), **kw)


# ---------------------------------------------------------------------------
# DPM-Solver fast / adaptive (img-to-img in the reference's table: the sigma
# range is (sigmas[-2], sigmas[0]))
# ---------------------------------------------------------------------------


def _sigma(x, t) -> torch.Tensor:
    """exp(-t) in fp32 as a 0-d tensor on x's device (a fill, no copy)."""
    return torch.full((), float(np.exp(-f32(t))), dtype=torch.float32,
                      device=x.device)


def _dpm_eps(denoise, x, t):
    sigma = np.exp(-f32(t))
    return (x - denoise(x, _sigma(x, t))) / float(sigma)


def _dpm_1_step(x, t, t_next, eps):
    h = f32(t_next) - f32(t)
    return x - float(np.exp(-f32(t_next)) * np.expm1(h)) * eps


def _dpm_2_stage(denoise, x, t, h, eps, r1):
    """The first stage of DPM-Solver-2/3: (s1, eps at u1)."""
    s1 = f32(t) + f32(r1) * h
    u1 = x - float(np.exp(-s1) * np.expm1(f32(r1) * h)) * eps
    return s1, _dpm_eps(denoise, u1, s1)


def _dpm_2_step(denoise, x, t, t_next, eps, r1=0.5, stage=None):
    h = f32(t_next) - f32(t)
    _, eps_r1 = stage or _dpm_2_stage(denoise, x, t, h, eps, r1)
    e = np.exp(-f32(t_next))
    return (x - float(e * np.expm1(h)) * eps
            - float(e / f32(2 * r1) * np.expm1(h)) * (eps_r1 - eps))


def _dpm_3_step(denoise, x, t, t_next, eps, r1=1.0 / 3, r2=2.0 / 3,
                stage=None):
    h = f32(t_next) - f32(t)
    _, eps_r1 = stage or _dpm_2_stage(denoise, x, t, h, eps, r1)
    ratio = f32(r2 / r1)
    r2 = f32(r2)
    s2 = f32(t) + r2 * h
    e2 = np.exp(-s2)
    u2 = (x - float(e2 * np.expm1(r2 * h)) * eps
          - float(e2 * ratio * (np.expm1(r2 * h) / (r2 * h) - f32(1)))
          * (eps_r1 - eps))
    eps_r2 = _dpm_eps(denoise, u2, s2)
    e = np.exp(-f32(t_next))
    return (x - float(e * np.expm1(h)) * eps
            - float(e / r2 * (np.expm1(h) / h - f32(1))) * (eps_r2 - eps))


def sample_dpm_fast(denoise: DenoiseFn, x, sigmas: np.ndarray, *,
                    return_history=False, noise=None, carry_in=None,
                    segment=None, return_carry=False, **_):
    """k-diffusion sample_dpm_fast: t-uniform segments with orders
    [3, 3, ..., tail], as the JAX package unrolls them on the host."""
    _no_chunks("sample_dpm_fast", carry_in, segment, return_carry)
    n = len(sigmas) - 1
    t_start, t_end = -np.log(float(sigmas[0])), -np.log(float(sigmas[-2]))
    m = n // 3 + 1
    ts = np.linspace(t_start, t_end, m + 1)
    if n % 3 == 0:
        orders = [3] * (m - 2) + [2, 1]
    else:
        orders = [3] * (m - 1) + [n % 3]

    hist = []
    for i, order in enumerate(orders):
        t, t_next = f32(ts[i]), f32(ts[i + 1])
        eps = _dpm_eps(denoise, x, t)
        if order == 1:
            x = _dpm_1_step(x, t, t_next, eps)
        elif order == 2:
            x = _dpm_2_step(denoise, x, t, t_next, eps)
        else:
            x = _dpm_3_step(denoise, x, t, t_next, eps)
        hist.append(x)
    return (x, torch.stack(hist)) if return_history else x


def sample_dpm_adaptive(denoise: DenoiseFn, x, sigmas: np.ndarray, *,
                        return_history=False, noise=None, order=3,
                        rtol=0.05, atol=0.0078, h_init=0.05, pcoeff=0.0,
                        icoeff=1.0, dcoeff=0.0, accept_safety=0.81,
                        max_steps=200, carry_in=None, segment=None,
                        return_carry=False, **_):
    """k-diffusion sample_dpm_adaptive: embedded-order error control with a
    PID step-size controller, at most ``max_steps`` tries.

    The one solver that reads from the device every step: whether a try is
    accepted, and the next step size, depend on the try's error, so each try
    copies that one scalar to the host (the JAX package keeps the loop on
    the device in a ``lax.while_loop``). The controller's arithmetic is
    fp32 on the host, as the JAX loop's is on the device. With order 3 the
    first stage (eps at s + h/3) serves both embedded steps: 3 denoiser
    calls a try, where the JAX body makes 4, one of them on the same
    inputs."""
    _no_chunks("sample_dpm_adaptive", carry_in, segment, return_carry)
    t_start, t_end = -np.log(float(sigmas[0])), -np.log(float(sigmas[-2]))
    b1 = f32((pcoeff + icoeff + dcoeff) / order)
    b2 = f32(-(pcoeff + 2 * dcoeff) / order)
    b3 = f32(dcoeff / order)
    root_numel = float(np.prod(x.shape)) ** 0.5
    s, h = f32(t_start), f32(abs(h_init))
    t_end32, stop = f32(t_end), f32(t_end - 1e-5)
    errs = [f32(0)] * 3
    x_prev = x
    tries = 0
    while s < stop and tries < max_steps:
        t = min(t_end32, s + h)
        hh = t - s
        eps = _dpm_eps(denoise, x, s)
        if order == 2:
            x_low = _dpm_1_step(x, s, t, eps)
            x_high = _dpm_2_step(denoise, x, s, t, eps)
        else:
            stage = _dpm_2_stage(denoise, x, s, hh, eps, 1.0 / 3)
            x_low = _dpm_2_step(denoise, x, s, t, eps, r1=1.0 / 3,
                                stage=stage)
            x_high = _dpm_3_step(denoise, x, s, t, eps, stage=stage)
        delta = torch.clamp(rtol * torch.maximum(x_low.abs(), x_prev.abs()),
                            min=atol)
        error = f32((((x_low - x_high) / delta).square().sum().sqrt()
                     / root_numel).item())
        inv_error = f32(1) / (error + f32(1e-8))
        e1 = inv_error if errs[1] == 0 else errs[1]
        e2 = inv_error if errs[2] == 0 else errs[2]
        factor = inv_error ** b1 * e1 ** b2 * e2 ** b3
        factor = f32(1) + np.arctan(factor - f32(1))
        if factor >= f32(accept_safety):
            x, x_prev, s = x_high, x_low, t
            errs = [inv_error, inv_error, e1]
        else:
            errs = [inv_error, errs[1], errs[2]]
        h = h * factor
        tries += 1
    return (x, x[None]) if return_history else x


# ---------------------------------------------------------------------------
# The reference's diffusers-scheduler solvers: UniPC, DEIS, SA-Solver
# ---------------------------------------------------------------------------


def sample_unipc(denoise: DenoiseFn, x, sigmas: np.ndarray, *, noise=None,
                 solver_type="bh2", order=2, **kw):
    """UniPC multistep predictor-corrector (order 2) in sigma space with
    data prediction; bh1: B(h) = h, bh2: B(h) = expm1(h). Step i evaluates
    m_i at the predicted sample, corrects x_i with the previous transition's
    full-order system and predicts x_{i+1}; model outputs are not
    re-evaluated after the correction (as in diffusers)."""
    n = len(sigmas) - 1
    sig, sig_next = sigmas[:-1], sigmas[1:]
    final = sig_next == 0
    with np.errstate(divide="ignore"):
        lam = -np.log(np.maximum(sig, 1e-20))
        lam_next = -np.log(np.maximum(sig_next, 1e-20))
    h = np.where(final, 1.0, lam_next - lam)
    hh = -h
    h_phi_1 = np.expm1(hh)
    phi2 = h_phi_1 / hh - 1.0
    b_h = hh if solver_type == "bh1" else np.expm1(hh)
    # predictor: previous evaluation point r0_p = (lam_{i-1} - lam_i) / h_i
    h_prev = np.concatenate([[1.0], h[:-1]])
    r0_p = -h_prev / h
    rho_p = (phi2 / b_h) / np.where(r0_p == 0, 1.0, r0_p)
    # corrector for transition i-1 -> i, applied at step i >= 1: order 2
    # system [[r0, 1], [r0^2, 1]] x = [phi2/Bh, 2 phi3/Bh]; order 1 on step
    # 1 (rhos_c = [0.5]); the 1/r0 of D1s is folded into rc0
    rc0, rc_t = np.zeros(n), np.zeros(n)
    ratio_c, em_c, bh_c = np.zeros(n), np.zeros(n), np.zeros(n)
    for i in range(1, n):
        hp = h[i - 1]
        hhp = -hp
        p1 = np.expm1(hhp)
        p2 = p1 / hhp - 1.0
        p3 = p2 / hhp - 0.5
        bhp = hhp if solver_type == "bh1" else np.expm1(hhp)
        ratio_c[i] = sig[i] / sig[i - 1]
        em_c[i] = p1
        bh_c[i] = bhp
        if i == 1:
            rc_t[i] = 0.5
        else:
            r0 = (lam[i - 2] - lam[i - 1]) / hp
            sol = np.linalg.solve(np.array([[r0, 1.0], [r0 * r0, 1.0]]),
                                  np.array([p2 / bhp, 2.0 * p3 / bhp]))
            rc0[i] = sol[0] / r0
            rc_t[i] = sol[1]
    ratio = _f32(np.where(final, 0.0, sig_next / sig))
    em = _f32(np.where(final, -1.0, h_phi_1))
    rho_p = _f32(np.where(final, 0.0, rho_p))
    b_h = _f32(np.where(final, 0.0, b_h))
    rc0, rc_t, ratio_c, em_c, bh_c = (_f32(a) for a in
                                      (rc0, rc_t, ratio_c, em_c, bh_c))
    sig_t = _table(x, sig)

    def step(i, carry):
        x_t, x_prev, m_prev, m_prev2 = carry
        m_i = denoise(x_t, sig_t[0, i])
        if i == 0:
            x_c = x_t
        else:
            d1_t = m_i - m_prev
            d1s = m_prev2 - m_prev
            x_c = (float(ratio_c[i]) * x_prev - float(em_c[i]) * m_prev
                   - float(bh_c[i]) * (float(rc0[i]) * d1s
                                       + float(rc_t[i]) * d1_t))
        x_next = float(ratio[i]) * x_c - float(em[i]) * m_i
        if i > 0 and b_h[i] * rho_p[i] != 0:
            x_next = x_next - float(b_h[i] * rho_p[i]) * (m_prev - m_i)
        return (x_next, x_c, m_i, m_prev)

    zeros = torch.zeros_like(x)
    return _run(step, (x, x, zeros, zeros), n, **kw)


def sample_deis(denoise: DenoiseFn, x, sigmas: np.ndarray, *, noise=None,
                order=3, **kw):
    """DEIS: Adams-Bashforth multistep on the eps prediction over sigma,
    with exactly integrated coefficients (LMS's loop at order 3)."""
    return _multistep(denoise, x, sigmas, order, kw)


def _sa_coeffs(lams_pts, lam_s, lam_t, c):
    """b_i = c e^{-c lam_t} Int_{lam_s}^{lam_t} e^{c lam} l_i(lam) dlam for
    the Lagrange basis l_i on ``lams_pts``, by 32-point Gauss-Legendre
    quadrature."""
    nodes, weights = np.polynomial.legendre.leggauss(32)
    mid = 0.5 * (lam_s + lam_t)
    half = 0.5 * (lam_t - lam_s)
    xs = mid + half * nodes
    out = []
    for i, li in enumerate(lams_pts):
        l_vals = np.ones_like(xs)
        for j, lj in enumerate(lams_pts):
            if j == i:
                continue
            l_vals *= (xs - lj) / (li - lj)
        integ = half * np.sum(weights * np.exp(c * (xs - lam_t)) * l_vals)
        out.append(c * integ)
    return out


def sample_sa_solver(denoise: DenoiseFn, x, sigmas: np.ndarray, *,
                     noise=None, tau_t_range=(0.2, 0.8), tau_value=1.0,
                     s_noise=1.0, **kw):
    """SA-Solver: stochastic Adams, predictor and corrector of order 2, data
    prediction. noise: (n_steps, *x.shape). The stochasticity tau is
    ``tau_value`` where the source sigma's normalised train timestep lies
    in ``tau_t_range`` and 0 elsewhere.

    As in the JAX package, that timestep comes from the sigma table of a
    default ``ModelConfig()`` (SD1.5's betas), not from the pipeline's
    model: a model with other betas gets SD1.5's tau window."""
    from ..config import ModelConfig
    from .schedules import ddpm_sigma_table, sigma_to_t

    n = len(sigmas) - 1
    sig, sig_next = sigmas[:-1], sigmas[1:]
    final = sig_next == 0
    with np.errstate(divide="ignore"):
        lam = -np.log(np.maximum(sig, 1e-20))
        lam_next = -np.log(np.maximum(sig_next, 1e-20))
    table = ddpm_sigma_table(ModelConfig())
    t_norm = np.array([sigma_to_t(s, table) / len(table) for s in sig])
    taus = np.where((t_norm >= tau_t_range[0]) & (t_norm <= tau_t_range[1]),
                    tau_value, 0.0)
    # predictor for transition i -> i+1 on {lam_{i-1}, lam_i} (order 1 on
    # the first step); corrector for i-1 -> i on {lam_{i-1}, lam_i}
    dec_p, bp_prev, bp_cur, nstd = (np.zeros(n) for _ in range(4))
    dec_c, bc_prev, bc_cur = (np.zeros(n) for _ in range(3))
    for i in range(n):
        if final[i]:
            continue
        c = 1.0 + taus[i] ** 2
        h = lam_next[i] - lam[i]
        dec_p[i] = np.exp(-c * h)
        if i == 0:
            (bp_cur[i],) = _sa_coeffs([lam[i]], lam[i], lam_next[i], c)
        else:
            bp_prev[i], bp_cur[i] = _sa_coeffs(
                [lam[i - 1], lam[i]], lam[i], lam_next[i], c)
        nstd[i] = sig_next[i] * np.sqrt(
            max(-np.expm1(-2.0 * taus[i] ** 2 * h), 0.0))
        if i >= 1:
            cc = 1.0 + taus[i - 1] ** 2
            dec_c[i] = np.exp(-cc * (lam[i] - lam[i - 1]))
            bc_prev[i], bc_cur[i] = _sa_coeffs(
                [lam[i - 1], lam[i]], lam[i - 1], lam[i], cc)
    dec_p = _f32(np.where(final, 0.0, dec_p))
    bp_cur = _f32(np.where(final, 1.0, bp_cur))
    bp_prev, nstd, dec_c, bc_prev, bc_cur = (
        _f32(a) for a in (bp_prev, nstd, dec_c, bc_prev, bc_cur))
    sig_t = _table(x, sig)
    nz = _noise(noise, x)

    def step(i, carry):
        x_t, x_prev, m_prev = carry
        m_i = denoise(x_t, sig_t[0, i])
        if i == 0:
            x_c = x_t
        else:  # corrector (Adams-Moulton over the previous transition)
            x_c = (float(dec_c[i]) * x_prev + float(bc_prev[i]) * m_prev
                   + float(bc_cur[i]) * m_i)
        if final[i]:
            x_next = float(bp_cur[i]) * m_i
        else:  # predictor (Adams-Bashforth)
            x_next = (float(dec_p[i]) * x_c + float(bp_prev[i]) * m_prev
                      + float(bp_cur[i]) * m_i)
        return (_add_noise(x_next, nz, i, 0, f32(s_noise) * nstd[i]), x_c,
                m_i)

    return _run(step, (x, x, torch.zeros_like(x)), n, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# name -> (solver fn, noise draws per step [0 = deterministic], default opts)
SOLVERS = {
    "euler": (sample_euler, 0, {}),
    "euler_ancestral": (sample_euler_ancestral, 1, {}),
    "lms": (sample_lms, 0, {}),
    "lcm": (sample_lcm, 1, {}),
    "heun": (sample_heun, 0, {}),
    "heunpp2": (sample_heunpp2, 0, {}),
    "ddpm": (sample_ddpm, 1, {}),
    "dpm_2": (sample_dpm_2, 0, {"discard_next_to_last_sigma": True}),
    "dpm_2_ancestral": (sample_dpm_2_ancestral, 1,
                        {"discard_next_to_last_sigma": True}),
    "dpmpp_2s_ancestral": (sample_dpmpp_2s_ancestral, 1, {}),
    "dpmpp_2m": (sample_dpmpp_2m, 0, {}),
    "dpmpp_sde": (sample_dpmpp_sde, 2, {"brownian": True}),
    "dpmpp_2m_sde": (sample_dpmpp_2m_sde, 1, {"brownian": True}),
    "dpmpp_2m_sde_heun": (sample_dpmpp_2m_sde, 1,
                          {"brownian": True, "solver_type": "heun"}),
    "dpmpp_3m_sde": (sample_dpmpp_3m_sde, 1,
                     {"brownian": True, "discard_next_to_last_sigma": True}),
    "restart": (sample_restart, 1, {}),
    "dpm_fast": (sample_dpm_fast, 0, {}),
    "dpm_adaptive": (sample_dpm_adaptive, 0, {}),
    "unipc_bh1": (sample_unipc, 0, {"solver_type": "bh1"}),
    "unipc_bh2": (sample_unipc, 0, {"solver_type": "bh2"}),
    "deis": (sample_deis, 0, {}),
    "sa_solver": (sample_sa_solver, 1, {}),
}

#: Solvers that run in chunks (``carry_in``/``segment``/``return_carry``):
#: all but the host-unrolled dpm_fast and the adaptive dpm_adaptive.
CHUNKABLE = frozenset(SOLVERS) - {"dpm_fast", "dpm_adaptive"}


def scan_length(solver_name: str, sigmas: np.ndarray) -> int:
    """Steps of a schedule's loop (restart's plan adds its restarts)."""
    if solver_name == "restart":
        return restart_plan_len(sigmas)
    return len(sigmas) - 1
