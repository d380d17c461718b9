"""The port's schedules, sampler table and solvers against the JAX package,
and its chunked solver runs against its plain ones, on the CPU.

Solvers run on a closed-form denoiser, written once below with arithmetic
operators only, so that numpy, JAX and torch arrays all take it: the ideal
denoiser of Gaussian data N(mu, var), plus a small odd nonlinearity so that
errors in the solvers' nonlinear paths show. Both sides get the same
initial x and the same injected noise table. Tolerance: the final x and the
per-step history within 1e-5 of the array's max abs (fp32 on both sides,
scalar coefficients from the same float64 host math; the packages differ
in the order of a few fp32 operations), except dpm_adaptive (see ``BOUND``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu import registry as jregistry
from diffusionspatialcontrol_tpu.samplers import schedules as jsched
from diffusionspatialcontrol_tpu.samplers import solvers as jsolvers
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch import registry as tregistry
from diffusionspatialcontrol_tpu_torch.samplers import schedules as tsched
from diffusionspatialcontrol_tpu_torch.samplers import solvers as tsolvers

# dpm_adaptive sizes each try by the RMS of x_low - x_high over a bound
# (about rtol |x|): a difference of two nearby fp32 results, so one ulp of
# exp(-t) (XLA's against the C library's) moves the error by ~1e-4 relative
# and each step size with it. Both packages take the same tries
# (test_dpm_adaptive_takes_the_jax_tries); x moves by ~2e-4 of its max.
BOUND = {"dpm_adaptive": 1e-3}
SCHEDULES = ("karras", "exponential", "polyexponential", "default")
SHAPE = (2, 4, 4, 4)
VAR = 0.6


def closed_form(x, sigma, mu):
    """D(x; sigma) for data N(mu, VAR), plus 0.05 c y / (1 + y^2)."""
    c = VAR / (VAR + sigma * sigma)
    y = x - mu
    return mu + c * y + 0.05 * c * y / (1.0 + y * y)


def _steps(name):
    # restart only restarts at 20 steps and more; 9 steps give dpm_fast
    # every order (3, 3, 2, 1)
    return 21 if name == "restart" else 9


def _inputs(name, schedule="karras"):
    _, draws, defaults = jsolvers.SOLVERS[name]
    sigmas = jsched.get_sigmas(
        jcfg.sd15_config(), _steps(name), schedule,
        defaults.get("discard_next_to_last_sigma", False))
    rng = np.random.default_rng(7)
    mu = rng.standard_normal(SHAPE).astype(np.float32) * 0.5
    x0 = (rng.standard_normal(SHAPE) * sigmas[0]).astype(np.float32)
    noise = None
    if draws:
        n = jsolvers.scan_length(name, sigmas)
        noise = rng.standard_normal((n, draws) + SHAPE).astype(np.float32)
    opts = {k: v for k, v in defaults.items()
            if k not in ("discard_next_to_last_sigma", "brownian")}
    return sigmas, mu, x0, noise, opts


def _torch(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, what, bound=1e-5):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    assert np.isfinite(want).all(), what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=bound * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("steps", [4, 25])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedules_match_jax_bitwise(schedule, steps):
    for discard in (False, True):
        for jc, tc in ((jcfg.sd15_config(), tcfg.sd15_config()),
                       (jcfg.tiny_config(), tcfg.tiny_config())):
            want = jsched.get_sigmas(jc, steps, schedule, discard)
            got = tsched.get_sigmas(tc, steps, schedule, discard)
            assert len(got) == steps + 1
            np.testing.assert_array_equal(got, want)
    table = jsched.ddpm_sigma_table(jcfg.sd15_config())
    s = jsched.get_sigmas(jcfg.sd15_config(), steps, schedule)
    np.testing.assert_array_equal(tsched.sigma_to_t(s, table),
                                  jsched.sigma_to_t(s, table))


def test_sampler_table_matches_jax():
    assert tregistry.DEFAULT_SAMPLER == jregistry.DEFAULT_SAMPLER
    assert tregistry.ENCODING_MODES == jregistry.ENCODING_MODES
    assert list(tregistry.SAMPLERS) == list(jregistry.SAMPLERS)
    for name, spec in jregistry.SAMPLERS.items():
        assert (dataclasses.asdict(tregistry.SAMPLERS[name])
                == dataclasses.asdict(spec)), name
    assert len(tregistry.SAMPLERS) == 82
    assert set(tsolvers.SOLVERS) == set(jsolvers.SOLVERS)
    assert {s.solver for s in tregistry.SAMPLERS.values()} == set(
        tsolvers.SOLVERS)
    assert tsolvers.CHUNKABLE == jsolvers.CHUNKABLE
    for name, (_, draws, defaults) in jsolvers.SOLVERS.items():
        assert tsolvers.SOLVERS[name][1:] == (draws, defaults), name


@pytest.mark.parametrize("name", sorted(jsolvers.SOLVERS))
def test_solver_matches_jax_on_closed_form_denoiser(name):
    sigmas, mu, x0, noise, opts = _inputs(name)
    jfn, tfn = jsolvers.SOLVERS[name][0], tsolvers.SOLVERS[name][0]
    jmu, tmu = jnp.asarray(mu), torch.from_numpy(mu)
    calls = []

    def tden(x, s):
        assert s.dtype == torch.float32 and s.dim() == 0
        calls.append(float(s))
        return closed_form(x, s, tmu)

    want_x, want_h = jfn(lambda x, s: closed_form(x, s, jmu),
                         jnp.asarray(x0), sigmas,
                         noise=None if noise is None else jnp.asarray(noise),
                         return_history=True, **opts)
    got_x, got_h = tfn(tden, torch.from_numpy(x0), sigmas,
                       noise=_torch(noise), return_history=True, **opts)
    bound = BOUND.get(name, 1e-5)
    _close(got_x.numpy(), want_x, f"{name} x", bound)
    _close(got_h.numpy(), want_h, f"{name} history", bound)
    assert calls and min(calls) > 0


def test_dpm_adaptive_takes_the_jax_tries():
    """The same tries as the JAX loop: 4 denoiser calls a try there, 3 in
    the port, which evaluates the shared first stage once."""
    sigmas, mu, x0, _, _ = _inputs("dpm_adaptive")
    jcalls, tcalls = [], []

    def jden(x, s):
        jcalls.append(s)
        return closed_form(x, s, jnp.asarray(mu))

    def tden(x, s):
        tcalls.append(s)
        return closed_form(x, s, torch.from_numpy(mu))

    with jax.disable_jit():  # the while loop in Python: every call counted
        jsolvers.sample_dpm_adaptive(jden, jnp.asarray(x0), sigmas)
    tsolvers.sample_dpm_adaptive(tden, torch.from_numpy(x0), sigmas)
    assert len(jcalls) % 4 == 0 and len(tcalls) % 3 == 0
    assert len(jcalls) // 4 == len(tcalls) // 3 > 1


@pytest.mark.parametrize("schedule", SCHEDULES[1:])
@pytest.mark.parametrize("name", ["euler_ancestral", "dpmpp_2m_sde_heun",
                                  "unipc_bh1", "sa_solver"])
def test_solver_matches_jax_on_other_schedules(name, schedule):
    sigmas, mu, x0, noise, opts = _inputs(name, schedule)
    jfn, tfn = jsolvers.SOLVERS[name][0], tsolvers.SOLVERS[name][0]
    want = jfn(lambda x, s: closed_form(x, s, jnp.asarray(mu)),
               jnp.asarray(x0), sigmas,
               noise=None if noise is None else jnp.asarray(noise), **opts)
    got = tfn(lambda x, s: closed_form(x, s, torch.from_numpy(mu)),
              torch.from_numpy(x0), sigmas, noise=_torch(noise), **opts)
    _close(got.numpy(), want, f"{name} {schedule}")


@pytest.mark.parametrize("name", sorted(tsolvers.CHUNKABLE))
def test_chunked_solver_equals_plain_bitwise(name):
    """Chunks of 1, 3 and the rest, each resumed from the carry the last
    returned, give the plain run's x and history bit for bit."""
    sigmas, mu, x0, noise, opts = _inputs(name)
    fn = tsolvers.SOLVERS[name][0]
    n = tsolvers.scan_length(name, sigmas)

    def run(**kw):
        return fn(lambda x, s: closed_form(x, s, torch.from_numpy(mu)),
                  torch.from_numpy(x0), sigmas, noise=_torch(noise), **kw,
                  **opts)

    want_x, want_h = run(return_history=True)
    carry, hist, pos = None, [], 0
    for size in (1, 3, n - 4):
        x, carry, h = run(carry_in=carry, segment=(pos, size),
                          return_carry=True, return_history=True)
        hist.append(h)
        pos += size
    assert torch.equal(x, want_x)
    assert torch.equal(torch.cat(hist), want_h)


@pytest.mark.parametrize("name", ["dpm_fast", "dpm_adaptive"])
def test_unchunkable_solvers_refuse_segments(name):
    sigmas, mu, x0, _, _ = _inputs(name)
    with pytest.raises(ValueError):
        tsolvers.SOLVERS[name][0](lambda x, s: x, torch.from_numpy(x0),
                                  sigmas, segment=(0, 2))


def test_solvers_skip_only_discarded_calls():
    """The port's denoiser calls per solver on a 9-step schedule: the JAX
    scan's, less the calls whose results a jnp.where discards."""
    want = {"euler": 9, "euler_ancestral": 9, "lms": 9, "lcm": 9, "ddpm": 9,
            "dpmpp_2m": 9, "dpmpp_2m_sde": 9, "dpmpp_2m_sde_heun": 9,
            "dpmpp_3m_sde": 9, "unipc_bh1": 9, "unipc_bh2": 9, "deis": 9,
            "sa_solver": 9, "heun": 17, "dpm_2": 17, "dpm_2_ancestral": 17,
            "dpmpp_2s_ancestral": 17, "dpmpp_sde": 17, "heunpp2": 24,
            "dpm_fast": 9}
    for name, n in want.items():
        sigmas, mu, x0, noise, opts = _inputs(name)
        calls = []

        def den(x, s):
            calls.append(s)
            return closed_form(x, s, torch.from_numpy(mu))

        tsolvers.SOLVERS[name][0](den, torch.from_numpy(x0), sigmas,
                                  noise=_torch(noise), **opts)
        assert len(calls) == n, name
