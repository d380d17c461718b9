"""The app's sampler table and prompt modes (port of the sampler part of
``registry.py``).

``SAMPLERS`` maps each name of the app's sampler dropdown to a
``SamplerSpec``: the solver (a key of ``samplers.solvers.SOLVERS``) and the
schedule. A request runs it as
``GenerationConfig(sampler=spec.solver, schedule=spec.schedule)``. The model
zoo and the adapter maps come with the app layer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    solver: str  # key into samplers.solvers.SOLVERS
    schedule: str = "default"  # karras | exponential | polyexponential | ...
    discard_next_to_last_sigma: bool = False
    brownian_noise: bool = False
    second_order: bool = False
    solver_type: Optional[str] = None  # 2M-SDE heun variant


def _table() -> Dict[str, SamplerSpec]:
    base = {
        "Euler": SamplerSpec("euler"),
        "Euler a": SamplerSpec("euler_ancestral"),
        "LMS": SamplerSpec("lms"),
        "LCM": SamplerSpec("lcm", second_order=True),
        "Heun": SamplerSpec("heun", second_order=True),
        "Heun++": SamplerSpec("heunpp2", second_order=True),
        "DDPM": SamplerSpec("ddpm", second_order=True),
        "DPM2": SamplerSpec("dpm_2", discard_next_to_last_sigma=True),
        "DPM2 a": SamplerSpec("dpm_2_ancestral",
                              discard_next_to_last_sigma=True),
        "DPM++ 2S a": SamplerSpec("dpmpp_2s_ancestral", second_order=True),
        "DPM++ 2M": SamplerSpec("dpmpp_2m"),
        "DPM++ SDE": SamplerSpec("dpmpp_sde", second_order=True,
                                 brownian_noise=True),
        "DPM++ 2M SDE": SamplerSpec("dpmpp_2m_sde", brownian_noise=True),
        "DPM++ 2M SDE Heun": SamplerSpec("dpmpp_2m_sde_heun",
                                         brownian_noise=True,
                                         solver_type="heun"),
        "DPM++ 3M SDE": SamplerSpec("dpmpp_3m_sde",
                                    discard_next_to_last_sigma=True,
                                    brownian_noise=True),
        "DPM fast (img-to-img)": SamplerSpec("dpm_fast"),
        "DPM adaptive (img-to-img)": SamplerSpec("dpm_adaptive"),
        "Restart": SamplerSpec("restart", second_order=True),
        # the reference's diffusers-scheduler samplers
        "DEIS": SamplerSpec("deis"),
        "UniPC Time Uniform 1": SamplerSpec("unipc_bh1"),
        "UniPC Time Uniform 2": SamplerSpec("unipc_bh2"),
        "SA-Solver": SamplerSpec("sa_solver", brownian_noise=True),
    }
    schedule_suffix = {
        "": "default",
        " Karras": "karras",
        " Exponential": "exponential",
        " Polyexponential": "polyexponential",
    }
    out: Dict[str, SamplerSpec] = {}
    # every solver under every schedule, except the two img-to-img solvers,
    # which take their sigma range from the default schedule only
    for suffix, sched in schedule_suffix.items():
        for name, spec in base.items():
            if "img-to-img" in name and suffix:
                continue
            out[name + suffix] = dataclasses.replace(spec, schedule=sched)
    return out


SAMPLERS: Dict[str, SamplerSpec] = _table()

# The reference's headline configuration.
DEFAULT_SAMPLER = "DPM++ 2M Karras"

ENCODING_MODES = {
    "Automatic111 Encoding": "a1111",
    "Long Prompt Encoding": "long",
    "Short Prompt Encoding": "short",
}
