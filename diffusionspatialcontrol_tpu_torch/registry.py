"""The app's tables (port of ``registry.py``).

``SAMPLERS`` maps each name of the app's sampler dropdown to a
``SamplerSpec``: the solver (a key of ``samplers.solvers.SOLVERS``) and the
schedule. A request runs it as
``GenerationConfig(sampler=spec.solver, schedule=spec.schedule)``. Beside it:
the prompt modes, the adapter and ControlNet model maps, the model zoo (52
checkpoints; ``SD2_MODELS`` take the SD2.1 preset), the request watchdog's
timeout and ``resolve_sampler``.
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

IP_ADAPTER_MODELS = {
    "IP-Adapter": "ip-adapter_sd15.bin",
    "IP-Adapter Light": "ip-adapter_sd15_light.bin",
    "IP-Adapter Face": "ip-adapter-full-face_sd15.bin",
    "IP-Adapter FaceID": "ip-adapter-faceid_sd15.bin",
    "IP-Adapter Plus": "ip-adapter-plus_sd15.bin",
    "IP-Adapter Plus Face": "ip-adapter-plus-face_sd15.bin",
}

CONTROLNET_MODELS = {
    "Canny": "lllyasviel/control_v11p_sd15_canny",
    "Depth": "lllyasviel/control_v11f1p_sd15_depth",
    "Openpose": "lllyasviel/control_v11p_sd15_openpose",
    "Soft Edge": "lllyasviel/control_v11p_sd15_softedge",
    "Lineart": "ControlNet-1-1-preview/control_v11p_sd15_lineart",
    "Lineart (anime)": "lllyasviel/control_v11p_sd15s2_lineart_anime",
    "Scribble": "lllyasviel/control_v11p_sd15_scribble",
    "MLSD": "lllyasviel/control_v11p_sd15_mlsd",
    "Semantic Segmentation": "lllyasviel/control_v11p_sd15_seg",
    "Normal Map": "lllyasviel/control_v11p_sd15_normalbae",
    "Shuffle": "lllyasviel/control_v11e_sd15_shuffle",
    "Instruct Pix2Pix": "lllyasviel/control_v11e_sd15_ip2p",
}

T2I_ADAPTER_MODELS = {
    "Canny": "TencentARC/t2iadapter_canny_sd15v2",
    "Sketch": "TencentARC/t2iadapter_sketch_sd15v2",
    "Color": "TencentARC/t2iadapter_color_sd14v1",
    "Depth": "TencentARC/t2iadapter_depth_sd15v2",
    "Openpose": "TencentARC/t2iadapter_openpose_sd14v1",
    "Semantic Segmentation": "TencentARC/t2iadapter_seg_sd14v1",
    "Zoedepth": "TencentARC/t2iadapter_zoedepth_sd15v1",
}

# Full model zoo of the reference UI (source/app.py:111-164). Checkpoints are
# converted from local diffusers-layout directories (zero-egress: no hub
# download here); the HF ids document provenance.
MODEL_ZOO = [
    ("AbyssOrangeMix2", "Korakoe/AbyssOrangeMix2-HF"),
    ("BloodOrangeMix", "WarriorMama777/BloodOrangeMix"),
    ("ElyOrangeMix", "WarriorMama777/ElyOrangeMix"),
    ("Pastal Mix", "JamesFlare/pastel-mix"),
    ("Basil Mix", "nuigurumi/basil_mix"),
    ("Stable Diffusion v1.5", "runwayml/stable-diffusion-v1-5"),
    ("Stable Diffusion v2.1", "stabilityai/stable-diffusion-2-1-base"),
    ("Realistic Vision v1.4", "SG161222/Realistic_Vision_V1.4"),
    ("Dreamlike Photoreal v2.0", "dreamlike-art/dreamlike-photoreal-2.0"),
    ("Waifu-diffusion v1.4", "hakurei/waifu-diffusion"),
    ("Stable diffusion PixelArt v1.4",
     "Onodofthenorth/SD_PixelArt_SpriteSheet_Generator"),
    ("Anything v3", "Linaqruf/anything-v3.0"),
    ("Sketch style", "Cosk/sketchstyle-cutesexyrobutts"),
    ("Anything v5", "stablediffusionapi/anything-v5"),
    ("Counterfeit v2.5", "gsdf/Counterfeit-V2.5"),
    ("Edge of realism", "stablediffusionapi/edge-of-realism"),
    ("Photorealistic fuen", "claudfuen/photorealistic-fuen-v1"),
    ("Protogen x5.8 (Scifi-Anime)",
     "darkstorm2150/Protogen_x5.8_Official_Release"),
    ("Dreamlike Anime", "dreamlike-art/dreamlike-anime-1.0"),
    ("Something V2.2", "NoCrypt/SomethingV2_2"),
    ("Realistic Vision v3.0", "SG161222/Realistic_Vision_V3.0_VAE"),
    ("Noosphere v3.0", "digiplay/Noosphere_v3"),
    ("Beauty Fool v1.2", "digiplay/BeautyFool_v1.2VAE_pruned"),
    ("Prefix RealisticMix v1.0", "digiplay/PrefixRealisticMix_v1"),
    ("Prefix FantasyMix v1.0", "digiplay/PrefixFantasyMix_v1"),
    ("Unstable Diffusers YamerMIX v3.0",
     "digiplay/unstableDiffusersYamerMIX_v3"),
    ("GTA5 Artwork Diffusion", "ItsJayQz/GTA5_Artwork_Diffusion"),
    ("Open Journey", "prompthero/openjourney"),
    ("SoapMix2.5D v2.0", "digiplay/SoapMix2.5D_v2"),
    ("CoffeeMix v2.0", "digiplay/CoffeeMix_v2"),
    ("helloworld v3.0", "digiplay/helloworld_v3"),
    ("ARRealVX v1.1", "digiplay/ARRealVX1.1"),
    ("Fishmix v1.0", "digiplay/fishmix_other_v1"),
    ("DiamondCoalMix v2.0",
     "digiplay/DiamondCoalMix_v2_pruned_diffusers"),
    ("ISOMix v3.22", "digiplay/ISOmix_v3.22"),
    ("Pika v2", "digiplay/Pika_v2"),
    ("BluePencil v0.9b", "digiplay/bluePencil_v09b"),
    ("MeinaPastel v6", "Meina/MeinaPastel_V6"),
    ("Realistic Vision v4", "SG161222/Realistic_Vision_V4.0"),
    ("Revanimated v1.2.2", "stablediffusionapi/revanimated"),
    ("NeverEnding Dream v1.2.2", "Lykon/NeverEnding-Dream"),
    ("CetusMixCoda", "Stax124/CetusMixCoda"),
    ("NewMarsMix R11", "digiplay/NewMarsMix_R11"),
    ("Juggernaut Final", "digiplay/Juggernaut_final"),
    ("BlankCanvas v1.0", "digiplay/BlankCanvas_v1"),
    ("FumizukiMix v1.0", "digiplay/FumizukiMix_v1"),
    ("CampurSari v1.0", "digiplay/CampurSari_Gen1"),
    ("Realisian v1.0", "digiplay/Realisian_v5"),
    ("Real Epic Majic Revolution v1.0",
     "digiplay/RealEpicMajicRevolution_v1"),
    ("QuinceMix v2.0", "digiplay/quincemix_v2"),
    ("Counterfeit v3.0", "stablediffusionapi/counterfeit-v30"),
    ("MeinaMix v11.0", "Meina/MeinaMix_V11"),
]

# SD2.x checkpoints in the zoo need the sd21 architecture preset.
SD2_MODELS = {"stabilityai/stable-diffusion-2-1-base"}

INFERENCE_TIMEOUT_S = 360  # reference watchdog (source/app.py:261)


def resolve_sampler(name: str) -> SamplerSpec:
    if name not in SAMPLERS:
        raise KeyError(
            f"unknown sampler {name!r}; available: {sorted(SAMPLERS)[:8]}..."
        )
    return SAMPLERS[name]
