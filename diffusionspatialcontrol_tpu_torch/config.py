"""Typed model/pipeline configuration (PyTorch port).

A copy of ``diffusionspatialcontrol_tpu/config.py``'s model configs and
presets (SD1.5, its 9-channel and asymmetric-VAE inpaint variants, SD2.1
with and without v-prediction, tiny) and the server's ``MODEL_FAMILIES``,
with ``GenerationConfig.dtype`` holding a ``torch.dtype``. The JAX
package's module imports ``jax.numpy``, so the port keeps its own copy instead
of importing it.

Defaults mirror the reference's evaluation protocol: CFG 7.5, clip-skip 2,
512x512, DPM++ 2M Karras, 25 steps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text-encoder architecture (SD1.x: openai/clip-vit-large-patch14)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    # SD1.x CLIP uses quick_gelu; SD2.x (OpenCLIP) uses gelu.
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """UNet2DCondition architecture (SD1.x / SD2.x family)."""

    sample_size: int = 64
    in_channels: int = 4  # 9 for the inpaint UNet variant
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # Heads per level. SD1.x fixes 8 heads everywhere.
    num_attention_heads: Tuple[int, ...] = (8, 8, 8, 8)
    # Which down levels have cross-attention transformers.
    attn_levels: Tuple[bool, ...] = (True, True, True, False)
    transformer_layers_per_block: int = 1
    use_linear_projection: bool = False  # True for SD2.x
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    time_embed_dim_mult: int = 4

    @property
    def num_levels(self) -> int:
        return len(self.block_out_channels)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * self.time_embed_dim_mult

    def heads_at(self, level: int) -> int:
        return self.num_attention_heads[level]


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL architecture (SD1.x/2.x share this)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    # AsymmetricAutoencoderKL-style decoder (inpainting): a mask-condition
    # encoder feeds known-pixel features into every decoder scale, and the
    # decoder may be wider and deeper than the encoder.
    asymmetric: bool = False
    decoder_block_out_channels: Optional[Tuple[int, ...]] = None
    decoder_layers_per_block: Optional[int] = None

    @property
    def scale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A complete SD model family description."""

    name: str = "sd15"
    clip: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    prediction_type: str = "epsilon"  # or "v_prediction"
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    clip_skip_default: int = 2


def sd15_config(**overrides) -> ModelConfig:
    return dataclasses.replace(ModelConfig(), **overrides)


def sd15_inpaint_config() -> ModelConfig:
    cfg = ModelConfig()
    return dataclasses.replace(
        cfg, name="sd15-inpaint",
        unet=dataclasses.replace(cfg.unet, in_channels=9))


def sd15_asym_inpaint_config(scale: float = 1.0) -> ModelConfig:
    """9-channel inpaint UNet + asymmetric (mask-conditioned) VAE decoder,
    its channels widened by ``scale`` and one resnet deeper a block."""
    cfg = sd15_inpaint_config()
    dec = tuple(int(c * scale) for c in cfg.vae.block_out_channels)
    return dataclasses.replace(
        cfg, name="sd15-inpaint-asym",
        vae=dataclasses.replace(
            cfg.vae, asymmetric=True, decoder_block_out_channels=dec,
            decoder_layers_per_block=cfg.vae.layers_per_block + 1))


def sd21_config(v_prediction: bool = False) -> ModelConfig:
    """SD 2.1 (base: epsilon at 512^2; -v: v_prediction at 768^2): OpenCLIP
    text encoder (gelu), 64-wide heads, linear transformer projections."""
    return ModelConfig(
        name="sd21-v" if v_prediction else "sd21",
        clip=CLIPTextConfig(hidden_size=1024, intermediate_size=4096,
                            num_layers=23, num_heads=16, hidden_act="gelu"),
        unet=UNetConfig(cross_attention_dim=1024,
                        num_attention_heads=(5, 10, 20, 20),
                        use_linear_projection=True),
        prediction_type="v_prediction" if v_prediction else "epsilon")


def tiny_config() -> ModelConfig:
    """Miniature SD topology (same block structure, ~1/10 widths) for CPU
    tests and the card-vs-CPU check."""
    return ModelConfig(
        name="tiny",
        clip=CLIPTextConfig(vocab_size=49408, hidden_size=64,
                            intermediate_size=128, num_layers=2,
                            num_heads=4),
        unet=UNetConfig(block_out_channels=(32, 64, 128, 128),
                        cross_attention_dim=64,
                        num_attention_heads=(2, 2, 2, 2),
                        norm_num_groups=8),
        vae=VAEConfig(block_out_channels=(16, 32, 32, 32),
                      norm_num_groups=4),
    )


# The presets the server's ``--random-model NAME:FAMILY`` takes.
MODEL_FAMILIES = {
    "sd15": sd15_config,
    "sd15-inpaint": sd15_inpaint_config,
    "tiny": tiny_config,
    "sd21": sd21_config,
}


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """One generation request's parameters."""

    height: int = 512
    width: int = 512
    num_inference_steps: int = 25
    guidance_scale: float = 7.5
    guidance_rescale: float = 0.0
    sampler: str = "dpmpp_2m"
    schedule: str = "karras"
    eta: float = 1.0
    num_images_per_prompt: int = 1
    clip_skip: int = 2
    dtype: torch.dtype = torch.bfloat16

    @property
    def latent_height(self) -> int:
        return self.height // 8

    @property
    def latent_width(self) -> int:
        return self.width // 8


DEFAULT_NEGATIVE_PROMPT = "bad quality, low quality, jpeg artifact, cropped"
"""The reference evaluation protocol's fixed negative prompt."""
