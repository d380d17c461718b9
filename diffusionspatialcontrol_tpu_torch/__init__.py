"""PyTorch/CUDA port of the spatial-control Stable Diffusion pipeline.

Mirrors ``diffusionspatialcontrol_tpu``'s module tree. The JAX package stays
the numerical reference; this package imports neither JAX nor it. Plain
tensor code is PyTorch; every TPU (Pallas) kernel on the ported path is a
hand-written CUDA kernel under ``csrc/`` built with ``nvcc`` at first use
(``ops/kernels``).
"""

from .config import (  # noqa: F401
    CLIPTextConfig,
    ControlNetConfig,
    GenerationConfig,
    ModelConfig,
    T2IAdapterConfig,
    UNetConfig,
    VAEConfig,
    sd15_asym_inpaint_config,
    sd15_config,
    sd15_inpaint_config,
    sd21_config,
    tiny_config,
)
from .device import resolve_device  # noqa: F401

__version__ = "0.1.0"
