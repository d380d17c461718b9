"""A one-rank NCCL mesh on the card: the explicit-SPMD sampler against the
pipeline on one device, tiny config in fp32.

Marked ``cuda``: it needs a CUDA device and nvcc, and skips without them.
This file imports only torch and the port (no JAX), so it runs on a machine
with a card and no JAX; ``--noconftest`` skips tests/conftest.py, which
loads JAX:

    python -m pytest tests/test_torch_parallel_cuda.py -m cuda -q --noconftest

The CPU tests (tests/test_torch_parallel.py) run several gloo ranks;
``chip_smoke.py`` phase multi runs one NCCL rank and two gloo ranks on one
card at full width.
"""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.models.factory import (
    init_pipeline_params,
)
from diffusionspatialcontrol_tpu_torch.parallel.mesh import init_data_parallel
from diffusionspatialcontrol_tpu_torch.parallel.spmd import sample_spmd
from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
    StableDiffusionTorch,
)
from diffusionspatialcontrol_tpu_torch.text.tokenizer import HashTokenizer

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_one_rank_nccl_mesh_matches_one_device(dev, tmp_path):
    """16 mapped cross-attentions x 4 UNet calls: 64 all-reduces, then one
    all-gather; the latents within 1e-3 of txt2img's (the two std formulas
    differ by rounding)."""
    cfg = tcfg.tiny_config()
    pipe = StableDiffusionTorch(
        cfg, init_pipeline_params(0, cfg, torch.float32, device=dev),
        tokenizer=HashTokenizer(), device=dev)
    ctx, ids = pipe.encode_prompt(["a red cat on a bench"] * 2, [""] * 2)
    mask = np.zeros((64, 64), np.float32)
    mask[:, :32] = 1.0
    biases = pipe.encode_region(
        [{"red cat": {"mask": mask, "weight": 1.0, "mask_outsides": 0.2}}] * 2,
        ids, height=64, width=64)
    gen = tcfg.GenerationConfig(height=64, width=64, num_inference_steps=4,
                                dtype=torch.float32)
    mesh = init_data_parallel(init_method=f"file://{tmp_path / 'store'}",
                              rank=0, world_size=1,
                              timeout=datetime.timedelta(seconds=60))
    try:
        got = sample_spmd(pipe, ctx, gen, [3, 4], mesh, region_biases=biases,
                          check_collectives=True)
    finally:
        dist.destroy_process_group()
    assert mesh.backend == "nccl" and mesh.device.type == "cuda"
    assert dict(mesh.counts) == {"all_reduce": 64, "all_gather": 1}
    want = pipe.txt2img(ctx, gen, seed=[3, 4], region_biases=biases,
                        decode=False)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
