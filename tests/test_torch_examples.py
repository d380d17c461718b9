"""The port's two demos (``diffusionspatialcontrol_tpu_torch/examples/``),
their inner functions on the tiny config on the CPU: the PNGs they write
decode to the expected sizes and are not blank.
"""

import numpy as np
import torch

from chip_smoke import decode_png
from diffusionspatialcontrol_tpu_torch import tiny_config
from diffusionspatialcontrol_tpu_torch.app.api import ModelManager
from diffusionspatialcontrol_tpu_torch.examples import (
    controlnet_hires_demo,
    spatial_control_demo,
)
from diffusionspatialcontrol_tpu_torch.models.factory import (
    init_pipeline_params,
    with_text_bias,
)
from diffusionspatialcontrol_tpu_torch.text.tokenizer import load_tokenizer

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)


def _png(path):
    with open(path, "rb") as f:
        return decode_png(f.read())


def test_spatial_control_demo(tmp_path):
    """The image, the map's overlay and the DAAM map of "red cat", 64^2,
    2 steps."""
    cfg = tiny_config()
    params = with_text_bias(init_pipeline_params(0, cfg, torch.float32,
                                                 device="cpu"))
    paths = spatial_control_demo.run(cfg, params, load_tokenizer(), 64, 2, 7,
                                     str(tmp_path), device="cpu",
                                     dtype=torch.float32)
    assert sorted(paths) == ["daam_cat", "image", "region_overlay"]
    image = _png(paths["image"])
    assert image.shape == (64, 64, 3) and image.std() > 0
    overlay = _png(paths["region_overlay"])
    assert overlay.shape == (64, 64, 3) and len(np.unique(overlay)) > 1
    heat = _png(paths["daam_cat"])  # at the latent size
    assert heat.shape == (8, 8, 3) and heat[..., 0].max() == 255


def test_controlnet_hires_demo(tmp_path):
    """A Canny-preprocessed ControlNet unit and the hires pass, 64^2 ->
    128^2, 2 steps, with latent previews of both passes."""
    manager = ModelManager(dtype=torch.float32, device="cpu")
    manager.register_random("model", tiny_config())
    result = controlnet_hires_demo.run(manager, 64, 2, str(tmp_path),
                                       torch.float32)
    image = _png(tmp_path / "controlnet_hires.png")
    assert image.shape == (128, 128, 3) and image.std() > 0
    np.testing.assert_array_equal(image, result["images"][0])
    previews = sorted(p.name for p in tmp_path.glob("preview_*.png"))
    assert previews == [f"preview_{i:02d}.png"
                        for i in range(len(result["previews"]))]
    sizes = [_png(tmp_path / p).shape[:2] for p in previews]
    assert sizes[0] == (64, 64) and sizes[-1] == (128, 128)
