"""End-to-end demo: ControlNet-conditioned generation with the hires fix
(port of ``examples/controlnet_hires_demo.py``).

A control image is preprocessed (Canny), drives a ControlNet unit through
the base pass and is prepared again at the target size for the hires pass;
the latent previews span both passes. Runs on the card unless ``--device
cpu`` is given. With no checkpoint the model is the tiny config with
random weights in fp32 (the outputs are noise textures, but every stage
runs as in production).

    python -m diffusionspatialcontrol_tpu_torch.examples.controlnet_hires_demo \\
        [--ckpt /path/to/diffusers/dir] [--size 64] [--steps 3]

Writes controlnet_hires.png and preview_XX.png into ``--out``
(``build/examples_out`` under the working directory by default).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .spatial_control_demo import OUT_DIR


def run(manager, size: int, steps: int, out_dir: str, dtype):
    """The ControlNet + hires request on ``manager``'s model "model" at
    ``size``^2 (hires to twice that), its image and previews written into
    ``out_dir``; returns ``inference()``'s result."""
    from ..app.api import ControlNetUnit, inference
    from ..runtime import native

    # a synthetic "photo": a bright square on a dark background
    control = np.zeros((size, size, 3), np.float32)
    control[size // 4: 3 * size // 4, size // 4: 3 * size // 4] = 1.0
    result = inference(
        manager, prompt="a glowing cube on a table, studio lighting",
        model="model", sampler="DPM++ 2M Karras", steps=steps, width=size,
        height=size, seed=7, encoding_mode="short",
        controlnet_units=[ControlNetUnit(model="Canny", image=control,
                                         scale=0.8, preprocessor="Canny")],
        hires_scale=2.0, hires_strength=0.6, latent_preview=True,
        dtype=dtype)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "controlnet_hires.png"), "wb") as f:
        f.write(native.encode_png(result["images"][0]))
    for i, gallery in enumerate(result["previews"]):
        with open(os.path.join(out_dir, f"preview_{i:02d}.png"), "wb") as f:
            f.write(native.encode_png(gallery[0]))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    from ..app.api import ModelManager
    from ..config import tiny_config

    dtype = torch.float32 if args.ckpt is None else torch.bfloat16
    manager = ModelManager(dtype=dtype, device=args.device)
    if args.ckpt:
        manager.register("model", args.ckpt)
    else:
        manager.register_random("model", tiny_config())
    result = run(manager, args.size, args.steps, args.out, dtype)
    img, previews = result["images"][0], result["previews"]
    print(f"final image {img.shape} + {len(previews)} previews "
          f"({previews[0].shape[1:3]} -> {previews[-1].shape[1:3]}) -> "
          f"{args.out}")
    print("timings:", result["timings"])


if __name__ == "__main__":
    main()
