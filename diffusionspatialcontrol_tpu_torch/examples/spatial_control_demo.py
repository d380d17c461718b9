"""End-to-end demo: region-controlled generation and DAAM heatmaps (port of
``examples/spatial_control_demo.py``).

Runs on the card unless ``--device cpu`` is given. With no checkpoint it
uses random-init SD1.5 weights: the outputs are noise textures, but every
stage runs as in production (A1111 prompt weighting, region
rasterization, K1's region attention, DPM++ 2M Karras, VAE decode, DAAM
extraction, the native PNG encoder).

    python -m diffusionspatialcontrol_tpu_torch.examples.spatial_control_demo \\
        [--ckpt /path/to/diffusers/dir] [--size 256] [--steps 8] [--seed 7]

Writes image.png, region_overlay.png and daam_cat.png into ``--out``
(``build/examples_out`` under the working directory by default).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

PROMPT = "a (red cat:1.2) sitting on a bench, a blue bird in the sky"
OUT_DIR = os.path.join("build", "examples_out")


def run(cfg, params, tokenizer, size: int, steps: int, seed: int,
        out_dir: str, device=None, dtype=torch.bfloat16) -> Dict[str, str]:
    """Generate one ``size``^2 image with a two-phrase map, its DAAM map of
    "red cat" over the trajectory, and the map's overlay; write the three
    PNGs into ``out_dir``. Returns their paths by name."""
    from ..config import DEFAULT_NEGATIVE_PROMPT, GenerationConfig
    from ..introspect import daam
    from ..pipeline.pipeline import StableDiffusionTorch
    from ..runtime import native
    from ..utils import region_ui

    pipe = StableDiffusionTorch(cfg, params, tokenizer=tokenizer,
                                device=device)
    gen = GenerationConfig(height=size, width=size,
                           num_inference_steps=steps, dtype=dtype)
    context, ids = pipe.encode_prompt(
        [PROMPT], [DEFAULT_NEGATIVE_PROMPT], clip_skip=2, mode="a1111")

    h = w = size
    cat_mask = np.zeros((h, w), np.float32)
    cat_mask[h // 3:, : w // 2] = 1.0
    bird_mask = np.zeros((h, w), np.float32)
    bird_mask[: h // 3, w // 2:] = 1.0
    state = region_ui.build_region_state(
        ["red cat", "blue bird"], [cat_mask, bird_mask],
        weights=[0.8, 0.7], mask_outsides=[0.2, 0.1])
    biases = pipe.encode_region([state], ids, height=h, width=w)

    final, history = pipe.txt2img(context, gen, seed=seed,
                                  region_biases=biases, decode=False,
                                  return_history=True)
    u8 = pipe.to_uint8(pipe.decode_latents(final)).cpu().numpy()

    sigmas, _ = pipe._schedule(gen)
    heat = daam.heatmaps_for_trajectory(
        pipe.params, cfg, history, sigmas, context[1:],
        tuple(b[1:] for b in biases))
    # the "red cat" tokens sit right after BOS in the cond ids
    cat_ids = tokenizer.encode("red cat", add_special_tokens=False)
    positions = [i for i, t in enumerate(ids[0]) if t in cat_ids]
    cat_map = daam.token_heatmap(heat, positions or [1])[0].cpu().numpy()
    cat_img = (255 * (cat_map - cat_map.min())
               / max(float(np.ptp(cat_map)), 1e-8)).astype(np.uint8)
    cat_rgb = np.stack([cat_img, np.zeros_like(cat_img), 255 - cat_img], -1)

    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, rgb in (
            ("image", u8[0]),
            ("region_overlay",
             region_ui.create_mixed_img(state, w, h)[..., :3]),
            ("daam_cat", cat_rgb)):
        paths[name] = os.path.join(out_dir, f"{name}.png")
        with open(paths[name], "wb") as f:
            f.write(native.encode_png(np.ascontiguousarray(rgb)))
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None,
                    help="diffusers checkpoint dir (optional)")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    from ..config import sd15_config
    from ..models import factory
    from ..text.tokenizer import load_tokenizer

    cfg = sd15_config()
    if args.ckpt:
        from ..convert.hf import load_pipeline_params

        params = load_pipeline_params(args.ckpt, cfg, torch.bfloat16,
                                      device=args.device)
        tokenizer = load_tokenizer(os.path.join(args.ckpt, "tokenizer"))
    else:
        print("no checkpoint given: random-init weights (noise outputs)")
        params = factory.with_text_bias(factory.init_pipeline_params(
            0, cfg, torch.bfloat16, device=args.device))
        tokenizer = load_tokenizer()
    paths = run(cfg, params, tokenizer, args.size, args.steps, args.seed,
                args.out, device=args.device)
    print(f"wrote {', '.join(paths.values())}")


if __name__ == "__main__":
    main()
