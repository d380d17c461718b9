"""The benchmark's one traffic generator: requests drawn from a seed by the
parameters of a mix file (``traffic/<mix>.json``). A mix's ``kind`` is
``txt2img`` (the default: prompts, region maps and noise seeds) or
``image`` (photographs for a control preprocessor).

A mix is a closed loop of one client: the next request is sent when the
last one's images are on the host.

``image``: each request is one (``height``, ``width``, 3) uint8 picture:
a linear gradient between two random colours, ``shapes`` rectangles and
ellipses of random colours over it, and Gaussian grain of ``grain``
levels. A run draws a pool of ``pool`` pictures from its seed once, at
its first request (set-up), and each request takes one of them, drawn
from its own stream; so drawing pictures costs the window nothing.

``txt2img``: every request of a mix has the same
size, batch, steps and sampler, so every seed gives the same work in
another order of prompts, maps and noise. A request's prompt joins
``phrases`` phrases of the mix's vocabulary (``traffic/vocab/<name>.json``)
and one style, each phrase wrapped in A1111 emphasis ``(phrase:w)`` with
the probability ``emphasis.share``; with ``region_map`` each phrase gets a
mask (a rectangle or an ellipse at a random place, at the image's size), a
``weight`` and a ``mask_outsides``. The noise seed is new for every
request. Request ``i`` is drawn from its own stream of the run's seed, so
it does not depend on how many requests came before it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
WARMUP, WINDOW, CHECK, POOL = 0, 1, 2, 3  # the seed's streams
_POOLS: Dict[Tuple[str, int], List[np.ndarray]] = {}


def _entropy(seed: int) -> int:
    return int(seed) % 2 ** 64


def load_mix(name: str, root: Path = HERE / "traffic") -> dict:
    spec = json.loads((root / f"{name}.json").read_text())
    if spec.get("kind", "txt2img") == "image":
        return {**spec, "_name": name}
    vocab = json.loads((root / "vocab" / f"{spec['vocabulary']}.json")
                       .read_text())
    return {**spec, "_name": name, "_vocab": vocab}


def rasterize(shape: dict, height: int, width: int) -> np.ndarray:
    """A (height, width) float32 mask, 1 inside, from fractions of the
    image: centre (cx, cy) and half-extents (rx, ry)."""
    y = (np.arange(height, dtype=np.float64) + 0.5)[:, None] / height
    x = (np.arange(width, dtype=np.float64) + 0.5)[None, :] / width
    dx = (x - shape["cx"]) / shape["rx"]
    dy = (y - shape["cy"]) / shape["ry"]
    if shape["kind"] == "rect":
        inside = (np.abs(dx) <= 1.0) & (np.abs(dy) <= 1.0)
    elif shape["kind"] == "ellipse":
        inside = dx * dx + dy * dy <= 1.0
    else:
        raise ValueError(f"mask kind {shape['kind']!r}")
    return inside.astype(np.float32)


def picture(rng: np.random.Generator, height: int, width: int,
            shapes: List[int], grain: float) -> np.ndarray:
    """One (height, width, 3) uint8 picture of an ``image`` mix."""
    angle = rng.uniform(0.0, 2 * np.pi)
    y = (np.arange(height, dtype=np.float32) + 0.5)[:, None] / height
    x = (np.arange(width, dtype=np.float32) + 0.5)[None, :] / width
    t = np.clip(0.5 + (x - 0.5) * np.cos(angle) + (y - 0.5) * np.sin(angle),
                0.0, 1.0)[..., None]
    lo, hi = rng.uniform(0, 255, 3), rng.uniform(0, 255, 3)
    img = (lo + t * (hi - lo)).astype(np.float32)
    for _ in range(int(rng.integers(shapes[0], shapes[1] + 1))):
        shape = {"kind": ("rect", "ellipse")[int(rng.integers(2))],
                 "cx": float(rng.uniform(0.1, 0.9)),
                 "cy": float(rng.uniform(0.1, 0.9)),
                 "rx": float(rng.uniform(0.04, 0.25)),
                 "ry": float(rng.uniform(0.04, 0.25))}
        inside = rasterize(shape, height, width).astype(bool)
        img[inside] = rng.uniform(0, 255, 3).astype(np.float32)
    img += rng.normal(0.0, grain, img.shape).astype(np.float32)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _pool(mix: dict, seed: int) -> List[np.ndarray]:
    key = (mix["_name"], int(seed))
    if key not in _POOLS:
        _POOLS.clear()  # one run, one pool
        _POOLS[key] = [
            picture(np.random.default_rng([_entropy(seed), POOL, k]),
                    mix["height"], mix["width"], mix["shapes"],
                    mix["grain"])
            for k in range(int(mix["pool"]))]
    return _POOLS[key]


def request(mix: dict, seed: int, index: int, stream: int = WINDOW) -> dict:
    """Request ``index`` of the run seeded ``seed``: the inputs both the
    program and the reference receive."""
    rng = np.random.default_rng([_entropy(seed), stream, index])
    if mix.get("kind", "txt2img") == "image":
        pool = _pool(mix, seed)
        k = int(rng.integers(len(pool)))
        return {"image": pool[k], "picture": k,
                "height": mix["height"], "width": mix["width"]}
    vocab = mix["_vocab"]
    lo, hi = mix["phrases"]["min"], mix["phrases"]["max"]
    n = int(rng.integers(lo, hi + 1))
    picks = rng.choice(len(vocab["subjects"]), size=n, replace=False)
    phrases = [vocab["subjects"][int(i)] for i in picks]
    parts = []
    emph = mix.get("emphasis", {"share": 0.0})
    for p in phrases:
        if rng.random() < emph["share"]:
            w = round(float(rng.uniform(*emph["weight"])), 2)
            parts.append(f"({p}:{w})")
        else:
            parts.append(p)
    style = vocab["styles"][int(rng.integers(len(vocab["styles"])))]
    req = {
        "prompt": ", ".join(parts + [style]),
        "negative_prompt": mix["negative_prompt"],
        "height": mix["height"], "width": mix["width"],
        "num_images_per_prompt": mix["num_images_per_prompt"],
        "steps": mix["steps"], "cfg_scale": mix["cfg_scale"],
        "sampler": mix["sampler"], "encoding_mode": mix["encoding_mode"],
        "clip_skip": mix["clip_skip"],
        "seed": int(rng.integers(0, 2 ** 31 - 64)),
        "region_state": None,
    }
    if mix["region_map"]:
        state: Dict[str, dict] = {}
        for p in phrases:
            shape = {
                "kind": mix["mask_shapes"][
                    int(rng.integers(len(mix["mask_shapes"])))],
                "cx": float(rng.uniform(0.25, 0.75)),
                "cy": float(rng.uniform(0.25, 0.75)),
                "rx": float(rng.uniform(0.15, 0.3)),
                "ry": float(rng.uniform(0.15, 0.3)),
            }
            state[p] = {
                "mask": rasterize(shape, mix["height"], mix["width"]),
                "weight": round(float(rng.uniform(*mix["weight"])), 3),
                "mask_outsides": round(float(
                    rng.uniform(*mix["mask_outsides"])), 3),
            }
        req["region_state"] = state
    return req


class CheckSample:
    """The window's requests the output check compares: ``check_requests``
    of the completed ones, a uniform sample drawn from the seed as they
    complete (reservoir sampling), so a run keeps only their answers."""

    def __init__(self, mix: dict, seed: int):
        self.k = int(mix["check_requests"])
        self.rng = np.random.default_rng([_entropy(seed), CHECK])
        self.kept: List[int] = []
        self.seen = 0

    def offer(self, index: int) -> Tuple[bool, Optional[int]]:
        """Whether to keep completed request ``index``, and the kept one
        it replaces (None if none)."""
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(index)
            return True, None
        j = int(self.rng.integers(self.seen))
        if j >= self.k:
            return False, None
        old, self.kept[j] = self.kept[j], index
        return True, old

    def indices(self) -> List[int]:
        return sorted(self.kept)

