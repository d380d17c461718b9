"""Region-map front-end utilities (port of ``utils/region_ui.py``; numpy
only).

Grayscale sketch or upload maps (drawn pixels < 255), colour clustering of
an uploaded colour region map (the reference's ``unique_colors`` /
``get_color_mask`` / ``extract_color_textboxes``, app.py:1443-1486), the
region state dict, and the overlay visualization (``create_mixed_img``,
app.py:1260-1278). The port keeps its own copy of ``resize_nearest``
(``ops/preprocess.py:141``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    sh, sw = img.shape[:2]
    ys = (np.arange(h) * sh / h).astype(int).clip(0, sh - 1)
    xs = (np.arange(w) * sw / w).astype(int).clip(0, sw - 1)
    return img[np.ix_(ys, xs)]


def mask_from_grayscale_map(gray: np.ndarray) -> np.ndarray:
    """Reference convention: drawn region = value < 255
    (encode_region_map_function.py:49)."""
    return (np.asarray(gray) < 255).astype(np.float32)


def unique_colors(image: np.ndarray, threshold: float = 0.01
                  ) -> List[Tuple[int, int, int]]:
    """Colors covering more than ``threshold`` of the image
    (reference: app.py:1453-1459)."""
    flat = image.reshape(-1, image.shape[-1])
    colors, counts = np.unique(flat, axis=0, return_counts=True)
    total = flat.shape[0]
    out = []
    for color, count in zip(colors, counts):
        if count / total > threshold:
            out.append(tuple(int(c) for c in color))
    return out


def color_mask(image: np.ndarray, color: Tuple[int, int, int],
               threshold: float = 30.0) -> np.ndarray:
    """Binary mask of pixels within squared-distance ``threshold`` of the
    color (reference get_color_mask semantics, app.py:1443-1450)."""
    diff = np.sum(
        (image.astype(np.int64) - np.asarray(color, np.int64)) ** 2, axis=-1
    )
    return (diff <= threshold).astype(np.float32)


def extract_color_masks(color_map: np.ndarray,
                        max_colors: int = 8,
                        coverage_threshold: float = 0.01,
                        ) -> List[np.ndarray]:
    """Cluster an uploaded color region map into per-color binary masks
    (reference: extract_color_textboxes, app.py:1461-1486). Pure black is
    remapped first so it survives as a region color (app.py:1410-1424).
    Returns masks with 1 = inside region."""
    img = np.asarray(color_map, np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    img = img[..., :3].copy()

    # remap pure black to a fresh color so black regions are preserved
    colors = unique_colors(img, coverage_threshold)
    rng = np.random.RandomState(0)
    new = tuple(int(c) for c in rng.randint(1, 256, 3))
    while new in colors:
        new = tuple(int(c) for c in rng.randint(1, 256, 3))
    img[np.all(img == (0, 0, 0), axis=-1)] = new
    colors = unique_colors(img, coverage_threshold)

    masks = []
    for color in colors[:max_colors]:
        m = color_mask(img, color)
        if m.mean() > 0.0:
            masks.append(m)
    return masks


def build_region_state(
    phrases: List[str],
    masks: List[np.ndarray],
    weights: Optional[List[float]] = None,
    mask_outsides: Optional[List[float]] = None,
) -> Dict[str, Dict]:
    """Assemble the region state dict consumed by
    ``StableDiffusionTorch.encode_region``; the phrase list mirrors the
    comma split in the reference's detect_text (app.py:1302-1330)."""
    weights = weights or [1.0] * len(phrases)
    mask_outsides = mask_outsides or [0.0] * len(phrases)
    state = {}
    for phrase, mask, w, mo in zip(phrases, masks, weights, mask_outsides):
        state[phrase.strip()] = {
            "mask": np.asarray(mask, np.float32),
            "weight": float(w),
            "mask_outsides": float(mo),
        }
    return state


_PALETTE = np.asarray(
    [
        [255, 87, 87],
        [87, 156, 255],
        [87, 255, 151],
        [255, 219, 87],
        [196, 87, 255],
        [255, 140, 87],
        [87, 245, 255],
        [255, 87, 194],
    ],
    np.uint8,
)


def create_mixed_img(state: Dict[str, Dict], width: int, height: int,
                     selected: str = "") -> np.ndarray:
    """RGBA overlay of all region masks (reference: create_mixed_img,
    app.py:1260-1278)."""
    out = np.full((height, width, 4), 255, np.uint8)
    for idx, (key, item) in enumerate(state.items()):
        mask = item.get("mask")
        if mask is None:
            continue
        m = resize_nearest(np.asarray(mask), height, width) > 0.5
        alpha = 200 if key == selected else 150
        color = _PALETTE[idx % len(_PALETTE)]
        out[m] = np.concatenate([color, [alpha]])
    return out
