"""Control-signal preprocessors (port of ``ops/preprocess.py``).

The pure-image detectors (Canny, colour blocks for the T2I colour adapter,
content shuffle, scribble inversion, grayscale) are numpy, the JAX
package's code, so they give its values bit for bit. The model-based
detectors' closures (``make_*_preprocessor``) run their networks
(``models/``) in PyTorch on the parameters' device and their pre- and
post-processing as the JAX package does: ``jax.image.resize`` by
``ops/resize.py:resize`` (antialiased when shrinking, as its default), the
numpy tails as they are, OpenCV's Sobel by ``ops/cv.py``.
``ModelManager.get_preprocessor`` builds them.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .cv import sobel
from .resize import resize


def _to_gray(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    if img.ndim == 3:
        return img @ np.asarray([0.299, 0.587, 0.114], np.float32)
    return img


def _gaussian_kernel(sigma: float):
    radius = max(1, int(3 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _convolve_sep(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    pad = len(k) // 2
    p = np.pad(img, ((pad, pad), (0, 0)), mode="edge")
    out = np.zeros_like(img)
    for i, kv in enumerate(k):
        out += kv * p[i : i + img.shape[0]]
    p = np.pad(out, ((0, 0), (pad, pad)), mode="edge")
    out2 = np.zeros_like(img)
    for i, kv in enumerate(k):
        out2 += kv * p[:, i : i + img.shape[1]]
    return out2


def canny(img: np.ndarray, low: float = 100.0, high: float = 200.0,
          sigma: float = 1.0) -> np.ndarray:
    """Canny edges -> (H, W, 3) float [0,1] control image (the reference's
    CannyDetector path, app.py:92 'Canny')."""
    g = _to_gray(img)
    if g.max() <= 1.0:
        g = g * 255.0
    g = _convolve_sep(g, _gaussian_kernel(sigma))

    # Sobel gradients (cv2.Canny threshold conventions: kernel gain 4)
    p = np.pad(g, 1, mode="edge")
    sx = p[:, 2:] - p[:, :-2]  # central diff in x, rows padded
    gx = sx[:-2, :] + 2 * sx[1:-1, :] + sx[2:, :]
    sy = p[2:, :] - p[:-2, :]
    gy = sy[:, :-2] + 2 * sy[:, 1:-1] + sy[:, 2:]
    mag = np.hypot(gx, gy)
    ang = np.rad2deg(np.arctan2(gy, gx)) % 180.0

    # non-maximum suppression (4 quantized directions)
    nms = np.zeros_like(mag)
    m = np.pad(mag, 1, mode="constant")
    h, w = mag.shape
    ys, xs = np.mgrid[0:h, 0:w]
    yc, xc = ys + 1, xs + 1
    d0 = (ang < 22.5) | (ang >= 157.5)
    d45 = (ang >= 22.5) & (ang < 67.5)
    d90 = (ang >= 67.5) & (ang < 112.5)
    d135 = (ang >= 112.5) & (ang < 157.5)
    keep = (
        (d0 & (mag >= m[yc, xc + 1]) & (mag >= m[yc, xc - 1]))
        | (d45 & (mag >= m[yc + 1, xc + 1]) & (mag >= m[yc - 1, xc - 1]))
        | (d90 & (mag >= m[yc + 1, xc]) & (mag >= m[yc - 1, xc]))
        | (d135 & (mag >= m[yc + 1, xc - 1]) & (mag >= m[yc - 1, xc + 1]))
    )
    nms = np.where(keep, mag, 0.0)

    strong = nms >= high
    weak = (nms >= low) & ~strong
    # hysteresis: weak pixels connected to strong survive (iterative dilate)
    out = strong.copy()
    for _ in range(16):
        grown = np.zeros_like(out)
        grown[1:, :] |= out[:-1, :]
        grown[:-1, :] |= out[1:, :]
        grown[:, 1:] |= out[:, :-1]
        grown[:, :-1] |= out[:, 1:]
        grown[1:, 1:] |= out[:-1, :-1]
        grown[:-1, :-1] |= out[1:, 1:]
        grown[1:, :-1] |= out[:-1, 1:]
        grown[:-1, 1:] |= out[1:, :-1]
        new = out | (weak & grown)
        if (new == out).all():
            break
        out = new
    edge = out.astype(np.float32)
    return np.stack([edge] * 3, -1)


def color_blocks(img: np.ndarray, block: int = 64) -> np.ndarray:
    """T2I color adapter preprocessing: downsample to coarse blocks then
    nearest-upsample (controlnet_aux ColorDetector equivalent,
    app.py 'Color')."""
    img = np.asarray(img, np.float32)
    if img.max() > 1.0:
        img = img / 255.0
    h, w = img.shape[:2]
    bh, bw = max(h // block, 1), max(w // block, 1)
    ys = (np.arange(bh) * h / bh).astype(int)
    xs = (np.arange(bw) * w / bw).astype(int)
    small = img[np.ix_(ys, xs)]
    ys2 = (np.arange(h) * bh / h).astype(int).clip(0, bh - 1)
    xs2 = (np.arange(w) * bw / w).astype(int).clip(0, bw - 1)
    return small[np.ix_(ys2, xs2)]


def content_shuffle(img: np.ndarray, f: int = 256,
                    seed: int = 0) -> np.ndarray:
    """ContentShuffleDetector equivalent: random smooth flow warp
    (app.py 'Shuffle')."""
    img = np.asarray(img, np.float32)
    if img.max() > 1.0:
        img = img / 255.0
    h, w = img.shape[:2]
    rng = np.random.RandomState(seed)
    flow = rng.rand(2, max(h // f, 2), max(w // f, 2)).astype(np.float32)
    # upsample flow bilinearly (cheap nearest here), scale to image size
    fy = resize_nearest(flow[0], h, w) * (h - 1)
    fx = resize_nearest(flow[1], h, w) * (w - 1)
    return img[fy.astype(int).clip(0, h - 1),
               fx.astype(int).clip(0, w - 1)]


def resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    sh, sw = img.shape[:2]
    ys = (np.arange(h) * sh / h).astype(int).clip(0, sh - 1)
    xs = (np.arange(w) * sw / w).astype(int).clip(0, sw - 1)
    return img[np.ix_(ys, xs)]


def invert(img: np.ndarray) -> np.ndarray:
    """Scribble/lineart inversion helper (white-on-black convention)."""
    img = np.asarray(img, np.float32)
    if img.max() > 1.0:
        img = img / 255.0
    return 1.0 - img


def grayscale3(img: np.ndarray) -> np.ndarray:
    g = _to_gray(img)
    if g.max() > 1.0:
        g = g / 255.0
    return np.stack([g] * 3, -1)


NATIVE_PREPROCESSORS: Dict[str, Callable] = {
    "Canny": canny,
    "Color": color_blocks,
    "Shuffle": content_shuffle,
    "Scribble": invert,
    "Grayscale": grayscale3,
    "None": lambda x: np.asarray(x, np.float32) / (
        255.0 if np.asarray(x).max() > 1.0 else 1.0
    ),
}

def _float01(img) -> np.ndarray:
    x = np.asarray(img, np.float32)
    return x / 255.0 if x.max() > 1.0 else x


def _device(params):
    from ..models._nets import param_device

    return param_device(params)


def make_depth_preprocessor(params, cfg) -> Callable:
    """DPT depth closure: RGB image -> normalized inverse-depth control
    image of the same size (the reference's MiDaS detector)."""
    from ..models.dpt import depth_to_control_image, dpt_apply

    def run(img: np.ndarray) -> np.ndarray:
        x = _float01(img)
        h, w = x.shape[:2]
        side = cfg.image_size
        small = resize(torch.from_numpy(x).to(_device(params)),
                       (side, side, 3), "linear")
        ctrl = depth_to_control_image(
            dpt_apply(params, cfg, ((small - 0.5) / 0.5)[None]))
        return resize(ctrl[0], (h, w, 3), "linear").cpu().numpy() \
            .clip(0.0, 1.0)

    return run


def make_openpose_preprocessor(params, detect_resolution: int = 368,
                               hand_params=None,
                               face_params=None) -> Callable:
    """Openpose closure; ``include_hand``/``include_face`` a call run the
    hand / face nets. ``hand_params``/``face_params`` are parameter dicts
    or zero-argument factories, resolved at the first call that needs
    them."""
    from ..models.openpose import detect_pose

    state = {"hand": hand_params, "face": face_params}

    def _resolve(k):
        if callable(state[k]):
            state[k] = state[k]()
        return state[k]

    def run(img: np.ndarray, include_body: bool = True,
            include_hand: bool = False,
            include_face: bool = False) -> np.ndarray:
        return detect_pose(params, img, detect_resolution=detect_resolution,
                           include_body=include_body,
                           include_hand=include_hand,
                           include_face=include_face,
                           hand_params=_resolve("hand") if include_hand
                           else None,
                           face_params=_resolve("face") if include_face
                           else None)

    return run


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def make_segmentation_preprocessor(params, cfg) -> Callable:
    """UperNet closure: RGB image -> random-colour region image."""
    from ..models.upernet import segmentation_to_control_image, upernet_apply

    def run(img: np.ndarray) -> np.ndarray:
        x = _float01(img)
        h, w = x.shape[:2]
        th = max(-(-h // 32) * 32, 32)
        tw = max(-(-w // 32) * 32, 32)
        dev = _device(params)
        small = resize(torch.from_numpy(x).to(dev), (th, tw, 3), "linear")
        norm = (small - torch.from_numpy(IMAGENET_MEAN).to(dev)) \
            / torch.from_numpy(IMAGENET_STD).to(dev)
        seg = torch.argmax(upernet_apply(params, cfg, norm[None]), dim=-1)
        ctrl = segmentation_to_control_image(seg[0].cpu().numpy())
        return resize(torch.from_numpy(ctrl), (h, w, 3), "nearest").numpy()

    return run


def make_normal_map_preprocessor(params, cfg) -> Callable:
    """Normals from depth gradients over the DPT network (the ControlNet-v1
    ``normal_from_midas`` annotator, the weightless "Normal Map"): Sobel
    gradients of the raw depth, background-thresholded on the min-max
    normalized copy, unit-normalized, BGR channel order."""
    from ..models.dpt import dpt_apply

    def run(img: np.ndarray, a: float = 2.0 * np.pi,
            bg_th: float = 0.1) -> np.ndarray:
        x = _float01(img)
        h, w = x.shape[:2]
        side = cfg.image_size
        small = resize(torch.from_numpy(x).to(_device(params)),
                       (side, side, 3), "linear")
        depth = dpt_apply(params, cfg, ((small - 0.5) / 0.5)[None])[0]
        depth = resize(depth, (h, w), "linear").cpu().numpy()
        return normal_from_depth(depth, a, bg_th)

    return run


def normal_from_depth(depth: np.ndarray, a: float = 2.0 * np.pi,
                      bg_th: float = 0.1) -> np.ndarray:
    """The "Normal Map" fallback's numpy tail on the (H, W) depth."""
    depth_norm = depth - depth.min()
    depth_norm = depth_norm / max(depth_norm.max(), 1e-8)
    gx = sobel(depth, 1, 0)
    gy = sobel(depth, 0, 1)
    gz = np.ones_like(gx) * a
    bg = depth_norm < bg_th
    gx[bg] = 0.0
    gy[bg] = 0.0
    normal = np.stack([gx, gy, gz], axis=2)
    normal /= np.sqrt((normal**2).sum(axis=2, keepdims=True))
    out = (normal * 0.5 + 0.5).clip(0.0, 1.0)
    return out[:, :, ::-1].copy()


def make_normalbae_preprocessor(params, cfg=None,
                                detect_res: int = 512) -> Callable:
    """NNET surface-normal closure (models/normalbae.py)."""
    from ..models.normalbae import NormalBaeConfig, detect_normalbae

    cfg = cfg or NormalBaeConfig()

    def run(img: np.ndarray) -> np.ndarray:
        return detect_normalbae(params, img, cfg, detect_res=detect_res)

    return run


def make_zoedepth_preprocessor(params, cfg=None) -> Callable:
    """ZoeDepth closure (models/zoedepth.py)."""
    from ..models.zoedepth import ZoeDepthConfig, detect_zoedepth

    cfg = cfg or ZoeDepthConfig()

    def run(img: np.ndarray) -> np.ndarray:
        return detect_zoedepth(params, img, cfg)

    return run


def make_mlsd_preprocessor(params, thr_v: float = 0.1,
                           thr_d: float = 0.1) -> Callable:
    """MLSD closure with the detector's default thresholds."""
    from ..models.mlsd import detect_mlsd

    def run(img: np.ndarray) -> np.ndarray:
        return detect_mlsd(params, img, thr_v=thr_v, thr_d=thr_d)

    return run


def make_pidinet_preprocessor(params, scribble: bool = False,
                              safe: bool = False) -> Callable:
    """PidiNet closure, the default Soft Edge / Scribble detector."""
    from ..models.pidinet import detect_soft_edge

    def run(img: np.ndarray) -> np.ndarray:
        return detect_soft_edge(params, img, scribble=scribble, safe=safe)

    return run


def make_hed_preprocessor(params, scribble: bool = False) -> Callable:
    """HED closure (``scribble``: the binary sketch)."""
    from ..models.hed import detect_edges

    def run(img: np.ndarray) -> np.ndarray:
        return detect_edges(params, img, scribble=scribble)

    return run


#: The detectors that need a network, each built by
#: ``ModelManager.get_preprocessor``: "Depth" (models/dpt.py), "Openpose"
#: (models/openpose.py), "Semantic Segmentation" (models/upernet.py),
#: "Soft Edge" / "Scribble (PidiNet)" (models/pidinet.py), "Soft Edge
#: (HED)" / "Scribble (HED)" (models/hed.py), "Lineart" / "Lineart
#: (anime)" (models/lineart*.py), "MLSD" (models/mlsd.py), "Zoedepth"
#: (models/zoedepth.py), "Normal Map" (NNET, models/normalbae.py, given
#: its weights or config; depth-gradient normals over DPT without) and
#: "Instruct Pix2Pix" (no detector: the raw image).
MODEL_BASED_PREPROCESSORS = (
    "Depth", "Openpose", "Soft Edge", "Soft Edge (HED)",
    "Scribble (PidiNet)", "Scribble (HED)", "Lineart",
    "Lineart (anime)", "MLSD", "Semantic Segmentation", "Normal Map",
    "Zoedepth", "Instruct Pix2Pix",
)
NATIVE_MODEL_PREPROCESSORS = (
    "Depth", "Openpose", "Semantic Segmentation", "Soft Edge",
    "Soft Edge (HED)", "Scribble (PidiNet)", "Scribble (HED)", "Lineart",
    "Lineart (anime)", "Instruct Pix2Pix", "MLSD", "Zoedepth",
    "Normal Map",
)
