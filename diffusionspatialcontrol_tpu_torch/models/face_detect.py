"""SCRFD-class face detector and 5-point alignment, insightface-compatible
(port of ``models/face_detect.py``).

The FaceID flow runs insightface ``FaceAnalysis`` on the raw photo: SCRFD
detection, 5-point landmarks, similarity alignment to the 112x112 ArcFace
template, then ``models/arcface.py``. Here:

  * the network (``scrfd_apply``): a deep-stem residual backbone, an FPN
    neck and shared anchor-free heads at strides 8/16/32 with two anchors a
    position (sigmoid score, distance box, 5-point offsets), in PyTorch on
    the parameters' device, NHWC activations and OIHW convs;
  * the decode (``distance2bbox``, ``distance2kps``, score threshold,
    greedy IoU ``nms``) and the alignment (``umeyama_similarity``,
    ``estimate_norm``, ``warp_affine``, ``norm_crop``): numpy on the host,
    the JAX package's code as it is, so they give the same values bit for
    bit (the scores' sigmoid is numpy's here, XLA's there).

Random weights may clear no threshold; ``top1_fallback`` then returns the
highest-scoring anchor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize
from .layers import as_channels_last

# The published ArcFace 5-point destination template for a 112x112 crop
# (insightface face_align.arcface_dst): left eye, right eye, nose tip,
# left mouth corner, right mouth corner, in image coordinates.
ARCFACE_DST = np.array(
    [
        [38.2946, 51.6963],
        [73.5318, 51.5014],
        [56.0252, 71.7366],
        [41.5493, 92.3655],
        [70.7299, 92.2041],
    ],
    dtype=np.float32,
)


@dataclasses.dataclass(frozen=True)
class FaceDetectConfig:
    stem_channels: int = 32
    stage_blocks: Tuple[int, int, int, int] = (2, 2, 2, 2)
    stage_widths: Tuple[int, int, int, int] = (32, 64, 128, 256)
    neck_channels: int = 64
    head_convs: int = 2
    head_channels: int = 64
    num_anchors: int = 2
    strides: Tuple[int, ...] = (8, 16, 32)
    input_size: int = 640
    score_thresh: float = 0.5
    nms_thresh: float = 0.4


#: tiny preset for random-init tests (same structure, fast on CPU)
FACEDETECT_TINY = FaceDetectConfig(
    stem_channels=4, stage_blocks=(1, 1, 1, 1), stage_widths=(4, 6, 8, 12),
    neck_channels=8, head_convs=1, head_channels=8, input_size=64,
)


# --- layers -----------------------------------------------------------------


def _conv(p, x, stride=1):
    """NHWC conv, symmetric padding (k - 1) / 2, an OIHW kernel, an
    optional bias added to the fp32 sums."""
    k = p["kernel"]
    y = F.conv2d(x.permute(0, 3, 1, 2), k.to(x.dtype),
                 p["bias"].to(x.dtype) if "bias" in p else None,
                 stride=stride, padding=(k.shape[-1] - 1) // 2)
    return y.permute(0, 2, 3, 1)


def _bn(p, x):
    """Inference BatchNorm folded to a per-channel affine, in fp32."""
    y = x.float() * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def _conv_init(g, cin, cout, ksize, dtype, device, bias=False):
    t = torch.empty((cout, cin, ksize, ksize), dtype=torch.float32,
                    device=device).normal_(generator=g)
    p = {"kernel": as_channels_last(
        (t * np.sqrt(2.0 / (ksize * ksize * cin))).to(dtype))}
    if bias:
        p["bias"] = torch.zeros(cout, dtype=dtype, device=device)
    return p


def _bn_init(c, dtype, device):
    return {"scale": torch.ones(c, dtype=dtype, device=device),
            "bias": torch.zeros(c, dtype=dtype, device=device)}


def _block_apply(p, x, stride):
    """Residual basic block: conv-bn-relu, conv-bn, (+1x1 shortcut),
    relu."""
    h = F.relu(_bn(p["bn1"], _conv(p["conv1"], x, stride)))
    h = _bn(p["bn2"], _conv(p["conv2"], h))
    if "down" in p:
        x = _bn(p["down_bn"], _conv(p["down"], x, stride))
    return F.relu(h + x)


def _block_init(g, cin, cout, stride, dtype, device):
    p = {
        "conv1": _conv_init(g, cin, cout, 3, dtype, device),
        "bn1": _bn_init(cout, dtype, device),
        "conv2": _conv_init(g, cout, cout, 3, dtype, device),
        "bn2": _bn_init(cout, dtype, device),
    }
    if stride != 1 or cin != cout:
        p["down"] = _conv_init(g, cin, cout, 1, dtype, device)
        p["down_bn"] = _bn_init(cout, dtype, device)
    return p


# --- network ----------------------------------------------------------------


def scrfd_init(g: torch.Generator, cfg: FaceDetectConfig = FaceDetectConfig(),
               dtype=torch.float32, device=None) -> Dict[str, Any]:
    """Random weights from ``g`` in the JAX package's tree and
    distributions (other values than its ``PRNGKey`` init)."""
    sc = cfg.stem_channels
    p: Dict[str, Any] = {"stem": [
        {"conv": _conv_init(g, cin, sc, 3, dtype, device),
         "bn": _bn_init(sc, dtype, device)} for cin in (3, sc, sc)]}
    cin = sc
    stages = []
    for si, (n, w) in enumerate(zip(cfg.stage_blocks, cfg.stage_widths)):
        blocks = []
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            blocks.append(_block_init(g, cin, w, stride, dtype, device))
            cin = w
        stages.append(blocks)
    p["stages"] = stages
    nc = cfg.neck_channels
    p["lateral"] = [_conv_init(g, w, nc, 1, dtype, device, bias=True)
                    for w in cfg.stage_widths[1:]]
    p["fpn"] = [_conv_init(g, nc, nc, 3, dtype, device, bias=True)
                for _ in cfg.strides]
    tower = []
    hin = nc
    for _ in range(cfg.head_convs):
        tower.append({"conv": _conv_init(g, hin, cfg.head_channels, 3,
                                         dtype, device, bias=True)})
        hin = cfg.head_channels
    p["tower"] = tower
    a = cfg.num_anchors
    p["cls"] = _conv_init(g, hin, a * 1, 3, dtype, device, bias=True)
    p["bbox"] = _conv_init(g, hin, a * 4, 3, dtype, device, bias=True)
    p["kps"] = _conv_init(g, hin, a * 10, 3, dtype, device, bias=True)
    return p


def _up2(x, like):
    """Nearest 2x upsampling by repetition, cropped to ``like``'s size."""
    x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return x[:, : like.shape[1], : like.shape[2]]


def scrfd_apply(params, x: torch.Tensor,
                cfg: FaceDetectConfig = FaceDetectConfig()
                ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """x: (B, H, W, 3) normalized (x - 127.5) / 128. Returns per stride
    (scores (B, h, w, A), bbox (B, h, w, A*4), kps (B, h, w, A*10)), raw:
    pre-sigmoid scores, distances in stride units."""
    h = x
    for i, s in enumerate(params["stem"]):
        h = F.relu(_bn(s["bn"], _conv(s["conv"], h, 2 if i == 0 else 1)))
    # 3x3 stride-2 max pool padded with -inf: stages at strides 4/8/16/32
    h = F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, padding=1).permute(
        0, 2, 3, 1)
    feats = []
    for si, blocks in enumerate(params["stages"]):
        for bi, b in enumerate(blocks):
            h = _block_apply(b, h, 2 if (bi == 0 and si > 0) else 1)
        feats.append(h)
    c3, c4, c5 = feats[1], feats[2], feats[3]
    l3 = _conv(params["lateral"][0], c3)
    l4 = _conv(params["lateral"][1], c4)
    l5 = _conv(params["lateral"][2], c5)
    l4 = l4 + _up2(l5, l4)  # the top-down pathway
    l3 = l3 + _up2(l4, l3)
    outs = []
    for i, f in enumerate((l3, l4, l5)):
        t = _conv(params["fpn"][i], f)
        for tw in params["tower"]:
            t = F.relu(_conv(tw["conv"], t))
        outs.append((_conv(params["cls"], t), _conv(params["bbox"], t),
                     _conv(params["kps"], t)))
    return outs


# --- decode (insightface scrfd.py parity; numpy) ----------------------------


def distance2bbox(points: np.ndarray, distance: np.ndarray) -> np.ndarray:
    """(N, 2) centers + (N, 4) l/t/r/b distances -> (N, 4) x1y1x2y2."""
    x1 = points[:, 0] - distance[:, 0]
    y1 = points[:, 1] - distance[:, 1]
    x2 = points[:, 0] + distance[:, 2]
    y2 = points[:, 1] + distance[:, 3]
    return np.stack([x1, y1, x2, y2], axis=-1)


def distance2kps(points: np.ndarray, distance: np.ndarray) -> np.ndarray:
    """(N, 2) centers + (N, 10) dx/dy offsets -> (N, 5, 2) keypoints."""
    preds = []
    for i in range(0, distance.shape[1], 2):
        preds.append(points[:, 0] + distance[:, i])
        preds.append(points[:, 1] + distance[:, i + 1])
    return np.stack(preds, axis=-1).reshape(-1, 5, 2)


def nms(dets: np.ndarray, thresh: float) -> List[int]:
    """Greedy IoU NMS over (N, 5) x1y1x2y2score, descending score."""
    x1, y1, x2, y2, scores = dets.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        ovr = w * h / (areas[i] + areas[order[1:]] - w * h)
        order = order[1:][ovr <= thresh]
    return keep


def _sigmoid(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):  # exp(-x) = inf gives 0, as it should
        return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


def decode_scrfd(outs, cfg: FaceDetectConfig, det_scale: float = 1.0,
                 score_thresh: Optional[float] = None,
                 top1_fallback: bool = False):
    """Raw per-stride outputs (tensors or arrays) of the first image ->
    (bboxes (N, 5) with the score, kps (N, 5, 2)), NMS-filtered, by
    descending score, in the original image's coordinates (divided by
    ``det_scale``). ``top1_fallback``: when nothing clears the threshold,
    the single highest-scoring anchor."""
    thresh = cfg.score_thresh if score_thresh is None else score_thresh
    scores_l, bboxes_l, kps_l = [], [], []
    best = None  # (score, bbox, kps) for the fallback
    for (cls, bbox, kps), stride in zip(outs, cfg.strides):
        cls, bbox, kps = (np.asarray(t.cpu() if isinstance(t, torch.Tensor)
                                     else t, np.float32)
                          for t in (cls, bbox, kps))
        s = _sigmoid(cls[0].reshape(-1))
        h, w = cls.shape[1], cls.shape[2]
        # anchor centers: (x, y) grid * stride, each repeated per anchor
        xv, yv = np.meshgrid(np.arange(w), np.arange(h))
        centers = np.stack([xv, yv], axis=-1).reshape(-1, 2) * stride
        centers = np.repeat(centers, cfg.num_anchors, axis=0).astype(
            np.float32)
        bb = distance2bbox(centers, bbox[0].reshape(-1, 4) * stride)
        kk = distance2kps(centers, kps[0].reshape(-1, 10) * stride)
        j = int(np.argmax(s))
        if best is None or s[j] > best[0]:
            best = (float(s[j]), bb[j], kk[j])
        keep = np.where(s >= thresh)[0]
        scores_l.append(s[keep])
        bboxes_l.append(bb[keep])
        kps_l.append(kk[keep])
    scores = np.concatenate(scores_l)
    if scores.size == 0:
        if not (top1_fallback and best is not None):
            return np.zeros((0, 5), np.float32), np.zeros((0, 5, 2),
                                                          np.float32)
        scores = np.array([best[0]], np.float32)
        bboxes = best[1][None]
        kpss = best[2][None]
    else:
        bboxes = np.concatenate(bboxes_l)
        kpss = np.concatenate(kps_l)
    bboxes = bboxes / det_scale
    kpss = kpss / det_scale
    dets = np.concatenate([bboxes, scores[:, None]], axis=1).astype(
        np.float32)
    order = scores.argsort()[::-1]
    dets, kpss = dets[order], kpss[order]
    keep = nms(dets, cfg.nms_thresh)
    return dets[keep], kpss[keep].astype(np.float32)


# --- alignment (insightface face_align parity; numpy) -----------------------


def umeyama_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity transform (rotation, scale, translation)
    mapping src -> dst (Umeyama 1991, skimage's
    ``SimilarityTransform.estimate``). Returns a (2, 3) affine matrix."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n, d = src.shape
    src_mean = src.mean(axis=0)
    dst_mean = dst.mean(axis=0)
    src_c = src - src_mean
    dst_c = dst - dst_mean
    cov = dst_c.T @ src_c / n
    u, s, vt = np.linalg.svd(cov)
    sgn = np.ones(d)
    if np.linalg.det(cov) < 0:
        sgn[-1] = -1
    r = u @ np.diag(sgn) @ vt
    if np.linalg.matrix_rank(cov) == d - 1:
        if np.linalg.det(u) * np.linalg.det(vt) > 0:
            r = u @ vt
        else:
            sgn2 = sgn.copy()
            sgn2[-1] = -1
            r = u @ np.diag(sgn2) @ vt
    var_src = (src_c ** 2).sum() / n
    scale = (s * sgn).sum() / var_src
    t = dst_mean - scale * r @ src_mean
    m = np.zeros((2, 3))
    m[:, :2] = scale * r
    m[:, 2] = t
    return m


def estimate_norm(lmk: np.ndarray, image_size: int = 112) -> np.ndarray:
    """5-point landmarks -> (2, 3) similarity to the ArcFace template
    (sizes that are multiples of 112 scale the template, 128-family sizes
    shift and scale it, as insightface's ``estimate_norm``)."""
    assert lmk.shape == (5, 2)
    if image_size % 112 == 0:
        ratio = float(image_size) / 112.0
        diff_x = 0.0
    else:
        assert image_size % 128 == 0
        ratio = float(image_size) / 128.0
        diff_x = 8.0 * ratio
    dst = ARCFACE_DST * ratio
    dst[:, 0] += diff_x
    return umeyama_similarity(lmk, dst).astype(np.float32)


def warp_affine(img: np.ndarray, m: np.ndarray, out_size: int) -> np.ndarray:
    """Bilinear affine warp with cv2.warpAffine's semantics (``m`` maps
    input coordinates to output ones; sampling inverts it; the border is
    constant 0). img: (H, W, C); returns float32 (out_size, out_size, C)."""
    inp = np.asarray(img).astype(np.float32)
    a = np.concatenate([np.asarray(m, np.float64),
                        [[0.0, 0.0, 1.0]]], axis=0)
    inv = np.linalg.inv(a)[:2]
    xv, yv = np.meshgrid(np.arange(out_size), np.arange(out_size))
    pts = np.stack([xv, yv, np.ones_like(xv)], axis=-1).reshape(-1, 3)
    src = pts @ inv.T  # (N, 2) x, y source coordinates
    x, y = src[:, 0], src[:, 1]
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx, fy = x - x0, y - y0
    h, w = inp.shape[:2]

    def gather(yy, xx):
        return inp[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]

    inside = (x >= -1) & (x <= w) & (y >= -1) & (y <= h)
    out = (
        gather(y0, x0) * ((1 - fx) * (1 - fy))[:, None]
        + gather(y0, x0 + 1) * (fx * (1 - fy))[:, None]
        + gather(y0 + 1, x0) * ((1 - fx) * fy)[:, None]
        + gather(y0 + 1, x0 + 1) * (fx * fy)[:, None]
    )
    out = out * inside[:, None]
    return out.reshape(out_size, out_size, -1).astype(np.float32)


def norm_crop(img: np.ndarray, lmk: np.ndarray,
              image_size: int = 112) -> np.ndarray:
    """Detected 5-point landmarks -> the aligned ArcFace crop."""
    m = estimate_norm(np.asarray(lmk, np.float32), image_size)
    return warp_affine(img, m, image_size)


# --- entry points -----------------------------------------------------------


@torch.inference_mode()
def detect_faces(params, img: np.ndarray,
                 cfg: FaceDetectConfig = FaceDetectConfig(),
                 score_thresh: Optional[float] = None,
                 top1_fallback: bool = False):
    """Raw (H, W, 3) uint8/float image -> (dets (N, 5), kps (N, 5, 2)) in
    image coordinates, as insightface's ``SCRFD.detect``: an
    aspect-preserving resize onto a square ``cfg.input_size`` canvas
    (``jax.image.resize`` bilinear, antialiased), (x - 127.5) / 128, the
    network on its parameters' device, the decode at 1 / det_scale."""
    device = params["cls"]["kernel"].device
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32)
    ih, iw = img.shape[:2]
    size = cfg.input_size
    det_scale = min(size / ih, size / iw)
    nh, nw = int(round(ih * det_scale)), int(round(iw * det_scale))
    x = torch.from_numpy(np.asarray(img, np.float32)).to(device)
    canvas = torch.zeros((size, size, 3), dtype=torch.float32, device=device)
    canvas[:nh, :nw] = resize(x, (nh, nw, 3), "linear")
    canvas = (canvas - 127.5) / 128.0
    outs = scrfd_apply(params, canvas[None].to(params["cls"]["kernel"].dtype),
                       cfg)
    return decode_scrfd(outs, cfg, det_scale=det_scale,
                        score_thresh=score_thresh,
                        top1_fallback=top1_fallback)


def make_face_aligner(params, cfg: FaceDetectConfig = FaceDetectConfig(),
                      top1_fallback: bool = False):
    """Callable raw photo -> aligned 112x112 crop of the top face, or None
    when no face clears the threshold (the caller decides what that
    means)."""

    def align(img: np.ndarray) -> Optional[np.ndarray]:
        dets, kpss = detect_faces(params, img, cfg,
                                  top1_fallback=top1_fallback)
        if len(dets) == 0:
            return None
        return norm_crop(np.asarray(img, np.float32), kpss[0])

    return align


# --- converter --------------------------------------------------------------


def convert_scrfd(state: Dict[str, np.ndarray],
                  cfg: FaceDetectConfig = FaceDetectConfig(),
                  dtype=torch.float32, device=None) -> Dict[str, Any]:
    """A torch SCRFD state dict in memory (name -> array; mmdet naming:
    ``backbone.stem.{0,1,2}.{conv,bn}``, ``backbone.layer{1..4}.{i}.*``,
    ``neck.lateral_convs/fpn_convs.{i}.conv``, ``bbox_head.cls_convs.{i}
    .conv`` and ``bbox_head.{cls,reg,kps}_pred``) -> this module's tree;
    BatchNorm running stats are folded into per-channel affines
    (``convert.hf.load_state_dict(path).arrays()`` reads the file)."""

    def t(a):
        return torch.tensor(np.asarray(a, np.float32)).to(dtype=dtype,
                                                          device=device)

    def conv(prefix, bias=False):
        p = {"kernel": as_channels_last(t(state[f"{prefix}.weight"]))}
        if bias and f"{prefix}.bias" in state:
            p["bias"] = t(state[f"{prefix}.bias"])
        return p

    def bn(prefix, eps=1e-5):
        g = np.asarray(state[f"{prefix}.weight"], np.float32)
        b = np.asarray(state[f"{prefix}.bias"], np.float32)
        mu = np.asarray(state[f"{prefix}.running_mean"], np.float32)
        var = np.asarray(state[f"{prefix}.running_var"], np.float32)
        scale = g / np.sqrt(var + eps)
        return {"scale": t(scale), "bias": t(b - mu * scale)}

    p: Dict[str, Any] = {"stem": [
        {"conv": conv(f"backbone.stem.{i}.conv"),
         "bn": bn(f"backbone.stem.{i}.bn")} for i in range(3)]}
    stages = []
    for si in range(4):
        blocks = []
        bi = 0
        while f"backbone.layer{si + 1}.{bi}.conv1.weight" in state:
            pre = f"backbone.layer{si + 1}.{bi}"
            blk = {"conv1": conv(f"{pre}.conv1"), "bn1": bn(f"{pre}.bn1"),
                   "conv2": conv(f"{pre}.conv2"), "bn2": bn(f"{pre}.bn2")}
            if f"{pre}.downsample.0.weight" in state:
                blk["down"] = conv(f"{pre}.downsample.0")
                blk["down_bn"] = bn(f"{pre}.downsample.1")
            blocks.append(blk)
            bi += 1
        stages.append(blocks)
    p["stages"] = stages
    p["lateral"] = [conv(f"neck.lateral_convs.{i}.conv", bias=True)
                    for i in range(3)]
    p["fpn"] = [conv(f"neck.fpn_convs.{i}.conv", bias=True)
                for i in range(3)]
    tower = []
    i = 0
    while f"bbox_head.cls_convs.{i}.conv.weight" in state:
        tower.append({"conv": conv(f"bbox_head.cls_convs.{i}.conv",
                                   bias=True)})
        i += 1
    p["tower"] = tower
    p["cls"] = conv("bbox_head.cls_pred", bias=True)
    p["bbox"] = conv("bbox_head.reg_pred", bias=True)
    p["kps"] = conv("bbox_head.kps_pred", bias=True)
    return p
