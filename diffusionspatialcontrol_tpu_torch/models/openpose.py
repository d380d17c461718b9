"""Openpose detector: the CMU body network with PAF grouping, and the hand
and face keypoint networks (port of ``models/openpose.py``).

The reference's "Openpose" detector (controlnet_aux's OpenposeDetector,
the pytorch-openpose body model; the hand and face nets behind its
include_hand / include_face options). The three VGG-style CPM networks run
in PyTorch on the parameters' device; the peaks, the part-affinity
pairing, the person assembly, the hand and face boxes and the drawing are
numpy on the host, the JAX package's code (``scipy.ndimage`` labels the
hand peaks' components). The weights keep the pytorch-openpose layouts
(``body_pose_model.pth``: ``model0.conv1_1.*`` ...; ``hand_pose_model.pth``:
``model1_0.conv1_1.*`` ...; ``facenet.pth``: flat ``conv1_1.*`` ...).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize
from . import _nets as N

N_PAF, N_HEAT = 38, 19  # 19 limbs x 2, 18 parts + background
N_HAND = 22  # 21 hand keypoints + background
N_FACE = 71  # 70 face keypoints + background

# the crop protocol of the hand and face nets (module-level so that tests
# can shrink them)
HAND_BOXSIZE = 368
HAND_SCALES = (0.5, 1.0, 1.5, 2.0)
FACE_BOXSIZE = 368
FACE_SCALES = (1.0,)


@dataclasses.dataclass(frozen=True)
class OpenposeConfig:
    """The published widths divided by ``div`` (1: the published nets;
    larger divisors draw smaller random state dicts for tests). The
    inputs, the outputs (38 PAF, 19 heat, 22 hand, 71 face channels) and
    the kernel sizes stay."""

    div: int = 1


# (name, in_c, out_c, kernel) per layer, ("pool",) for a 2x2 max pool; a
# ReLU after every conv but each branch's last. Widths at div 1.
_MODEL0 = [
    ("conv1_1", 3, 64, 3), ("conv1_2", 64, 64, 3), ("pool1",),
    ("conv2_1", 64, 128, 3), ("conv2_2", 128, 128, 3), ("pool2",),
    ("conv3_1", 128, 256, 3), ("conv3_2", 256, 256, 3),
    ("conv3_3", 256, 256, 3), ("conv3_4", 256, 256, 3), ("pool3",),
    ("conv4_1", 256, 512, 3), ("conv4_2", 512, 512, 3),
    ("conv4_3_CPM", 512, 256, 3), ("conv4_4_CPM", 256, 128, 3),
]
_CPM_BACKBONE = [
    ("conv1_1", 3, 64, 3), ("conv1_2", 64, 64, 3), ("pool",),
    ("conv2_1", 64, 128, 3), ("conv2_2", 128, 128, 3), ("pool",),
    ("conv3_1", 128, 256, 3), ("conv3_2", 256, 256, 3),
    ("conv3_3", 256, 256, 3), ("conv3_4", 256, 256, 3), ("pool",),
    ("conv4_1", 256, 512, 3), ("conv4_2", 512, 512, 3),
    ("conv4_3", 512, 512, 3), ("conv4_4", 512, 512, 3),
    ("conv5_1", 512, 512, 3), ("conv5_2", 512, 512, 3),
    ("conv5_3_CPM", 512, 128, 3),
]


def _stage1(branch: int):
    out, L = (N_PAF if branch == 1 else N_HEAT), f"L{branch}"
    return [(f"conv5_1_CPM_{L}", 128, 128, 3),
            (f"conv5_2_CPM_{L}", 128, 128, 3),
            (f"conv5_3_CPM_{L}", 128, 128, 3),
            (f"conv5_4_CPM_{L}", 128, 512, 1),
            (f"conv5_5_CPM_{L}", 512, out, 1)]


def _stage_t(t: int, branch: int):
    out, L = (N_PAF if branch == 1 else N_HEAT), f"L{branch}"
    lay = [(f"Mconv{i}_stage{t}_{L}", -1 if i == 1 else 128, 128, 7)
           for i in range(1, 6)]
    return lay + [(f"Mconv6_stage{t}_{L}", 128, 128, 1),
                  (f"Mconv7_stage{t}_{L}", 128, out, 1)]


def _body_specs():
    specs = {"model0": _MODEL0}
    for br in (1, 2):
        specs[f"model1_{br}"] = _stage1(br)
        for t in range(2, 7):
            specs[f"model{t}_{br}"] = _stage_t(t, br)
    return specs


def _cpm_stage1(n_out: int):
    return [("conv6_1_CPM", 128, 512, 1), ("conv6_2_CPM", 512, n_out, 1)]


def _cpm_stage_t(t: int, n_out: int):
    lay = [(f"Mconv{i}_stage{t}", -1 if i == 1 else 128, 128, 7)
           for i in range(1, 6)]
    return lay + [(f"Mconv6_stage{t}", 128, 128, 1),
                  (f"Mconv7_stage{t}", 128, n_out, 1)]


def _hand_specs():
    specs = {"model1_0": _CPM_BACKBONE, "model1_1": _cpm_stage1(N_HAND)}
    for t in range(2, 7):
        specs[f"model{t}"] = _cpm_stage_t(t, N_HAND)
    return specs


def _face_specs():
    """facenet.pth is one flat module: the block key is empty."""
    lay = list(_CPM_BACKBONE) + _cpm_stage1(N_FACE)
    for t in range(2, 7):
        lay += _cpm_stage_t(t, N_FACE)
    return {"": lay}


_OUTS = {N_PAF, N_HEAT, N_HAND, N_FACE}


def _draw(specs, div: int, seed: int, stage_in: int):
    """A state dict of ``specs`` with its widths divided by ``div`` (the
    first refinement conv takes ``stage_in`` extra channels)."""
    d = N.Draw(seed)
    for block, spec in specs.items():
        for layer in spec:
            if len(layer) == 1:
                continue
            name, i, o, k = layer
            i = 128 // div + stage_in if i == -1 else (
                i if i == 3 else i // div)
            o = o if o in _OUTS else o // div
            d.conv(f"{block}.{name}" if block else name, o, i, k)
    return d.sd


def random_state_dict(cfg: OpenposeConfig = OpenposeConfig(), seed: int = 0
                      ) -> Dict[str, np.ndarray]:
    """The body net's state dict (``body_pose_model.pth`` layout)."""
    return _draw(_body_specs(), cfg.div, seed, N_PAF + N_HEAT)


def random_hand_state_dict(cfg: OpenposeConfig = OpenposeConfig(),
                           seed: int = 0) -> Dict[str, np.ndarray]:
    return _draw(_hand_specs(), cfg.div, seed, N_HAND)


def random_face_state_dict(cfg: OpenposeConfig = OpenposeConfig(),
                           seed: int = 0) -> Dict[str, np.ndarray]:
    return _draw(_face_specs(), cfg.div, seed, N_FACE)


def convert_openpose_body(sd, device=None) -> Dict[str, torch.Tensor]:
    return N.tensors(sd, device)


def convert_openpose_hand(sd, device=None) -> Dict[str, torch.Tensor]:
    return N.tensors(sd, device)


def convert_openpose_face(sd, device=None) -> Dict[str, torch.Tensor]:
    return N.tensors(sd, device)


def _run_block(p, block: str, spec, x, final_relu_skip: bool):
    n_convs = sum(1 for s in spec if len(s) > 1)
    seen = 0
    for layer in spec:
        if len(layer) == 1:
            x = N.maxpool2(x)
            continue
        name = f"{block}.{layer[0]}" if block else layer[0]
        x = N.conv_named(p, name, x)
        seen += 1
        if not (final_relu_skip and seen == n_convs):
            x = F.relu(x)
    return x


def openpose_body_apply(params, pixels: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pixels: (B, H, W, 3) BGR in [-0.5, 0.5]. Returns the last stage's
    (paf (B, H/8, W/8, 38), heatmap (B, H/8, W/8, 19))."""
    specs = _body_specs()
    feat = _run_block(params, "model0", specs["model0"],
                      N.nchw(pixels.float()), False)
    paf = _run_block(params, "model1_1", specs["model1_1"], feat, True)
    heat = _run_block(params, "model1_2", specs["model1_2"], feat, True)
    for t in range(2, 7):
        x = torch.cat([paf, heat, feat], dim=1)
        paf = _run_block(params, f"model{t}_1", specs[f"model{t}_1"], x,
                         True)
        heat = _run_block(params, f"model{t}_2", specs[f"model{t}_2"], x,
                          True)
    return N.nhwc(paf), N.nhwc(heat)


def _cpm_apply(params, blocks, pixels):
    """A hand or face net: the backbone, stage 1 and five refinement
    stages, each fed the heatmaps ahead of the backbone's features."""
    (b0, s0), (b1, s1), *rest = blocks
    feat = _run_block(params, b0, s0, N.nchw(pixels.float()), False)
    heat = _run_block(params, b1, s1, feat, True)
    for block, spec in rest:
        heat = _run_block(params, block, spec,
                          torch.cat([heat, feat], dim=1), True)
    return N.nhwc(heat)


def openpose_hand_apply(params, pixels: torch.Tensor) -> torch.Tensor:
    """pixels: (B, H, W, 3) BGR in [-0.5, 0.5] -> (B, H/8, W/8, 22)."""
    return _cpm_apply(params, list(_hand_specs().items()), pixels)


def openpose_face_apply(params, pixels: torch.Tensor) -> torch.Tensor:
    """pixels: (B, H, W, 3) BGR in [-0.5, 0.5] -> (B, H/8, W/8, 71)."""
    spec = _face_specs()[""]
    n = len(_CPM_BACKBONE)
    blocks = [("", spec[:n]), ("", spec[n:n + 2])]
    blocks += [("", spec[n + 2 + 7 * i:n + 9 + 7 * i]) for i in range(5)]
    return _cpm_apply(params, blocks, pixels)


def _bgr(x: torch.Tensor) -> torch.Tensor:
    """RGB in [0, 1] -> the nets' BGR input, x 255/256 - 0.5."""
    return x.flip(-1) * (255.0 / 256.0) - 0.5


# limb k connects parts (limbSeq[k][0]-1, limbSeq[k][1]-1); PAF channels
# (mapIdx[k] - 19) — the classic CMU tables.
LIMB_SEQ = [
    [2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
    [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
    [1, 16], [16, 18], [3, 17], [6, 18],
]
MAP_IDX = [
    [31, 32], [39, 40], [33, 34], [35, 36], [41, 42], [43, 44], [19, 20],
    [21, 22], [23, 24], [25, 26], [27, 28], [29, 30], [47, 48], [49, 50],
    [53, 54], [51, 52], [55, 56], [37, 38], [45, 46],
]
_COLORS = [
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
    (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
    (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
    (255, 0, 255), (255, 0, 170), (255, 0, 85),
]


def _gaussian_blur(m: np.ndarray, sigma: float = 3.0) -> np.ndarray:
    r = int(3 * sigma)
    xs = np.arange(-r, r + 1)
    k = np.exp(-(xs**2) / (2 * sigma * sigma))
    k /= k.sum()
    pad = np.pad(m, ((r, r), (0, 0)), mode="edge")
    m = np.einsum("k,kij->ij", k,
                  np.stack([pad[i:i + m.shape[0]]
                            for i in range(2 * r + 1)]))
    pad = np.pad(m, ((0, 0), (r, r)), mode="edge")
    m = np.einsum("k,kij->ij", k,
                  np.stack([pad[:, i:i + m.shape[1]]
                            for i in range(2 * r + 1)]))
    return m


def find_peaks(heatmap: np.ndarray, thre1: float = 0.1) -> List[List[Tuple]]:
    """heatmap: (H, W, 19). Returns per-part peak lists of
    (x, y, score, global_id) — controlnet_aux body.py peak pass."""
    all_peaks = []
    peak_counter = 0
    for part in range(18):
        map_ori = heatmap[:, :, part]
        m = _gaussian_blur(map_ori, 3.0)
        up = np.zeros_like(m); up[1:] = m[:-1]
        down = np.zeros_like(m); down[:-1] = m[1:]
        left = np.zeros_like(m); left[:, 1:] = m[:, :-1]
        right = np.zeros_like(m); right[:, :-1] = m[:, 1:]
        binary = (m >= up) & (m >= down) & (m >= left) & (m >= right) & (
            m > thre1
        )
        ys, xs = np.nonzero(binary)
        peaks = [
            (int(x), int(y), float(map_ori[y, x]), peak_counter + i)
            for i, (x, y) in enumerate(zip(xs, ys))
        ]
        peak_counter += len(peaks)
        all_peaks.append(peaks)
    return all_peaks


def pair_limbs(paf: np.ndarray, all_peaks, orig_h: int,
               thre2: float = 0.05):
    """PAF line-integral scoring + greedy assignment per limb
    (controlnet_aux body.py connection pass)."""
    connection_all = []
    special_k = []
    mid_num = 10
    for k in range(len(MAP_IDX)):
        score_mid = paf[:, :, [i - 19 for i in MAP_IDX[k]]]
        cand_a = all_peaks[LIMB_SEQ[k][0] - 1]
        cand_b = all_peaks[LIMB_SEQ[k][1] - 1]
        if not cand_a or not cand_b:
            special_k.append(k)
            connection_all.append([])
            continue
        candidates = []
        for i, a in enumerate(cand_a):
            for j, b in enumerate(cand_b):
                vec = np.array([b[0] - a[0], b[1] - a[1]], np.float64)
                norm = max(np.sqrt((vec**2).sum()), 1e-8)
                vecn = vec / norm
                xs = np.linspace(a[0], b[0], mid_num)
                ys = np.linspace(a[1], b[1], mid_num)
                vx = score_mid[np.round(ys).astype(int),
                               np.round(xs).astype(int), 0]
                vy = score_mid[np.round(ys).astype(int),
                               np.round(xs).astype(int), 1]
                scores = vx * vecn[0] + vy * vecn[1]
                prior = scores.mean() + min(0.5 * orig_h / norm - 1.0, 0.0)
                crit1 = (scores > thre2).sum() > 0.8 * len(scores)
                if crit1 and prior > 0:
                    candidates.append(
                        (i, j, prior, prior + a[2] + b[2])
                    )
        candidates.sort(key=lambda c: c[2], reverse=True)
        connection = []
        used_i, used_j = set(), set()
        for i, j, s, _ in candidates:
            if i not in used_i and j not in used_j:
                connection.append(
                    [cand_a[i][3], cand_b[j][3], s, i, j]
                )
                used_i.add(i); used_j.add(j)
                if len(connection) >= min(len(cand_a), len(cand_b)):
                    break
        connection_all.append(connection)
    return connection_all, special_k


def assemble_subsets(all_peaks, connection_all, special_k):
    """Greedy person assembly (controlnet_aux body.py subset pass).
    Returns (subset (N, 20), candidate (M, 4))."""
    candidate = np.array(
        [p for part in all_peaks for p in part], np.float64
    ).reshape(-1, 4)
    subset = np.empty((0, 20))
    for k in range(len(MAP_IDX)):
        if k in special_k or not connection_all[k]:
            continue
        part_as = [c[0] for c in connection_all[k]]
        part_bs = [c[1] for c in connection_all[k]]
        index_a, index_b = np.array(LIMB_SEQ[k]) - 1
        for i, conn in enumerate(connection_all[k]):
            found = 0
            subset_idx = [-1, -1]
            for j in range(len(subset)):
                if subset[j][index_a] == part_as[i] or \
                        subset[j][index_b] == part_bs[i]:
                    subset_idx[found] = j
                    found += 1
            if found == 1:
                j = subset_idx[0]
                if subset[j][index_b] != part_bs[i]:
                    subset[j][index_b] = part_bs[i]
                    subset[j][-1] += 1
                    subset[j][-2] += (
                        candidate[int(part_bs[i]), 2] + conn[2]
                    )
            elif found == 2:
                j1, j2 = subset_idx
                membership = (
                    (subset[j1] >= 0).astype(int)
                    + (subset[j2] >= 0).astype(int)
                )[:-2]
                if (membership == 2).sum() == 0:  # merge
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += conn[2]
                    subset = np.delete(subset, j2, 0)
                else:
                    subset[j1][index_b] = part_bs[i]
                    subset[j1][-1] += 1
                    subset[j1][-2] += (
                        candidate[int(part_bs[i]), 2] + conn[2]
                    )
            elif found == 0 and k < 17:
                row = -1 * np.ones(20)
                row[index_a] = part_as[i]
                row[index_b] = part_bs[i]
                row[-1] = 2
                row[-2] = (
                    candidate[int(part_as[i]), 2]
                    + candidate[int(part_bs[i]), 2] + conn[2]
                )
                subset = np.vstack([subset, row])
    keep = [
        i for i in range(len(subset))
        if subset[i][-1] >= 4 and subset[i][-2] / subset[i][-1] >= 0.4
    ]
    return subset[keep], candidate


def _segment_window(h: int, w: int, a: np.ndarray, b: np.ndarray,
                    r: float):
    """Local-window mask for a thick segment (capsule of radius ``r``
    around ab): ``(y0, y1, x0, x1, mask)`` or None when off-canvas. The
    distance-field math matches the previous full-canvas rasterization
    bit for bit; restricting it to the segment's bounding box makes each
    stick O(drawn area) instead of O(H*W)."""
    x0 = max(int(np.floor(min(a[0], b[0]) - r)), 0)
    x1 = min(int(np.ceil(max(a[0], b[0]) + r)) + 1, w)
    y0 = max(int(np.floor(min(a[1], b[1]) - r)), 0)
    y1 = min(int(np.ceil(max(a[1], b[1]) + r)) + 1, h)
    if x0 >= x1 or y0 >= y1:
        return None
    yy, xx = np.mgrid[y0:y1, x0:x1]
    ab = b - a
    denom = max(float((ab ** 2).sum()), 1e-8)
    t = np.clip(((xx - a[0]) * ab[0] + (yy - a[1]) * ab[1]) / denom,
                0.0, 1.0)
    d2 = (xx - (a[0] + t * ab[0])) ** 2 + (yy - (a[1] + t * ab[1])) ** 2
    return y0, y1, x0, x1, d2 <= r * r


def _disk_window(h: int, w: int, x: float, y: float, r: float):
    """Local-window mask for a filled disk: same contract as
    :func:`_segment_window`."""
    x0 = max(int(np.floor(x - r)), 0)
    x1 = min(int(np.ceil(x + r)) + 1, w)
    y0 = max(int(np.floor(y - r)), 0)
    y1 = min(int(np.ceil(y + r)) + 1, h)
    if x0 >= x1 or y0 >= y1:
        return None
    yy, xx = np.mgrid[y0:y1, x0:x1]
    return y0, y1, x0, x1, (xx - x) ** 2 + (yy - y) ** 2 <= r * r


def draw_bodypose(h: int, w: int, candidate: np.ndarray,
                  subset: np.ndarray) -> np.ndarray:
    """Render the skeleton (controlnet_aux util.draw_bodypose: 17 limb
    sticks + 18 joint dots on black), numpy rasterization (no cv2).
    Returns (h, w, 3) float32 in [0, 1]."""
    canvas = np.zeros((h, w, 3), np.float32)
    stickwidth = 4
    for k in range(17):
        for person in subset:
            idx = person[np.array(LIMB_SEQ[k]) - 1]
            if -1 in idx:
                continue
            a = candidate[int(idx[0]), :2]
            b = candidate[int(idx[1]), :2]
            win = _segment_window(h, w, a, b, stickwidth)
            if win is None:
                continue
            y0, y1, x0, x1, m = win
            color = np.array(_COLORS[k], np.float32) / 255.0 * 0.6
            view = canvas[y0:y1, x0:x1]
            view[m] = np.maximum(view[m], color)
    for part in range(18):
        for person in subset:
            idx = int(person[part])
            if idx == -1:
                continue
            x, y = candidate[idx, :2]
            win = _disk_window(h, w, x, y, 4)
            if win is None:
                continue
            y0, y1, x0, x1, m = win
            canvas[y0:y1, x0:x1][m] = (
                np.array(_COLORS[part], np.float32) / 255.0
            )
    return canvas




# --- hand/face boxes from the body pose -----------------------------------


def hand_boxes_from_body(candidate: np.ndarray, subset: np.ndarray,
                         h: int, w: int) -> List[Tuple[int, int, int, bool]]:
    """(x, y, size, is_left) square crops, one per visible forearm —
    pytorch-openpose util.handDetect: box center extrapolated 0.33 past the
    wrist along the elbow->wrist line, side 1.5x max(|wrist-elbow|,
    0.9 |elbow-shoulder|), clamped, dropped under 20 px."""
    ratio = 0.33
    out = []
    for person in subset:
        for s_i, e_i, w_i, is_left in ((2, 3, 4, False), (5, 6, 7, True)):
            idx = person[[s_i, e_i, w_i]]
            if -1 in idx:
                continue
            (x1, y1), (x2, y2), (x3, y3) = (candidate[int(i), :2]
                                            for i in idx)
            x = x3 + ratio * (x3 - x2)
            y = y3 + ratio * (y3 - y2)
            d_we = np.hypot(x3 - x2, y3 - y2)
            d_es = np.hypot(x2 - x1, y2 - y1)
            width = 1.5 * max(d_we, 0.9 * d_es)
            x, y = max(x - width / 2, 0.0), max(y - width / 2, 0.0)
            width = min(width, w - x, h - y)
            if width >= 20:
                out.append((int(x), int(y), int(width), is_left))
    return out


def face_box_from_body(candidate: np.ndarray, subset: np.ndarray,
                       h: int, w: int) -> List[Tuple[int, int, int]]:
    """(x, y, size) square face crops from head keypoints (nose 0, eyes
    14/15, ears 16/17): half-size = max over (3x nose-eye distance,
    1.5x nose-ear distance) — the controlnet_aux util.faceDetect scaling."""
    out = []
    for person in subset:
        if person[0] < 0:
            continue
        x0, y0 = candidate[int(person[0]), :2]
        half = 0.0
        for part, scale in ((14, 3.0), (15, 3.0), (16, 1.5), (17, 1.5)):
            if person[part] < 0:
                continue
            x1, y1 = candidate[int(person[part]), :2]
            half = max(half, scale * max(abs(x0 - x1), abs(y0 - y1)))
        x, y = max(x0 - half, 0.0), max(y0 - half, 0.0)
        size = min(2 * half, w - x, h - y)
        if size >= 20:
            out.append((int(x), int(y), int(size)))
    return out




def peaks_from_heatmaps(heat: np.ndarray, thre: float = 0.05,
                        sigma: float = 3.0) -> np.ndarray:
    """One (x, y, score) per part channel ((-1, -1, 0) where no pixel
    clears the threshold).

    With ``sigma > 0`` this is controlnet_aux's hand peak rule
    (open_pose/hand.py:26-44): threshold the Gaussian-blurred map,
    8-connected component labeling, keep the component whose ORIGINAL-map
    sum is largest, and take the argmax of the original map inside it.
    With ``sigma = 0`` (the face net) it is the plain argmax of the raw
    map over threshold (open_pose/face.py peak pass)."""
    from scipy import ndimage

    n = heat.shape[-1]
    out = np.full((n, 3), -1.0, np.float32)
    out[:, 2] = 0.0
    eight = np.ones((3, 3), np.int32)  # skimage connectivity=ndim (8-conn)
    for part in range(n):
        map_ori = heat[:, :, part]
        if not sigma:
            j = int(np.argmax(map_ori))
            y, x = divmod(j, map_ori.shape[1])
            if map_ori[y, x] > thre:
                out[part] = (x, y, map_ori[y, x])
            continue
        binary = _gaussian_blur(map_ori, sigma) > thre
        if not binary.any():
            continue
        labels, k = ndimage.label(binary, structure=eight)
        sums = ndimage.sum_labels(map_ori, labels,
                                  index=np.arange(1, k + 1))
        best = int(np.argmax(sums)) + 1
        masked = np.where(labels == best, map_ori, 0.0)
        j = int(np.argmax(masked))
        y, x = divmod(j, masked.shape[1])
        out[part] = (x, y, map_ori[y, x])
    return out




# --- rendering --------------------------------------------------------------

HAND_EDGES = [
    [0, 1], [1, 2], [2, 3], [3, 4], [0, 5], [5, 6], [6, 7], [7, 8],
    [0, 9], [9, 10], [10, 11], [11, 12], [0, 13], [13, 14], [14, 15],
    [15, 16], [0, 17], [17, 18], [18, 19], [19, 20],
]


def _hsv_to_rgb(hue: float) -> np.ndarray:
    i = int(hue * 6.0) % 6
    f = hue * 6.0 - int(hue * 6.0)
    q, t = 1.0 - f, f
    table = [(1, t, 0), (q, 1, 0), (0, 1, t), (0, q, 1), (t, 0, 1),
             (1, 0, q)]
    return np.array(table[i], np.float32)


def draw_handpose(canvas: np.ndarray, peaks: np.ndarray) -> None:
    """In-place: 20 hue-coded finger edges + blue joint dots for one hand's
    (21, 3) peak array in canvas pixel coords (controlnet_aux
    util.draw_handpose)."""
    h, w = canvas.shape[:2]
    for ie, (a_i, b_i) in enumerate(HAND_EDGES):
        a, b = peaks[a_i, :2], peaks[b_i, :2]
        if a[0] < 0 or b[0] < 0:
            continue
        win = _segment_window(h, w, a, b, 2.0)
        if win is None:
            continue
        y0, y1, x0, x1, m = win
        canvas[y0:y1, x0:x1][m] = _hsv_to_rgb(ie / len(HAND_EDGES))
    for x, y, score in peaks:
        if x < 0:
            continue
        win = _disk_window(h, w, x, y, 3)
        if win is None:
            continue
        y0, y1, x0, x1, m = win
        canvas[y0:y1, x0:x1][m] = np.array([0.0, 0.0, 1.0], np.float32)


def draw_facepose(canvas: np.ndarray, peaks: np.ndarray) -> None:
    """In-place: white 3-px dots for the 70 face keypoints
    (controlnet_aux util.draw_facepose)."""
    h, w = canvas.shape[:2]
    for x, y, score in peaks[:70]:
        if x < 0:
            continue
        win = _disk_window(h, w, x, y, 3)
        if win is None:
            continue
        y0, y1, x0, x1, m = win
        canvas[y0:y1, x0:x1][m] = 1.0


def _crop_heatmaps(apply_fn, params, crop01: np.ndarray, n_parts: int,
                   boxsize: int, scales) -> np.ndarray:
    """Keypoint heatmaps of one square RGB [0, 1] crop, averaged over the
    scales and resized to the crop (pytorch-openpose's scale search)."""
    side = crop01.shape[0]
    acc = np.zeros((side, side, n_parts), np.float32)
    x = N.host_image(np.asarray(crop01, np.float32),
                     N.param_device(params))[0]
    for s in scales:
        t = max(int(round(boxsize * s / 8.0)) * 8, 8)
        heat = apply_fn(params, _bgr(resize(x, (t, t, 3), "linear"))[None])
        acc += resize(heat[0], (side, side, n_parts), "linear").cpu().numpy()
    return acc / len(scales)


def detect_pose(params, image: np.ndarray, detect_resolution: int = 368,
                include_body: bool = True, include_hand: bool = False,
                include_face: bool = False, hand_params=None,
                face_params=None) -> np.ndarray:
    """RGB image (H, W, 3), uint8 or [0, 1] or 0..255 floats -> skeleton
    control image (H, W, 3) float32 in [0, 1]; the hand and face nets
    add their keypoints, located from the body pose."""
    img = np.asarray(image)
    if img.dtype == np.uint8 or img.max() > 1.0:
        img = img.astype(np.float32) / 255.0
    h, w = img.shape[:2]
    scale = detect_resolution / max(h, w)
    th = max(int(round(h * scale / 8.0)) * 8, 8)
    tw = max(int(round(w * scale / 8.0)) * 8, 8)
    small = resize(N.host_image(np.asarray(img, np.float32),
                                N.param_device(params))[0], (th, tw, 3),
                   "linear")
    paf, heat = openpose_body_apply(params, _bgr(small)[None])
    heat_up = resize(heat[0], (th, tw, N_HEAT), "linear").cpu().numpy()
    paf_up = resize(paf[0], (th, tw, N_PAF), "linear").cpu().numpy()
    peaks = find_peaks(heat_up)
    conns, special = pair_limbs(paf_up, peaks, orig_h=th)
    subset, candidate = assemble_subsets(peaks, conns, special)
    if len(candidate):
        candidate = candidate.copy()
        candidate[:, 0] *= w / tw
        candidate[:, 1] *= h / th
    canvas = (draw_bodypose(h, w, candidate, subset) if include_body
              else np.zeros((h, w, 3), np.float32))
    if (include_hand or include_face) and len(candidate):
        if include_hand and hand_params is not None:
            for x, y, size, is_left in hand_boxes_from_body(
                    candidate, subset, h, w):
                crop = img[y:y + size, x:x + size]
                if not is_left:  # the net sees left hands; mirror rights
                    crop = crop[:, ::-1]
                heat = _crop_heatmaps(openpose_hand_apply, hand_params,
                                      crop, N_HAND, HAND_BOXSIZE,
                                      HAND_SCALES)
                pk = peaks_from_heatmaps(heat[:, :, :21])
                vis = pk[:, 0] >= 0
                if not is_left:
                    pk[vis, 0] = crop.shape[1] - 1 - pk[vis, 0]
                pk[vis, 0] += x
                pk[vis, 1] += y
                draw_handpose(canvas, pk)
        if include_face and face_params is not None:
            for x, y, size in face_box_from_body(candidate, subset, h, w):
                crop = img[y:y + size, x:x + size]
                heat = _crop_heatmaps(openpose_face_apply, face_params,
                                      crop, N_FACE, FACE_BOXSIZE,
                                      FACE_SCALES)
                pk = peaks_from_heatmaps(heat[:, :, :70], sigma=0.0)
                vis = pk[:, 0] >= 0
                pk[vis, 0] += x
                pk[vis, 1] += y
                draw_facepose(canvas, pk)
    return canvas
