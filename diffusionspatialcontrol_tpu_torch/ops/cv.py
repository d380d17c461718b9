"""The three OpenCV calls of the JAX package's detectors, without OpenCV.

The JAX package calls ``cv2`` in three places: ``cv2.resize(...,
INTER_AREA)`` on MLSD's input (models/mlsd.py), ``cv2.line`` (8-connected,
thickness 1) for MLSD's segments, and ``cv2.Sobel(ksize=3)`` in the "Normal
Map" depth-gradient fallback (ops/preprocess.py). The card's machine has no
``cv2``, and the JAX package's ``except ImportError`` fallbacks give other
numbers, so the port computes what OpenCV computes:

  * ``resize_area``: OpenCV's INTER_AREA for float32 images, its three
    paths: the block mean at integer factors, the area weights
    (``computeResizeAreaTab``) when both axes shrink, and linear
    interpolation with the area-mode coefficients when an axis grows, each
    summed in float32 in OpenCV's order (its x86 vector bodies' order where
    they sum otherwise than its scalar code);
  * ``draw_line``: ``clipLine`` and the 8-connected ``LineIterator``,
    drawn left to right;
  * ``sobel``: the separable 3-tap derivative with BORDER_REFLECT_101, row
    filter then column filter, the 1-2-1 taps summed as OpenCV's code sums
    them on an x86 host with AVX2 (its 8-lane vector body and scalar
    tail).

``resize_area`` and ``sobel`` take numpy arrays or torch tensors (on any
device; only elementwise float32 ops, so the card gives the host's bits);
``draw_line`` draws into either.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

_DBL_EPSILON = sys.float_info.epsilon


def _asarray(like, a):
    """numpy ``a`` as ``like``'s kind: itself for numpy, a tensor on
    ``like``'s device for torch."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(a, device=like.device)
    return a


def _zeros(like, shape):
    if isinstance(like, torch.Tensor):
        return torch.zeros(shape, dtype=torch.float32, device=like.device)
    return np.zeros(shape, np.float32)


def _area_tab(n_in: int, n_out: int, scale: float):
    """OpenCV ``computeResizeAreaTab``: (destination, source, alpha) per
    tap, in OpenCV's order."""
    tab = []
    for d in range(n_out):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, n_in - fs1)
        s1, s2 = math.ceil(fs1), math.floor(fs2)
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        if s1 - fs1 > 1e-3:
            tab.append((d, s1 - 1, np.float32((s1 - fs1) / cell)))
        for s in range(s1, s2):
            tab.append((d, s, np.float32(1.0 / cell)))
        if fs2 - s2 > 1e-3:
            tab.append((d, s2, np.float32(min(min(fs2 - s2, 1.0), cell)
                                          / cell)))
    return tab


def _by_rank(tab):
    """Group taps by their rank within their destination: one vector op a
    rank keeps each destination's sum in OpenCV's order."""
    ranks, seen = [], {}
    for d, s, a in tab:
        r = seen.get(d, 0)
        seen[d] = r + 1
        if r == len(ranks):
            ranks.append(([], [], []))
        ranks[r][0].append(d)
        ranks[r][1].append(s)
        ranks[r][2].append(a)
    return [(np.asarray(d, np.int64), np.asarray(s, np.int64),
             np.asarray(a, np.float32)) for d, s, a in ranks]


def _linear_area_coeffs(n_in: int, n_out: int):
    """The linear path's source index and weight per output with
    ``INTER_AREA``'s coefficients (``fx = (dx + 1) - (sx + 1) / scale``,
    its fraction), clamped at the last source as OpenCV clamps it."""
    inv_scale = n_out / n_in
    scale = 1.0 / inv_scale
    lo = np.zeros(n_out, np.int64)
    frac = np.zeros(n_out, np.float32)
    for d in range(n_out):
        s = math.floor(d * scale)
        f = np.float32((d + 1) - (s + 1) * inv_scale)
        f = np.float32(0.0) if f <= 0 else np.float32(f - math.floor(f))
        if s >= n_in - 1:
            f, s = np.float32(0.0), n_in - 1
        lo[d], frac[d] = s, f
    return lo, np.minimum(lo + 1, n_in - 1), frac


def resize_area(img, out_w: int, out_h: int):
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_AREA)`` for
    a float32 (H, W) or (H, W, C) image (numpy or torch)."""
    h, w = img.shape[:2]
    x = img if img.ndim == 3 else img[:, :, None]
    if (h, w) == (out_h, out_w):
        out = x.clone() if isinstance(x, torch.Tensor) else x.copy()
        return out if img.ndim == 3 else out[:, :, 0]

    scale_x, scale_y = w / out_w, h / out_h
    if scale_x >= 1 and scale_y >= 1:
        ix, iy = round(scale_x), round(scale_y)
        if abs(scale_x - ix) < _DBL_EPSILON and \
                abs(scale_y - iy) < _DBL_EPSILON:
            out = _area_fast(x, ix, iy, out_w, out_h)
        else:
            out = _area(x, scale_x, scale_y, out_w, out_h)
    else:
        xlo, xhi, xf = _linear_area_coeffs(w, out_w)
        ylo, yhi, yf = _linear_area_coeffs(h, out_h)
        xf_, yf_ = _asarray(x, xf)[None, :, None], _asarray(x, yf)
        xlo, xhi = _asarray(x, xlo), _asarray(x, xhi)
        rows = x[:, xlo] * (1 - xf_) + x[:, xhi] * xf_
        b1 = yf_[:, None, None]
        out = rows[_asarray(x, ylo)] * (1 - b1) + rows[_asarray(x, yhi)] * b1
    return out if img.ndim == 3 else out[:, :, 0]


def _area_fast(x, sx: int, sy: int, out_w: int, out_h: int):
    """Integer factors: the block's sum, four taps at a time
    (``sum += a + b + c + d``), row-major, times 1 / area. One channel at
    2 x 2 sums pairs of rows, ``(a + b) + (c + d)``, in OpenCV's 4-lane
    vector body (the columns up to the last multiple of 4)."""
    area = sx * sy
    taps = [x[i::sy][:out_h, j::sx][:, :out_w] for i in range(sy)
            for j in range(sx)]
    total = _zeros(x, (out_h, out_w, x.shape[2]))
    k = 0
    while k + 4 <= area:
        total = total + (((taps[k] + taps[k + 1]) + taps[k + 2])
                         + taps[k + 3])
        k += 4
    for t in taps[k:]:
        total = total + t
    if x.shape[2] == 1 and sx == sy == 2:
        n = out_w // 4 * 4
        total[:, :n] = (taps[0][:, :n] + taps[1][:, :n]) \
            + (taps[2][:, :n] + taps[3][:, :n])
    return total * np.float32(1.0 / area)


def _area(x, scale_x: float, scale_y: float, out_w: int, out_h: int):
    """Non-integer shrinking: each row summed over its x taps into a
    buffer, the buffers summed over the y taps, in float32."""
    h, w = x.shape[:2]
    buf = _zeros(x, (h, out_w, x.shape[2]))
    for d, s, a in _by_rank(_area_tab(w, out_w, scale_x)):
        d_, s_ = _asarray(x, d), _asarray(x, s)
        buf[:, d_] = buf[:, d_] + x[:, s_] * _asarray(x, a)[None, :, None]
    out = _zeros(x, (out_h, out_w, x.shape[2]))
    for d, s, a in _by_rank(_area_tab(h, out_h, scale_y)):
        d_, s_ = _asarray(x, d), _asarray(x, s)
        out[d_] = out[d_] + _asarray(x, a)[:, None, None] * buf[s_]
    return out


def clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV ``clipLine(Size, pt1, pt2)``: the segment clipped to the
    image, or None when none of it lies inside."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def line_pixels(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """(xs, ys) of the pixels OpenCV's 8-connected ``LineIterator`` visits
    from (x1, y1) to (x2, y2) in a w x h image, left to right."""
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    xs = np.empty(dx + 1, np.int64)
    ys = np.empty(dx + 1, np.int64)
    x, y = x1, y1
    for i in range(dx + 1):
        xs[i], ys[i] = x, y
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += sy
            x += sx if minor else 0
        else:
            x += sx
            y += sy if minor else 0
    return xs, ys


def draw_line(canvas, pt1, pt2, value: float = 1.0) -> None:
    """``cv2.line(canvas, pt1, pt2, value, 1)`` (LINE_8) on a (H, W) canvas,
    in place; the points are integer pixel coordinates."""
    h, w = canvas.shape[:2]
    xs, ys = line_pixels(w, h, int(pt1[0]), int(pt1[1]), int(pt2[0]),
                         int(pt2[1]))
    if len(xs):
        canvas[_asarray(canvas, ys), _asarray(canvas, xs)] = value


def _sum_121(a, b, c, col: bool):
    """a + 2 b + c in OpenCV's float32 order on an x86 host with AVX2: its
    8-lane vector code adds the outer taps first, ``(a + c) + 2 b``, and
    its scalar tail past the last whole vector the centre first,
    ``(a + 2 b) + c``; a row filter's tail takes pairs so and sums a last
    odd column as the generic filter does, ``2 b + (a + c)``."""
    out = (a + c) + b * 2
    w = out.shape[1]
    lo = w // 8 * 8
    hi = w if col else lo + (w - lo) // 2 * 2
    out[:, lo:hi] = (a[:, lo:hi] + b[:, lo:hi] * 2) + c[:, lo:hi]
    return out


def sobel(img, dx: int, dy: int):
    """``cv2.Sobel(img, cv2.CV_32F, dx, dy, ksize=3)`` for a float32 (H, W)
    image with the default BORDER_REFLECT_101: the row filter, then the
    column filter, each 1-2-1 filter summed in OpenCV's order
    (``_sum_121``)."""
    if (dx, dy) not in ((1, 0), (0, 1)):
        raise ValueError(f"sobel takes (dx, dy) = (1, 0) or (0, 1), got "
                         f"{(dx, dy)}")
    cat = torch.cat if isinstance(img, torch.Tensor) else np.concatenate

    def pad(a, axis):
        if axis == 0:
            return cat([a[1:2], a, a[-2:-1]], 0)
        return cat([a[:, 1:2], a, a[:, -2:-1]], 1)

    if dx == 1:
        p = pad(img, 1)
        r = p[:, 2:] - p[:, :-2]
        p = pad(r, 0)
        return _sum_121(p[:-2], p[1:-1], p[2:], col=True)
    p = pad(img, 1)
    r = _sum_121(p[:, :-2], p[:, 1:-1], p[:, 2:], col=False)
    p = pad(r, 0)
    return p[2:] - p[:-2]
