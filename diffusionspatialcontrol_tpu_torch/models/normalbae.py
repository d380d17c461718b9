"""NormalBae surface normals, NNET on an EfficientNet-B5 encoder (port of
``models/normalbae.py``).

The reference's "Normal Map" detector (controlnet_aux's NormalBaeDetector,
``scannet.pt``):

  * the ``tf_efficientnet_b5_ap`` encoder: TF-SAME-padded MBConv stages
    with SiLU and squeeze-excitation, BatchNorm (eps 1e-3) folded at
    conversion into per-channel affines after the convs;
  * the decoder: a 1x1 bottleneck on the 2048-wide head conv, four
    UpSampleBN fusions (align-corners upsampling, two conv / BN /
    LeakyReLU) against the 1/16..1/2 taps, a 1/8 4-channel head (normal
    xyz and the concentration kappa);
  * three uncertainty-guided refinement levels (1/4, 1/2, 1/1): the
    pointwise MLP runs dense over the upsampled map and the top-k most
    uncertain pixels plus a random coverage subset adopt its prediction,
    as the JAX package computes it.

The coverage draws are uniform numbers from ``torch.Generator(seed)``; the
JAX package draws them from ``PRNGKey(seed)`` (``draws`` takes another
source's). The parameters mirror the JAX tree with OIHW kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize, resize_bilinear_align_corners as _resize_ac
from . import _nets as N
from .layers import _same_pads


@dataclasses.dataclass(frozen=True)
class NormalBaeConfig:
    # per encoder stage: (expand_ratio, kernel, first_stride, out_channels,
    # repeats)
    stem_channels: int = 48
    stages: Tuple[Tuple[int, int, int, int, int], ...] = (
        (1, 3, 1, 24, 3),
        (6, 3, 2, 40, 5),
        (6, 5, 2, 64, 5),
        (6, 3, 2, 128, 7),
        (6, 5, 1, 176, 7),
        (6, 5, 2, 304, 9),
        (6, 3, 1, 512, 3),
    )
    head_channels: int = 2048
    tap_stages: Tuple[int, int, int, int] = (0, 1, 2, 4)
    decoder_features: Tuple[int, int, int, int] = (1024, 512, 256, 128)
    mlp_hidden: int = 128
    sampling_ratio: float = 0.4
    importance_ratio: float = 0.7


#: the JAX package's small preset: the same structure at tiny widths
NNET_TINY = NormalBaeConfig(
    stem_channels=8,
    stages=((1, 3, 1, 8, 1), (6, 3, 2, 12, 1), (6, 5, 2, 16, 2),
            (6, 3, 2, 24, 1), (6, 5, 1, 32, 1), (6, 5, 2, 40, 1),
            (6, 3, 1, 48, 1)),
    head_channels=64,
    decoder_features=(48, 32, 16, 8),
    mlp_hidden=16,
)

_ENC = "encoder.original_model"


def _block_layout(cfg: NormalBaeConfig):
    """(stage, index, in_c, stage tuple, stride) per encoder block."""
    out, in_c = [], cfg.stem_channels
    for s, st in enumerate(cfg.stages):
        for i in range(st[4]):
            out.append((s, i, in_c, st, st[2] if i == 0 else 1))
            in_c = st[3]
    return out, in_c


def random_state_dict(cfg: NormalBaeConfig = NormalBaeConfig(),
                      seed: int = 0) -> Dict[str, np.ndarray]:
    d = N.Draw(seed)
    d.conv(f"{_ENC}.conv_stem", cfg.stem_channels, 3, 3, bias=False)
    d.bn(f"{_ENC}.bn1", cfg.stem_channels)
    blocks, last = _block_layout(cfg)
    for s, i, in_c, (e, k, _, out_c, _), _ in blocks:
        b = f"{_ENC}.blocks.{s}.{i}"
        hidden, rd = in_c * e, max(1, int(in_c * 0.25))
        if e != 1:
            d.conv(f"{b}.conv_pw", hidden, in_c, 1, bias=False)
            d.bn(f"{b}.bn1", hidden)
        d.conv(f"{b}.conv_dw", hidden, hidden, k, bias=False, groups=hidden)
        d.bn(f"{b}.bn2" if e != 1 else f"{b}.bn1", hidden)
        d.conv(f"{b}.se.conv_reduce", rd, hidden, 1)
        d.conv(f"{b}.se.conv_expand", hidden, rd, 1)
        d.conv(f"{b}.conv_pwl" if e != 1 else f"{b}.conv_pw", out_c, hidden,
               1, bias=False)
        d.bn(f"{b}.bn3" if e != 1 else f"{b}.bn2", out_c)
    hc = cfg.head_channels
    d.conv(f"{_ENC}.conv_head", hc, last, 1, bias=False)
    d.conv("decoder.conv2", hc, hc, 1)
    taps = [cfg.stages[i][3] for i in cfg.tap_stages]
    f1, f2, f3, f4 = cfg.decoder_features
    for i, (ic, oc) in enumerate(((hc + taps[3], f1), (f1 + taps[2], f2),
                                  (f2 + taps[1], f3), (f3 + taps[0], f4)),
                                 1):
        d.conv(f"decoder.up{i}._net.0", oc, ic, 3)
        d.bn(f"decoder.up{i}._net.1", oc)
        d.conv(f"decoder.up{i}._net.3", oc, oc, 3)
        d.bn(f"decoder.up{i}._net.4", oc)
    d.conv("decoder.out_conv_res8", 4, f2, 3)
    for res, width in ((4, f2), (2, f3), (1, f4)):
        h = cfg.mlp_hidden
        for j, (o, i) in zip((0, 2, 4, 6), ((h, width + 4), (h, h), (h, h),
                                            (4, h))):
            d.conv(f"decoder.out_conv_res{res}.{j}", o, i, 1)
            d.sd[f"decoder.out_conv_res{res}.{j}.weight"] = d.sd[
                f"decoder.out_conv_res{res}.{j}.weight"][:, :, :, 0]
    return d.sd


def _fold(sd, conv_key, bn_key, eps, device):
    """A conv and its BatchNorm -> {kernel (OIHW), scale, bias} (the scale
    absent without a BatchNorm)."""
    kernel = np.asarray(sd.get(f"{conv_key}.weight"), np.float32)
    conv_bias = (np.asarray(sd.get(f"{conv_key}.bias"), np.float32)
                 if f"{conv_key}.bias" in sd.tensors else
                 np.zeros((kernel.shape[0],), np.float32))
    if bn_key is None:
        return N.tensors({"kernel": kernel, "bias": conv_bias}, device)
    gamma = np.asarray(sd.get(f"{bn_key}.weight"), np.float32)
    beta = np.asarray(sd.get(f"{bn_key}.bias"), np.float32)
    mean = np.asarray(sd.get(f"{bn_key}.running_mean"), np.float32)
    var = np.asarray(sd.get(f"{bn_key}.running_var"), np.float32)
    scale = gamma / np.sqrt(var + eps)
    return N.tensors({"kernel": kernel, "scale": scale,
                      "bias": beta + scale * (conv_bias - mean)}, device)


def convert_nnet(sd, cfg: NormalBaeConfig = NormalBaeConfig(), device=None
                 ) -> Dict[str, Any]:
    """``sd``: the NNET checkpoint (``module.`` already stripped) -> the
    folded tree in fp32 on ``device``. Encoder BN eps 1e-3, decoder
    1e-5."""
    sd = N.state_dict(sd)
    device = N.resolve_device(device)
    p: Dict[str, Any] = {"stem": _fold(sd, f"{_ENC}.conv_stem",
                                       f"{_ENC}.bn1", 1e-3, device)}
    stages: List[List[Dict[str, Any]]] = [[] for _ in cfg.stages]
    for s, i, _, st, _ in _block_layout(cfg)[0]:
        b = f"{_ENC}.blocks.{s}.{i}"
        blk: Dict[str, Any] = {}
        if st[0] != 1:
            blk["pw"] = _fold(sd, f"{b}.conv_pw", f"{b}.bn1", 1e-3, device)
            blk["dw"] = _fold(sd, f"{b}.conv_dw", f"{b}.bn2", 1e-3, device)
            blk["pwl"] = _fold(sd, f"{b}.conv_pwl", f"{b}.bn3", 1e-3, device)
        else:
            blk["dw"] = _fold(sd, f"{b}.conv_dw", f"{b}.bn1", 1e-3, device)
            blk["pwl"] = _fold(sd, f"{b}.conv_pw", f"{b}.bn2", 1e-3, device)
        blk["se"] = {n: _fold(sd, f"{b}.se.conv_{n}", None, 1e-3, device)
                     for n in ("reduce", "expand")}
        stages[s].append(blk)
    p["stages"] = stages
    p["head"] = N.tensors({"kernel": np.asarray(
        sd.get(f"{_ENC}.conv_head.weight"), np.float32)}, device)
    dec: Dict[str, Any] = {"conv2": _fold(sd, "decoder.conv2", None, 1e-5,
                                          device)}
    for i in range(1, 5):
        dec[f"up{i}"] = {
            "conv1": _fold(sd, f"decoder.up{i}._net.0",
                           f"decoder.up{i}._net.1", 1e-5, device),
            "conv2": _fold(sd, f"decoder.up{i}._net.3",
                           f"decoder.up{i}._net.4", 1e-5, device),
        }
    dec["out8"] = _fold(sd, "decoder.out_conv_res8", None, 1e-5, device)
    for name, res in (("mlp4", 4), ("mlp2", 2), ("mlp1", 1)):
        dec[name] = [N.tensors({
            "kernel": np.asarray(sd.get(
                f"decoder.out_conv_res{res}.{j}.weight"), np.float32)[:, :, 0],
            "bias": np.asarray(sd.get(f"decoder.out_conv_res{res}.{j}.bias"),
                               np.float32)}, device) for j in (0, 2, 4, 6)]
    p["decoder"] = dec
    return p


def _conv(p, x, stride=1, groups=1):
    """NCHW conv with TF-SAME padding (the odd pixel on the high side),
    then the folded BatchNorm's scale and the bias."""
    k = p["kernel"]
    ph = _same_pads(x.shape[2], k.shape[-1], stride)
    pw = _same_pads(x.shape[3], k.shape[-1], stride)
    if ph[0] != ph[1] or pw[0] != pw[1]:
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        pad = 0
    else:
        pad = (ph[0], pw[0])
    y = F.conv2d(x, k, stride=stride, padding=pad, groups=groups)
    if "scale" in p:
        y = y * p["scale"][:, None, None]
    if "bias" in p:
        y = y + p["bias"][:, None, None]
    return y


def _se(p, x):
    s = x.mean(dim=(2, 3), keepdim=True)
    s = F.silu(_conv(p["reduce"], s))
    return x * torch.sigmoid(_conv(p["expand"], s))


def norm_normalize(x: torch.Tensor) -> torch.Tensor:
    """Unit xyz and kappa -> elu(kappa) + 1.01, on the last axis of
    [nx, ny, nz, kappa]."""
    n, kappa = x[..., :3], x[..., 3:]
    mag = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True)) + 1e-10
    kappa = F.elu(kappa) + 1.0 + 0.01
    return torch.cat([n / mag, kappa], dim=-1)


def _encoder(p, cfg: NormalBaeConfig, x):
    """NCHW pixels -> [taps at 1/2, 1/4, 1/8, 1/16, the head at 1/32]."""
    x = F.silu(_conv(p["stem"], x, stride=2))
    stage_out = [None] * len(cfg.stages)
    for s, i, in_c, st, stride in _block_layout(cfg)[0]:
        blk = p["stages"][s][i]
        h = x
        if "pw" in blk:
            h = F.silu(_conv(blk["pw"], h))
        h = F.silu(_conv(blk["dw"], h, stride=stride, groups=h.shape[1]))
        h = _conv(blk["pwl"], _se(blk["se"], h))
        x = h + x if stride == 1 and in_c == st[3] else h
        stage_out[s] = x
    head = _conv(p["head"], x)
    return [N.nhwc(stage_out[i]) for i in cfg.tap_stages] + [N.nhwc(head)]


def _nhwc_conv(p, x):
    return N.nhwc(_conv(p, N.nchw(x)))


def _upsample_fuse(p, x, skip):
    up = _resize_ac(x, skip.shape[1], skip.shape[2])
    h = torch.cat([up, skip], dim=-1)
    h = F.leaky_relu(_nhwc_conv(p["conv1"], h), 0.01)
    return F.leaky_relu(_nhwc_conv(p["conv2"], h), 0.01)


def _mlp(layers, x):
    for i, layer in enumerate(layers):
        x = F.linear(x, layer["kernel"], layer["bias"])
        if i < len(layers) - 1:
            x = F.relu(x)
    return x


def _topk_mask(scores, k):
    idx = torch.topk(scores, k, dim=-1).indices
    m = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    return m.scatter(1, idx, True)


def _refine(mlp, feat_src, out_prev, ratio, beta, draw):
    b, h, w, _ = out_prev.shape
    H, W = 2 * h, 2 * w
    feat = _resize_ac(feat_src, H, W)
    init = _resize_ac(out_prev, H, W)
    refined = norm_normalize(_mlp(mlp, torch.cat([feat, init], dim=-1)))
    n = int(ratio * H * W)
    n_imp = int(beta * n)
    n_cov = n - n_imp
    unc = -init[..., 3].reshape(b, H * W)
    sel = (_topk_mask(unc, n_imp) if n_imp > 0 else
           torch.zeros((b, H * W), dtype=torch.bool, device=unc.device))
    if n_cov > 0:
        r = torch.where(sel, torch.full_like(unc, -1.0), draw(b, H * W))
        sel = sel | _topk_mask(r, n_cov)
    return torch.where(sel.reshape(b, H, W, 1), refined, init)


def nnet_apply(params, cfg: NormalBaeConfig, pixels: torch.Tensor,
               seed: int = 0,
               draws: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
    """pixels (B, H, W, 3) ImageNet-normalized, H and W multiples of 32 ->
    the full-resolution prediction (B, H, W, 4) = [normal xyz, kappa].
    The refinement levels' coverage draws come from
    ``torch.Generator().manual_seed(seed)`` on the host, or from ``draws``
    (three (B, H_l W_l) uniform tensors, the 1/4, 1/2 and 1/1 levels')."""
    dev = pixels.device
    gen = torch.Generator().manual_seed(seed)
    it = iter(draws) if draws is not None else None

    def draw(b, n):
        if it is not None:
            return torch.tensor(np.asarray(next(it), np.float32),
                                device=dev).reshape(b, n)
        return torch.rand((b, n), generator=gen).to(dev)

    t2, t4, t8, t16, head = _encoder(params, cfg, N.nchw(pixels.float()))
    d = params["decoder"]
    x_d0 = _nhwc_conv(d["conv2"], head)
    x_d1 = _upsample_fuse(d["up1"], x_d0, t16)
    x_d2 = _upsample_fuse(d["up2"], x_d1, t8)
    x_d3 = _upsample_fuse(d["up3"], x_d2, t4)
    x_d4 = _upsample_fuse(d["up4"], x_d3, t2)
    out8 = norm_normalize(_nhwc_conv(d["out8"], x_d2))
    r, beta = cfg.sampling_ratio, cfg.importance_ratio
    out4 = _refine(d["mlp4"], x_d2, out8, r, beta, draw)
    out2 = _refine(d["mlp2"], x_d3, out4, r, beta, draw)
    return _refine(d["mlp1"], x_d4, out2, r, beta, draw)


_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def detect_normalbae(params, image: np.ndarray,
                     cfg: NormalBaeConfig = NormalBaeConfig(),
                     detect_res: int = 512, seed: int = 0) -> np.ndarray:
    """RGB image -> (H, W, 3) normal map in [0, 1], (n + 1) / 2 a
    channel: the short side resized to ``detect_res``, both sides rounded
    to multiples of 64, NNET, and the map resized back."""
    img = np.asarray(image)
    if img.dtype != np.uint8 and img.max() <= 1.0:
        img = img * 255.0
    img = img.astype(np.float32)
    h, w = img.shape[:2]
    k = detect_res / min(h, w)
    th = max(int(np.round(h * k / 64.0)) * 64, 64)
    tw = max(int(np.round(w * k / 64.0)) * 64, 64)
    dev = N.param_device(params)
    small = resize(N.host_image(img, dev)[0], (th, tw, 3), "linear")
    mean = torch.from_numpy(_IMAGENET_MEAN).to(dev)
    std = torch.from_numpy(_IMAGENET_STD).to(dev)
    out = nnet_apply(params, cfg, ((small / 255.0 - mean) / std)[None],
                     seed=seed)
    normal = torch.clamp((out[0, :, :, :3] + 1.0) * 0.5, 0.0, 1.0)
    return resize(normal, (h, w, 3), "linear").clamp(0.0, 1.0).cpu().numpy()
