"""ArcFace iResNet face-recognition embedder, insightface-compatible (port of
``models/arcface.py``).

The FaceID flow's identity embedding: insightface ``buffalo_l``'s
recognition model is an ArcFace iResNet-50 (``w600k_r50``, distributed in
the ``arcface_torch`` ``backbone.pth`` layout):

  * a 3x3 stem (stride 1) + PReLU, four pre-activation IBasicBlock stages
    (bn1 -> conv1 -> bn2 -> PReLU -> conv2 (stride) -> bn3, a 1x1
    downsample shortcut), a final BN, flatten, the 512-d fc and the
    BatchNorm1d "features" head;
  * inference BatchNorm as per-channel (scale, bias) affines (running stats
    folded at conversion);
  * input: a (112, 112) RGB face crop normalized (x - 127.5) / 127.5;
    output: the L2-normalized (512,) float32 ``normed_embedding``.

Activations are NHWC and convs OIHW, as everywhere in the port; the fc
kernel takes the NHWC flatten, as the JAX package's does. The library
convs run in the parameters' dtype (fp32, as the JAX manager builds it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize
from .layers import as_channels_last


@dataclasses.dataclass(frozen=True)
class ArcFaceConfig:
    layers: Tuple[int, int, int, int] = (3, 4, 14, 3)  # iResNet-50
    widths: Tuple[int, int, int, int] = (64, 128, 256, 512)
    stem_channels: int = 64
    embed_dim: int = 512
    input_size: int = 112

    @property
    def final_spatial(self) -> int:
        return self.input_size // 16  # four stride-2 stages


#: small preset for random-init tests (same structure, fast on CPU)
ARCFACE_TINY = ArcFaceConfig(
    layers=(1, 1, 2, 1), widths=(8, 12, 16, 24), stem_channels=8,
    embed_dim=32, input_size=32,
)


def _affine(p, x):
    """Inference BatchNorm as a per-channel affine over the last axis, in
    fp32."""
    y = x.float() * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def _conv(p, x, stride=1):
    """NHWC conv, symmetric padding (k - 1) / 2, an OIHW kernel."""
    k = p["kernel"]
    y = F.conv2d(x.permute(0, 3, 1, 2), k.to(x.dtype), None, stride=stride,
                 padding=(k.shape[-1] - 1) // 2)
    return y.permute(0, 2, 3, 1)


def _prelu(p, x):
    a = p["alpha"].to(x.dtype)
    return torch.clamp(x, min=0) + a * torch.clamp(x, max=0)


def _affine_init(c, dtype, device):
    return {"scale": torch.ones(c, dtype=dtype, device=device),
            "bias": torch.zeros(c, dtype=dtype, device=device)}


def _conv_init(g, in_c, out_c, k, dtype, device):
    t = torch.empty((out_c, in_c, k, k), dtype=torch.float32, device=device)
    t.normal_(generator=g)
    return {"kernel": as_channels_last((t / math.sqrt(in_c * k * k)).to(
        dtype))}


def arcface_init(g: torch.Generator, cfg: ArcFaceConfig = ArcFaceConfig(),
                 dtype=torch.float32, device=None) -> Dict[str, Any]:
    """Random weights from ``g`` in the JAX package's tree and
    distributions (other values than its ``PRNGKey`` init)."""
    def conv(i, o, k):
        return _conv_init(g, i, o, k, dtype, device)

    def aff(c):
        return _affine_init(c, dtype, device)

    def alpha(c):
        return {"alpha": torch.full((c,), 0.25, dtype=dtype, device=device)}

    params: Dict[str, Any] = {
        "conv1": conv(3, cfg.stem_channels, 3),
        "bn1": aff(cfg.stem_channels),
        "prelu": alpha(cfg.stem_channels),
    }
    in_c = cfg.stem_channels
    stages: List[List[Dict[str, Any]]] = []
    for w, reps in zip(cfg.widths, cfg.layers):
        blocks = []
        for i in range(reps):
            blk = {"bn1": aff(in_c), "conv1": conv(in_c, w, 3),
                   "bn2": aff(w), "prelu": alpha(w), "conv2": conv(w, w, 3),
                   "bn3": aff(w)}
            if i == 0:  # the stride-2 block's shortcut
                blk["down"] = {"conv": conv(in_c, w, 1), "bn": aff(w)}
            blocks.append(blk)
            in_c = w
        stages.append(blocks)
    params["stages"] = stages
    params["bn2"] = aff(in_c)
    fc_in = in_c * cfg.final_spatial ** 2
    t = torch.empty((cfg.embed_dim, fc_in), dtype=torch.float32,
                    device=device).normal_(generator=g)
    params["fc"] = {"kernel": (t / math.sqrt(fc_in)).to(dtype),
                    "bias": torch.zeros(cfg.embed_dim, dtype=dtype,
                                        device=device)}
    params["features"] = aff(cfg.embed_dim)
    return params


# ---------------------------------------------------------------------------
# Converter (arcface_torch ``backbone.pth`` layout, from a state dict in
# memory: name -> array)
# ---------------------------------------------------------------------------


def _get(sd, key) -> np.ndarray:
    return np.asarray(sd[key], np.float32)


def _bn_affine(sd, key, dtype, device, eps=1e-5):
    gamma, beta = _get(sd, f"{key}.weight"), _get(sd, f"{key}.bias")
    mean, var = _get(sd, f"{key}.running_mean"), _get(sd, f"{key}.running_var")
    scale = gamma / np.sqrt(var + eps)
    return {"scale": torch.tensor(scale).to(dtype=dtype, device=device),
            "bias": torch.tensor(beta - scale * mean).to(dtype=dtype,
                                                         device=device)}


def _conv_w(sd, key, dtype, device):
    w = torch.tensor(_get(sd, f"{key}.weight"))  # OIHW, as torch stores it
    return {"kernel": as_channels_last(w.to(dtype=dtype, device=device))}


def convert_arcface(sd, cfg: ArcFaceConfig = ArcFaceConfig(),
                    dtype=torch.float32, device=None) -> Dict[str, Any]:
    """``sd``: name -> array of an arcface_torch iResNet ``backbone.pth``
    (keys conv1/bn1/prelu/layer1..4/bn2/fc/features), in memory
    (``convert.hf.load_state_dict(path).arrays()`` reads the file)."""
    def alpha(key):
        return {"alpha": torch.tensor(_get(sd, key)).to(dtype=dtype,
                                                        device=device)}

    params: Dict[str, Any] = {
        "conv1": _conv_w(sd, "conv1", dtype, device),
        "bn1": _bn_affine(sd, "bn1", dtype, device),
        "prelu": alpha("prelu.weight"),
    }
    stages: List[List[Dict[str, Any]]] = []
    for li, reps in enumerate(cfg.layers, 1):
        blocks = []
        for i in range(reps):
            b = f"layer{li}.{i}"
            blk = {
                "bn1": _bn_affine(sd, f"{b}.bn1", dtype, device),
                "conv1": _conv_w(sd, f"{b}.conv1", dtype, device),
                "bn2": _bn_affine(sd, f"{b}.bn2", dtype, device),
                "prelu": alpha(f"{b}.prelu.weight"),
                "conv2": _conv_w(sd, f"{b}.conv2", dtype, device),
                "bn3": _bn_affine(sd, f"{b}.bn3", dtype, device),
            }
            if f"{b}.downsample.0.weight" in sd:
                blk["down"] = {
                    "conv": _conv_w(sd, f"{b}.downsample.0", dtype, device),
                    "bn": _bn_affine(sd, f"{b}.downsample.1", dtype, device),
                }
            blocks.append(blk)
        stages.append(blocks)
    params["stages"] = stages
    params["bn2"] = _bn_affine(sd, "bn2", dtype, device)
    # torch's fc takes the NCHW flatten (c-major); ours the NHWC flatten
    s, c = cfg.final_spatial, cfg.widths[-1]
    w = _get(sd, "fc.weight").reshape(cfg.embed_dim, c, s, s)
    w = w.transpose(0, 2, 3, 1).reshape(cfg.embed_dim, s * s * c)
    params["fc"] = {
        "kernel": torch.tensor(np.ascontiguousarray(w)).to(dtype=dtype,
                                                           device=device),
        "bias": torch.tensor(_get(sd, "fc.bias")).to(dtype=dtype,
                                                     device=device)}
    params["features"] = _bn_affine(sd, "features", dtype, device)
    return params


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _block_apply(blk, x, stride):
    h = _conv(blk["conv1"], _affine(blk["bn1"], x))
    h = _prelu(blk["prelu"], _affine(blk["bn2"], h))
    h = _affine(blk["bn3"], _conv(blk["conv2"], h, stride=stride))
    if "down" in blk:
        x = _affine(blk["down"]["bn"],
                    _conv(blk["down"]["conv"], x, stride=stride))
    return h + x


def arcface_apply(params, cfg: ArcFaceConfig, pixels: torch.Tensor
                  ) -> torch.Tensor:
    """pixels (B, S, S, 3) in [-1, 1] (S = cfg.input_size) -> raw (B,
    embed_dim) float32 embeddings (normalize for ``normed_embedding``)."""
    x = _conv(params["conv1"], pixels)
    x = _prelu(params["prelu"], _affine(params["bn1"], x))
    for blocks in params["stages"]:
        for i, blk in enumerate(blocks):
            x = _block_apply(blk, x, 2 if i == 0 else 1)
    x = _affine(params["bn2"], x)
    flat = x.reshape(x.shape[0], -1)
    emb = F.linear(flat.float(), params["fc"]["kernel"].float(),
                   params["fc"]["bias"].float())
    return _affine(params["features"], emb).float()


def make_arcface_embedder(params, cfg: ArcFaceConfig = ArcFaceConfig()):
    """``embed(image) -> (embed_dim,) float32 L2-normalized`` numpy, the
    ``normed_embedding`` contract of ``ops/face_embed.py``. The crop is
    resized to the model's input size (``jax.image.resize`` bilinear) and
    normalized (x - 127.5) / 127.5, as insightface's ArcFaceONNX does; the
    network runs on its parameters' device."""
    device = params["conv1"]["kernel"].device

    @torch.inference_mode()
    def embed(image: np.ndarray) -> np.ndarray:
        img = np.asarray(image)
        if img.dtype != np.uint8 and img.max() <= 1.0:
            img = img * 255.0
        img = img.astype(np.float32)
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(
                f"expected (H, W, 3) face crop, got {img.shape}")
        s = cfg.input_size
        x = torch.from_numpy(img).to(device)
        if img.shape[:2] != (s, s):
            x = resize(x, (s, s, 3), "linear")
        x = (x - 127.5) / 127.5
        emb = arcface_apply(params, cfg, x[None])[0].cpu().numpy()
        n = float(np.linalg.norm(emb))
        return emb / max(n, 1e-12)

    return embed
