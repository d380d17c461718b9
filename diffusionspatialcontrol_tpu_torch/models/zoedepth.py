"""ZoeDepth metric depth, BEiT-L backbone with metric-bins heads (port of
``models/zoedepth.py``).

The reference's "Zoedepth" detector (controlnet_aux's ZoeDetector,
``zoed_nk``; the same weights as transformers' Intel/zoedepth-nyu-kitti):

  * the BEiT backbone: patch-16 ViT layers with a relative position bias
    per layer and per head (interpolated to the input's window as
    transformers interpolates it) and layer scale, tapped at
    ``out_layers``; its attention is plain ``scaled_dot_product_attention``
    with the bias as an additive mask (K1's bias is shared across heads,
    so it cannot take this one), as the JAX package's is plain XLA;
  * the DPT-style neck: readout reassembly at x4 / x2 / x1 / x0.5 and the
    fusion pyramid with align-corners doubling;
  * the relative head, and the metric bins: the seed regressor, four
    attractor stages, the conditional log-binomial over the bin centres;
  * the NYU/KITTI router: a patch transformer and an MLP classifier pick
    the bin head per batch (both heads are evaluated).

The weights keep the transformers layout; the parameters are its tensors
by name (fp32, on the device). ``ZOE_TINY`` is the JAX package's small
preset, as weight-compatible as the published one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize, resize_bilinear_align_corners as _resize_ac
from . import _nets as N


@dataclasses.dataclass(frozen=True)
class ZoeBinConfig:
    name: str = "nyu"
    n_bins: int = 64
    min_depth: float = 1e-3
    max_depth: float = 10.0


@dataclasses.dataclass(frozen=True)
class ZoeDepthConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 16
    pretrain_window: int = 24
    layer_scale_init: float = 0.1
    out_layers: Tuple[int, ...] = (6, 12, 18, 24)
    neck_hidden_sizes: Tuple[int, ...] = (256, 512, 1024, 1024)
    reassemble_factors: Tuple[float, ...] = (4.0, 2.0, 1.0, 0.5)
    fusion_hidden_size: int = 256
    num_relative_features: int = 32
    bottleneck_features: int = 256
    bin_embedding_dim: int = 128
    num_attractors: Tuple[int, ...] = (16, 8, 4, 1)
    min_temp: float = 0.0212
    max_temp: float = 50.0
    bin_configurations: Tuple[ZoeBinConfig, ...] = (
        ZoeBinConfig("nyu", 64, 1e-3, 10.0),
        ZoeBinConfig("kitti", 64, 1e-3, 80.0),
    )
    patch_transformer_layers: int = 4
    patch_transformer_hidden: int = 128
    patch_transformer_heads: int = 4
    patch_transformer_intermediate: int = 1024

    @property
    def multi_head(self) -> bool:
        return len(self.bin_configurations) > 1


#: the JAX package's small preset (the published router's 4 layers and
#: 128-wide classifier kept: the transformers forward hardcodes them)
ZOE_TINY = ZoeDepthConfig(
    hidden_size=64, num_layers=4, num_heads=4, intermediate_size=128,
    pretrain_window=4, out_layers=(1, 2, 3, 4),
    neck_hidden_sizes=(16, 24, 32, 32), fusion_hidden_size=32,
    num_relative_features=8, bottleneck_features=32, bin_embedding_dim=16,
    num_attractors=(4, 2, 2, 1),
    bin_configurations=(ZoeBinConfig("nyu", 8, 1e-3, 10.0),
                        ZoeBinConfig("kitti", 8, 1e-3, 80.0)),
    patch_transformer_layers=4, patch_transformer_hidden=128,
    patch_transformer_heads=2, patch_transformer_intermediate=32,
)

_L = "backbone.encoder.layer"
_RE = "neck.reassemble_stage"
_FUS = "neck.fusion_stage.layers"
_MH = "metric_head"
_PT = "metric_head.patch_transformer"


def _bin_keys(cfg: ZoeDepthConfig, name: str):
    if cfg.multi_head:
        return (f"{_MH}.seed_bin_regressors.{name}",
                f"{_MH}.attractors.{name}",
                f"{_MH}.conditional_log_binomial.{name}")
    return (f"{_MH}.seed_bin_regressor", f"{_MH}.attractors",
            f"{_MH}.conditional_log_binomial")


def random_state_dict(cfg: ZoeDepthConfig = ZoeDepthConfig(), seed: int = 0
                      ) -> Dict[str, np.ndarray]:
    d = N.Draw(seed)
    c, w = cfg.hidden_size, cfg.pretrain_window
    d.array("backbone.embeddings.cls_token", (1, 1, c), 0.02)
    d.conv("backbone.embeddings.patch_embeddings.projection", c, 3,
           cfg.patch_size)
    for i in range(cfg.num_layers):
        b, a = f"{_L}.{i}", f"{_L}.{i}.attention.attention"
        d.norm(f"{b}.layernorm_before", c)
        d.linear(f"{a}.query", c, c)
        d.linear(f"{a}.key", c, c, bias=False)
        d.linear(f"{a}.value", c, c)
        d.array(f"{a}.relative_position_bias.relative_position_bias_table",
                ((2 * w - 1) ** 2 + 3, cfg.num_heads), 0.02)
        d.linear(f"{b}.attention.output.dense", c, c)
        d.array(f"{b}.lambda_1", (c,), cfg.layer_scale_init)
        d.array(f"{b}.lambda_2", (c,), cfg.layer_scale_init)
        d.norm(f"{b}.layernorm_after", c)
        d.linear(f"{b}.intermediate.dense", cfg.intermediate_size, c)
        d.linear(f"{b}.output.dense", c, cfg.intermediate_size)
    f = cfg.fusion_hidden_size
    for i, (nh, factor) in enumerate(zip(cfg.neck_hidden_sizes,
                                         cfg.reassemble_factors)):
        d.linear(f"{_RE}.readout_projects.{i}.0", c, 2 * c)
        d.conv(f"{_RE}.layers.{i}.projection", nh, c, 1)
        if factor > 1:
            d.conv_transpose(f"{_RE}.layers.{i}.resize", nh, nh,
                             int(factor))
        elif factor < 1:
            d.conv(f"{_RE}.layers.{i}.resize", nh, nh, 3)
        d.conv(f"neck.convs.{i}", f, nh, 3, bias=False)
        d.conv(f"{_FUS}.{i}.projection", f, f, 1)
        for r in (1, 2):
            for j in (1, 2):
                d.conv(f"{_FUS}.{i}.residual_layer{r}.convolution{j}", f, f,
                       3)
    nrf = cfg.num_relative_features
    d.conv("relative_head.conv1", f // 2, f, 3)
    d.conv("relative_head.conv2", nrf, f // 2, 3)
    d.conv("relative_head.conv3", 1, nrf, 1)
    multi, be, bf = cfg.multi_head, cfg.bin_embedding_dim, \
        cfg.bottleneck_features
    mlp_dim = be // 2 if multi else 256
    proj_dim = be // 2 if multi else 128
    last_in = nrf + (0 if multi else 1)
    clb_hidden = (last_in + be) // 4 if multi else (last_in + be) // 2
    d.conv(f"{_MH}.conv2", bf, bf, 1)
    d.conv(f"{_MH}.seed_projector.conv1", proj_dim, bf, 1)
    d.conv(f"{_MH}.seed_projector.conv2", be, proj_dim, 1)
    for i in range(len(cfg.num_attractors)):
        d.conv(f"{_MH}.projectors.{i}.conv1", proj_dim, f, 1)
        d.conv(f"{_MH}.projectors.{i}.conv2", be, proj_dim, 1)
    for bc in cfg.bin_configurations:
        seed_k, attr_k, clb_k = _bin_keys(cfg, bc.name)
        d.conv(f"{seed_k}.conv1", mlp_dim, bf, 1)
        d.conv(f"{seed_k}.conv2", bc.n_bins, mlp_dim, 1)
        for i, n_att in enumerate(cfg.num_attractors):
            d.conv(f"{attr_k}.{i}.conv1", be, be, 1)
            d.conv(f"{attr_k}.{i}.conv2", n_att, be, 1)
        d.conv(f"{clb_k}.mlp.0", clb_hidden, last_in + be, 1)
        d.conv(f"{clb_k}.mlp.2", 4, clb_hidden, 1)
    if multi:
        pc = cfg.patch_transformer_hidden
        d.conv(f"{_PT}.embedding_convPxP", pc, bf, 1)
        for i in range(cfg.patch_transformer_layers):
            t = f"{_PT}.transformer_encoder.{i}"
            for n in ("query", "key", "value", "out_proj"):
                d.linear(f"{t}.self_attn.{n}", pc, pc)
            d.norm(f"{t}.norm1", pc)
            d.norm(f"{t}.norm2", pc)
            d.linear(f"{t}.linear1", cfg.patch_transformer_intermediate, pc)
            d.linear(f"{t}.linear2", pc, cfg.patch_transformer_intermediate)
        d.linear(f"{_MH}.mlp_classifier.linear1", pc, pc)
        d.linear(f"{_MH}.mlp_classifier.linear2", 2, pc)
    return d.sd


def convert_zoedepth(sd, cfg: ZoeDepthConfig = ZoeDepthConfig(),
                     device=None) -> Dict[str, torch.Tensor]:
    """``sd``: the transformers ZoeDepth layout -> its tensors in fp32 on
    ``device``, each 1x1 conv as its (out, in) linear weight."""
    p = N.tensors(sd, device)
    for k, v in list(p.items()):
        if k.endswith(".weight") and v.dim() == 4 and v.shape[-2:] == (1, 1) \
                and not k.startswith("backbone"):
            p[k] = v[:, :, 0, 0]
    return p


def _ln(p, name, x, eps=1e-12):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"],
                        p[f"{name}.bias"], eps)


def _conv3(p, name, x, stride=1):
    """NHWC conv, symmetric (k - 1) / 2 padding."""
    return N.nhwc(N.conv_named(p, name, N.nchw(x), stride=stride))


def _rel_position_index(window: Tuple[int, int]) -> np.ndarray:
    """transformers ``generate_relative_position_index`` (numpy)."""
    wh, ww = window
    num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    area = wh * ww
    index = np.zeros((area + 1, area + 1), np.int64)
    index[1:, 1:] = rel.sum(-1)
    index[0, :] = num_rel - 3
    index[:, 0] = num_rel - 2
    index[0, 0] = num_rel - 1
    return index


def _rel_position_bias(table, pretrain_window: int,
                       window: Tuple[int, int]) -> torch.Tensor:
    """The table (and its 3 special rows) -> the (heads, N+1, N+1) bias of
    ``window``, the sub-table resized bilinearly (antialiased, as
    ``jax.image.resize``) when the window differs from the pretrained
    one."""
    old = 2 * pretrain_window - 1
    new_h, new_w = 2 * window[0] - 1, 2 * window[1] - 1
    heads = table.shape[-1]
    sub = table[: old * old]
    if (new_h, new_w) != (old, old):
        sub = resize(sub.reshape(1, old, old, heads),
                     (1, new_h, new_w, heads), "linear")
    full = torch.cat([sub.reshape(new_h * new_w, heads), table[old * old:]])
    index = torch.from_numpy(_rel_position_index(window)).to(table.device)
    return full[index.reshape(-1)].reshape(index.shape + (heads,)) \
        .permute(2, 0, 1)


def _backbone(p, cfg: ZoeDepthConfig, pixels: torch.Tensor):
    b, h, w, _ = pixels.shape
    ph, pw = h // cfg.patch_size, w // cfg.patch_size
    c, heads = cfg.hidden_size, cfg.num_heads
    x = N.conv_named(p, "backbone.embeddings.patch_embeddings.projection",
                     N.nchw(pixels.float()), stride=cfg.patch_size,
                     padding=0)
    x = x.flatten(2).transpose(1, 2)
    cls = p["backbone.embeddings.cls_token"].reshape(1, 1, c).expand(b, 1, c)
    x = torch.cat([cls, x], dim=1)
    taps = []
    for i in range(cfg.num_layers):
        pre, a = f"{_L}.{i}", f"{_L}.{i}.attention.attention"
        bias = _rel_position_bias(
            p[f"{a}.relative_position_bias.relative_position_bias_table"],
            cfg.pretrain_window, (ph, pw))
        hn = _ln(p, f"{pre}.layernorm_before", x)
        q, k, v = (N.lin(p, f"{a}.{n}", hn).reshape(b, -1, heads, c // heads)
                   .transpose(1, 2) for n in ("query", "key", "value"))
        att = F.scaled_dot_product_attention(q, k, v, attn_mask=bias[None])
        att = N.lin(p, f"{pre}.attention.output.dense",
                    att.transpose(1, 2).reshape(b, -1, c))
        x = x + att * p[f"{pre}.lambda_1"]
        y = _ln(p, f"{pre}.layernorm_after", x)
        y = N.lin(p, f"{pre}.output.dense", F.gelu(
            N.lin(p, f"{pre}.intermediate.dense", y)))
        x = x + y * p[f"{pre}.lambda_2"]
        if i + 1 in cfg.out_layers:
            taps.append(x)
    return taps, (ph, pw)


def _reassemble(p, cfg: ZoeDepthConfig, taps, grid):
    ph, pw = grid
    out = []
    for i, (tap, factor) in enumerate(zip(taps, cfg.reassemble_factors)):
        tokens = tap[:, 1:]
        readout = tap[:, :1].expand(tokens.shape)
        fm = F.gelu(N.lin(p, f"{_RE}.readout_projects.{i}.0",
                          torch.cat([tokens, readout], dim=-1)))
        fm = fm.reshape(tap.shape[0], ph, pw, cfg.hidden_size)
        fm = N.lin(p, f"{_RE}.layers.{i}.projection", fm)
        if factor > 1:
            fm = N.nhwc(F.conv_transpose2d(
                N.nchw(fm), p[f"{_RE}.layers.{i}.resize.weight"],
                p[f"{_RE}.layers.{i}.resize.bias"], stride=int(factor)))
        elif factor < 1:
            fm = _conv3(p, f"{_RE}.layers.{i}.resize", fm,
                        stride=int(round(1 / factor)))
        out.append(fm)
    return out


def _preact(p, pre, x):
    y = _conv3(p, f"{pre}.convolution1", F.relu(x))
    return x + _conv3(p, f"{pre}.convolution2", F.relu(y))


def _fusion(p, feats):
    fused, out = None, []
    for i, feat in enumerate(feats[::-1]):
        if fused is None:
            fused = feat
        else:
            res = feat
            if res.shape[1:3] != fused.shape[1:3]:
                res = resize(res, (res.shape[0], fused.shape[1],
                                   fused.shape[2], res.shape[3]), "linear")
            fused = fused + _preact(p, f"{_FUS}.{i}.residual_layer1", res)
        fused = _preact(p, f"{_FUS}.{i}.residual_layer2", fused)
        fused = _resize_ac(fused, fused.shape[1] * 2, fused.shape[2] * 2)
        fused = N.lin(p, f"{_FUS}.{i}.projection", fused)
        out.append(fused)
    return out


def _mlp2(p, pre, x, act=F.relu):
    return N.lin(p, f"{pre}.conv2", act(N.lin(p, f"{pre}.conv1", x)))


def _inv_attractor(dx, alpha=300.0, gamma=2):
    # the transformers forward never passes the config's alpha/gamma, so
    # the released checkpoints run with these defaults
    return dx / (1.0 + alpha * dx ** gamma)


def _attractor(p, pre, x, prev_bin, prev_emb):
    if prev_emb is not None:
        x = x + _resize_ac(prev_emb, x.shape[1], x.shape[2])
    att = F.softplus(_mlp2(p, pre, x))
    centers = _resize_ac(prev_bin, x.shape[1], x.shape[2])
    delta = _inv_attractor(att[..., :, None] - centers[..., None, :])
    return centers + delta.mean(dim=-2)


def _log_binomial(probs, temperature, n_classes):
    """LogBinomialSoftmax over the last axis; the Stirling row computed on
    the host in float32, as the JAX package computes it."""
    eps = 1e-4
    e = np.float32(1e-7)
    k_idx = np.arange(n_classes, dtype=np.float32)
    n = np.float32(n_classes - 1) + e
    k = k_idx + e
    row = (n * np.log(n) - k * np.log(k)
           - (n - k) * np.log(np.maximum(n - k, 0) + e))
    dev = probs.device
    k_t = torch.from_numpy(k_idx).to(dev)
    p = torch.clamp(probs, eps, 1.0)[..., None]
    omp = torch.clamp(1.0 - probs, eps, 1.0)[..., None]
    y = (torch.from_numpy(row).to(dev) + k_t * torch.log(p)
         + (np.float32(n_classes - 1) - k_t) * torch.log(omp))
    return torch.softmax(y / temperature[..., None], dim=-1)


def _clb(p, pre, cfg, main, condition, n_bins):
    x = torch.cat([main, condition], dim=-1)
    pt = F.softplus(N.lin(p, f"{pre}.mlp.2", F.gelu(
        N.lin(p, f"{pre}.mlp.0", x)))) + 1e-4
    prob = pt[..., 0] / (pt[..., 0] + pt[..., 1])
    temp = pt[..., 2] / (pt[..., 2] + pt[..., 3])
    temp = (cfg.max_temp - cfg.min_temp) * temp + cfg.min_temp
    return _log_binomial(prob, temp, n_bins)


def _patch_transformer(p, cfg: ZoeDepthConfig, x):
    b, h, w, _ = x.shape
    emb = N.lin(p, f"{_PT}.embedding_convPxP", x).reshape(b, h * w, -1)
    emb = torch.cat([emb.new_zeros((b, 1, emb.shape[-1])), emb], dim=1)
    n, c = emb.shape[1], emb.shape[2]
    position = np.arange(n, dtype=np.float32)[:, None]
    index = np.arange(0, c, 2, dtype=np.float32)[None, :]
    pe = position * np.exp(index * (-math.log(10000.0) / c))
    pe = np.concatenate([np.sin(pe), np.cos(pe)], axis=1)
    emb = emb + torch.from_numpy(pe.astype(np.float32)).to(emb.device)[None]
    heads = cfg.patch_transformer_heads
    d = cfg.patch_transformer_hidden // heads
    for i in range(cfg.patch_transformer_layers):
        t = f"{_PT}.transformer_encoder.{i}"
        q, k, v = (N.lin(p, f"{t}.self_attn.{nm}", emb).reshape(
            b, n, heads, d).transpose(1, 2) for nm in ("query", "key",
                                                       "value"))
        att = F.scaled_dot_product_attention(q, k, v)
        att = N.lin(p, f"{t}.self_attn.out_proj",
                    att.transpose(1, 2).reshape(b, n, -1))
        emb = _ln(p, f"{t}.norm1", emb + att, 1e-5)
        y = N.lin(p, f"{t}.linear2", F.relu(N.lin(p, f"{t}.linear1", emb)))
        emb = _ln(p, f"{t}.norm2", emb + y, 1e-5)
    return emb[:, 0]


def _metric_bins(p, cfg: ZoeDepthConfig, bin_cfg: ZoeBinConfig, bottleneck,
                 fused, last):
    seed_k, attr_k, clb_k = _bin_keys(cfg, bin_cfg.name)
    prev_bin = F.softplus(_mlp2(p, seed_k, bottleneck))
    prev_emb = _mlp2(p, f"{_MH}.seed_projector", bottleneck)
    bin_centers, bin_embedding = prev_bin, prev_emb
    for i, feat in enumerate(fused[:len(cfg.num_attractors)]):
        bin_embedding = _mlp2(p, f"{_MH}.projectors.{i}", feat)
        bin_centers = _attractor(p, f"{attr_k}.{i}", bin_embedding,
                                 prev_bin, prev_emb)
        prev_bin, prev_emb = bin_centers, bin_embedding
    bin_centers = _resize_ac(bin_centers, last.shape[1], last.shape[2])
    bin_embedding = _resize_ac(bin_embedding, last.shape[1], last.shape[2])
    probs = _clb(p, clb_k, cfg, last, bin_embedding, bin_cfg.n_bins)
    return torch.sum(probs * bin_centers, dim=-1)


def zoedepth_apply(p, cfg: ZoeDepthConfig, pixels: torch.Tensor):
    """pixels (B, H, W, 3), (x - 0.5) / 0.5, H and W multiples of 32 ->
    (metric depth (B, H, W), the router's domain logits or None)."""
    taps, grid = _backbone(p, cfg, pixels)
    feats = [_conv3(p, f"neck.convs.{i}", f) for i, f in
             enumerate(_reassemble(p, cfg, taps, grid))]
    fused = _fusion(p, feats)
    x = _conv3(p, "relative_head.conv1", fused[-1])
    x = _resize_ac(x, x.shape[1] * 2, x.shape[2] * 2)
    rel_features = F.relu(_conv3(p, "relative_head.conv2", x))
    relative_depth = F.relu(N.lin(p, "relative_head.conv3", rel_features))
    bottleneck = N.lin(p, f"{_MH}.conv2", feats[-1])
    if cfg.multi_head:
        emb = _patch_transformer(p, cfg, bottleneck)
        domain_logits = N.lin(p, f"{_MH}.mlp_classifier.linear2", F.relu(
            N.lin(p, f"{_MH}.mlp_classifier.linear1", emb)))
        idx = torch.argmax(torch.softmax(domain_logits.sum(0), -1))
        depths = [_metric_bins(p, cfg, bc, bottleneck, fused, rel_features)
                  for bc in cfg.bin_configurations]
        return torch.where(idx == 0, depths[0], depths[1]), domain_logits
    rel = _resize_ac(relative_depth, rel_features.shape[1],
                     rel_features.shape[2])
    last = torch.cat([rel_features, rel], dim=-1)
    return _metric_bins(p, cfg, cfg.bin_configurations[0], bottleneck, fused,
                        last), None


def detect_zoedepth(params, image: np.ndarray,
                    cfg: ZoeDepthConfig = ZoeDepthConfig(),
                    target: Tuple[int, int] = (384, 512),
                    flip_aug: bool = True) -> np.ndarray:
    """RGB image -> (H, W, 3) inverted-depth control image in [0, 1] (the
    image resized to ``target`` rounded to multiples of 32; 2 / 85
    percentile normalization); with ``flip_aug`` the mirrored image's
    depth is averaged in."""
    img = np.asarray(image, np.float32)
    if img.max() > 1.0:
        img = img / 255.0
    h, w = img.shape[:2]
    th = max(32, int(round(target[0] / 32)) * 32)
    tw = max(32, int(round(target[1] / 32)) * 32)
    x = resize(N.host_image(img, N.param_device(params))[0], (th, tw, 3),
               "linear")
    x = ((x - 0.5) / 0.5)[None]
    d, _ = zoedepth_apply(params, cfg, x)
    if flip_aug:
        d2, _ = zoedepth_apply(params, cfg, x.flip(2))
        d = 0.5 * (d + d2.flip(2))
    depth = resize(d[0], (h, w), "linear").cpu().numpy()
    vmin, vmax = np.percentile(depth, 2), np.percentile(depth, 85)
    depth = (depth - vmin) / max(vmax - vmin, 1e-8)
    return np.stack([(1.0 - depth).clip(0.0, 1.0)] * 3, -1)
