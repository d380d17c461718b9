"""UNet2DCondition for the SD1.x/2.x family (port of ``models/unet.py``).

The main path of the JAX package's ``unet_apply``: time embedding, the fused
per-resnet time projections, resnets on the ``conv_impl`` branch the caller
names ("xla": plain convs; "xla_bf16": plain convs with their output
rounded to the compute dtype before the bias; "pallas"/"pallas2": the fused
GN+SiLU+conv kernels K4/K5, see ``layers.resnet_fused``), transformers with
self-attention, region-biased or plain cross-attention and a GEGLU
feed-forward, down/up sampling and skips.
Activations are NHWC; attention operands are (B, L, H, D).

``attn_impl`` takes the JAX package's kernel strings,
``"pallas[+qkbf16][+pvbf16][+exp2]"``: attention always goes through the
hand-written kernels of ``ops/kernels`` (their plain versions on CPU
tensors). Any other value raises; there is no plain attention path for
CUDA tensors.

The SD1.x (conv projections, quick_gelu CLIP) and SD2.x (linear
projections, 64-wide heads) topologies and the 9-channel inpaint UNet
(``in_channels=9``) run here, with ControlNet and T2I-Adapter residuals
added where the JAX package adds them, and IP-Adapter's decoupled
cross-attention where a cross-attention carries ``"ip"`` weights
(``UNetCond``; ``models/ip_adapter.py`` installs them).

The opt-in taps of the JAX package run here too: FreeU at the first two up
blocks, DAAM heatmaps (the cross-attentions' probabilities), TGATE's
collect / frozen cross-attention outputs, and DeepCache's deep/shallow split
(``unet_apply_deepcache``). The JAX package's ``axis_name`` (the std
inside ``shard_map``) is ``mesh`` here: on a data-parallel mesh
(``parallel.mesh.Mesh``) every region-mapped cross-attention all-reduces its
std's moments over the ranks, so the std stays global over the whole batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import UNetConfig
from ..ops.attention import attention_probs
from ..ops.kernels.flash_attention import flash_attention_nlhd
from ..ops.kernels.region_attention import region_attention_nlhd
from ..ops.resize import resize
from .layers import (
    FUSED_CONV_IMPLS,
    check_conv_impl,
    conv2d,
    conv_init,
    group_norm,
    layer_norm,
    linear,
    linear_init,
    norm_init,
    resnet_fused,
    silu,
    timestep_embedding,
    upsample_nearest2x,
)


@dataclasses.dataclass
class RegionState:
    """Region-bias tensors per resolution level plus the current noise sigma
    (a 0-d tensor). ``biases[i]`` is (B, H/8/2^i * W/8/2^i, S_text)."""

    biases: Tuple[torch.Tensor, ...]
    sigma: torch.Tensor


@dataclasses.dataclass
class UNetCond:
    """Conditioning of one UNet forward."""

    context: torch.Tensor  # (B, S, cross_dim) text embeddings
    region: Optional[RegionState] = None
    # ControlNet: one residual a skip (12 for SD1.5, conv_in's included)
    # and one for the mid block, NHWC, already scaled.
    controlnet_down: Optional[Tuple[torch.Tensor, ...]] = None
    controlnet_mid: Optional[torch.Tensor] = None
    # T2I-Adapter: one residual a down block, NHWC.
    t2i_residuals: Optional[Tuple[torch.Tensor, ...]] = None
    # IP-Adapter: (B, n_tokens, cross_dim) image tokens a adapter, each
    # adapter's scale (a Python float) and optional (B, Hm, Wm) fp32 gate.
    ip_tokens: Optional[Tuple[torch.Tensor, ...]] = None
    ip_scales: Optional[Tuple[float, ...]] = None
    ip_masks: Optional[Tuple[Optional[torch.Tensor], ...]] = None
    # The gates downsampled to each sequence length, keyed by (adapter,
    # length): a request's denoiser passes one dict to every call, so each
    # is computed once a request (the masks do not change between steps).
    ip_mask_cache: Dict[Tuple[int, int], torch.Tensor] = dataclasses.field(
        default_factory=dict)


# ---------------------------------------------------------------------------
# Init (same tree, names and per-tensor shapes as the JAX package, in the
# port's layouts: see layers.py)
# ---------------------------------------------------------------------------


def _resnet_init(g, in_c, out_c, temb_dim, dtype, device):
    p = {
        "norm1": norm_init(in_c, dtype, device),
        "conv1": conv_init(g, in_c, out_c, 3, dtype, device),
        "time_emb_proj": linear_init(g, temb_dim, out_c, dtype=dtype,
                                     device=device),
        "norm2": norm_init(out_c, dtype, device),
        "conv2": conv_init(g, out_c, out_c, 3, dtype, device),
    }
    if in_c != out_c:
        p["conv_shortcut"] = conv_init(g, in_c, out_c, 1, dtype, device)
    return p


def _attention_init(g, query_dim, context_dim, dtype, device):
    def lin(i, o, bias):
        return linear_init(g, i, o, bias=bias, dtype=dtype, device=device)

    return {"to_q": lin(query_dim, query_dim, False),
            "to_k": lin(context_dim, query_dim, False),
            "to_v": lin(context_dim, query_dim, False),
            "to_out": lin(query_dim, query_dim, True)}


def _transformer_init(g, cfg: UNetConfig, channels, dtype, device):
    if cfg.use_linear_projection:
        proj_in = linear_init(g, channels, channels, dtype=dtype,
                              device=device)
        proj_out = linear_init(g, channels, channels, dtype=dtype,
                               device=device)
    else:
        proj_in = conv_init(g, channels, channels, 1, dtype, device)
        proj_out = conv_init(g, channels, channels, 1, dtype, device)
    blocks = []
    for _ in range(cfg.transformer_layers_per_block):
        blocks.append({
            "norm1": norm_init(channels, dtype, device),
            "attn1": _attention_init(g, channels, channels, dtype, device),
            "norm2": norm_init(channels, dtype, device),
            "attn2": _attention_init(g, channels, cfg.cross_attention_dim,
                                     dtype, device),
            "norm3": norm_init(channels, dtype, device),
            "ff": {  # GEGLU
                "proj_in": linear_init(g, channels, channels * 8,
                                       dtype=dtype, device=device),
                "proj_out": linear_init(g, channels * 4, channels,
                                        dtype=dtype, device=device),
            },
        })
    return {"norm": norm_init(channels, dtype, device), "proj_in": proj_in,
            "blocks": blocks, "proj_out": proj_out}


def _up_skip_channels(cfg: UNetConfig, level: int) -> List[int]:
    """Channels of the skips consumed by up-block ``level``, in consumption
    order (LIFO from the down path)."""
    stack: List[int] = [cfg.block_out_channels[0]]
    for lv, out_c in enumerate(cfg.block_out_channels):
        stack.extend([out_c] * cfg.layers_per_block)
        if lv < cfg.num_levels - 1:
            stack.append(out_c)
    n_before = (cfg.num_levels - 1 - level) * (cfg.layers_per_block + 1)
    start = len(stack) - n_before - (cfg.layers_per_block + 1)
    return list(reversed(stack[start: start + cfg.layers_per_block + 1]))


def unet_init(g: torch.Generator, cfg: UNetConfig, dtype=torch.bfloat16,
              device=None) -> Dict[str, Any]:
    temb_dim = cfg.time_embed_dim
    b0 = cfg.block_out_channels[0]
    params: Dict[str, Any] = {
        "conv_in": conv_init(g, cfg.in_channels, b0, 3, dtype, device),
        "time_embedding": {
            "linear_1": linear_init(g, b0, temb_dim, dtype=dtype,
                                    device=device),
            "linear_2": linear_init(g, temb_dim, temb_dim, dtype=dtype,
                                    device=device),
        },
    }
    down = []
    in_c = b0
    for level, out_c in enumerate(cfg.block_out_channels):
        block = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block):
            block["resnets"].append(_resnet_init(
                g, in_c if j == 0 else out_c, out_c, temb_dim, dtype, device))
            if cfg.attn_levels[level]:
                block["attentions"].append(
                    _transformer_init(g, cfg, out_c, dtype, device))
        if level < cfg.num_levels - 1:
            block["downsample"] = conv_init(g, out_c, out_c, 3, dtype, device)
        down.append(block)
        in_c = out_c
    params["down_blocks"] = down

    mid_c = cfg.block_out_channels[-1]
    params["mid_block"] = {
        "resnet1": _resnet_init(g, mid_c, mid_c, temb_dim, dtype, device),
        "attention": _transformer_init(g, cfg, mid_c, dtype, device),
        "resnet2": _resnet_init(g, mid_c, mid_c, temb_dim, dtype, device),
    }

    up = []
    rev_channels = list(reversed(cfg.block_out_channels))
    for i, out_c in enumerate(rev_channels):
        level = cfg.num_levels - 1 - i
        prev_c = rev_channels[max(i - 1, 0)]
        skip_cs = _up_skip_channels(cfg, level)
        block = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block + 1):
            res_in = prev_c if j == 0 else out_c
            block["resnets"].append(_resnet_init(
                g, res_in + skip_cs[j], out_c, temb_dim, dtype, device))
            if cfg.attn_levels[level]:
                block["attentions"].append(
                    _transformer_init(g, cfg, out_c, dtype, device))
        if i < cfg.num_levels - 1:
            block["upsample"] = conv_init(g, out_c, out_c, 3, dtype, device)
        up.append(block)
    params["up_blocks"] = up

    params["conv_norm_out"] = norm_init(b0, dtype, device)
    params["conv_out"] = conv_init(g, b0, cfg.out_channels, 3, dtype, device)
    return params


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _temb_projections(resnets, temb):
    """Every resnet's ``linear(time_emb_proj, silu(temb))`` as ONE GEMM over
    the concatenated kernels, sliced back per resnet (the same math batched
    on N)."""
    kernels = [r["time_emb_proj"]["kernel"] for r in resnets]
    fused = {"kernel": torch.cat(kernels, dim=0),
             "bias": torch.cat([r["time_emb_proj"]["bias"] for r in resnets])}
    t_all = linear(fused, silu(temb))
    return list(torch.split(t_all, [k.shape[0] for k in kernels], dim=1))


def _resnet_apply(p, x, groups, eps, t, conv_impl="xla"):
    if conv_impl in FUSED_CONV_IMPLS:
        return resnet_fused(p, x, groups, eps, conv_impl, t)
    rnd = conv_impl == "xla_bf16"
    h = silu(group_norm(p["norm1"], x, groups, eps))
    h = conv2d(p["conv1"], h, round_before_bias=rnd)
    h = h + t[:, None, None, :].to(h.dtype)
    h = silu(group_norm(p["norm2"], h, groups, eps))
    h = conv2d(p["conv2"], h, round_before_bias=rnd)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding="VALID",
                   round_before_bias=rnd)
    return x + h


def _heads_split(x, heads):
    """(B, L, H*D) -> (B, L, H, D): a view, no copy."""
    b, l, d = x.shape
    return x.reshape(b, l, heads, d // heads)


def _heads_merge(x):
    b, l, h, d = x.shape
    return x.reshape(b, l, h * d)


def flash_options(attn_impl: str) -> dict:
    """K2's options from ``attn_impl="pallas[+qkbf16][+pvbf16][+exp2]"``.

    ``+qkbf16`` is accepted and selects nothing: in the Pallas kernel it only
    skips the cast of Q and K to fp32 before an fp32-accumulated QK^T, and
    K2 and its plain version always form QK^T in fp32 from the operands' own
    values."""
    base, *suffixes = attn_impl.split("+")
    unknown = set(suffixes) - {"qkbf16", "pvbf16", "exp2"}
    if base != "pallas" or unknown:
        raise ValueError(
            f"attn_impl={attn_impl!r}: the port takes "
            f"'pallas[+qkbf16][+pvbf16][+exp2]' (attention runs only "
            f"through its kernels)")
    return {"pv_bf16": "pvbf16" in suffixes, "use_exp2": "exp2" in suffixes}


def _self_attention(p, x, heads, flash_opts):
    q = _heads_split(linear(p["to_q"], x), heads)
    k = _heads_split(linear(p["to_k"], x), heads)
    v = _heads_split(linear(p["to_v"], x), heads)
    out = flash_attention_nlhd(q, k, v, **flash_opts)
    return linear(p["to_out"], _heads_merge(out))


def _cross_attention(p, x, cond: UNetCond, level: int, heads, flash_opts,
                     heatmaps: Optional[list] = None, mesh=None):
    q = _heads_split(linear(p["to_q"], x), heads)
    k = _heads_split(linear(p["to_k"], cond.context), heads)
    v = _heads_split(linear(p["to_v"], cond.context), heads)
    if cond.region is not None:
        out = region_attention_nlhd(q, k, v, cond.region.biases[level],
                                    cond.region.sigma, mesh=mesh)
    else:
        out = flash_attention_nlhd(q, k, v, **flash_opts)
    if heatmaps is not None:
        region = cond.region
        probs = attention_probs(
            q.transpose(1, 2), k.transpose(1, 2),
            None if region is None else region.biases[level],
            None if region is None else region.sigma)
        heatmaps.append((level, probs.sum(dim=1)))  # (B, L, S)
    out_h = _heads_merge(out)
    # IP-Adapter's decoupled attention: the queries attend to each
    # adapter's image tokens on their own, the result gated by the
    # adapter's mask and added at its scale.
    if cond.ip_tokens is not None and "ip" in p:
        for i, (ip_tok, ip_p) in enumerate(zip(cond.ip_tokens, p["ip"])):
            ip_k = _heads_split(linear(ip_p["to_k"], ip_tok), heads)
            ip_v = _heads_split(linear(ip_p["to_v"], ip_tok), heads)
            ip_out = _heads_merge(flash_attention_nlhd(q, ip_k, ip_v,
                                                       **flash_opts))
            scale = 1.0 if cond.ip_scales is None else cond.ip_scales[i]
            if cond.ip_masks is not None and cond.ip_masks[i] is not None:
                mask = _ip_gate(cond, i, x.shape[1])
                ip_out = ip_out * mask[..., None].to(ip_out.dtype)
            out_h = out_h + scale * ip_out
    return linear(p["to_out"], out_h)


def _ip_gate(cond: UNetCond, i: int, seq_len: int) -> torch.Tensor:
    """Adapter ``i``'s mask at ``seq_len``, memoized in
    ``cond.ip_mask_cache``."""
    gate = cond.ip_mask_cache.get((i, seq_len))
    if gate is None:
        gate = cond.ip_mask_cache[(i, seq_len)] = _downsample_mask(
            cond.ip_masks[i], seq_len)
    return gate


def _downsample_mask(mask: torch.Tensor, seq_len: int) -> torch.Tensor:
    """A (B, Hm, Wm) mask as a flattened length-``seq_len`` gate (diffusers'
    ``IPAdapterMaskProcessor.downsample``): an aspect-preserving bilinear
    resize (``jax.image.resize``, antialiased) to h = round(Hm / ratio)
    rows (Python's round, ties to even) and w = seq_len // h columns,
    zero-padded or cut to ``seq_len``; fp32."""
    b, hm, wm = mask.shape
    ratio = (hm * wm / seq_len) ** 0.5
    h = max(int(round(hm / ratio)), 1)
    w = max(seq_len // h, 1)
    m = resize(mask.float(), (b, h, w), "linear").reshape(b, h * w)
    if h * w < seq_len:
        m = F.pad(m, (0, seq_len - h * w))
    return m[:, :seq_len]


def _geglu_ff(p, x):
    val, gate = linear(p["proj_in"], x).chunk(2, dim=-1)
    return linear(p["proj_out"], val * F.gelu(gate, approximate="none"))


@dataclasses.dataclass(frozen=True)
class _Taps:
    """What one UNet call reads from or feeds to its cross-attentions:
    ``heatmaps`` collects (level, (B, L, S) probabilities summed over heads)
    a cross-attention; ``cache`` holds TGATE's frozen outputs, one a
    cross-attention in traversal order, consumed in that order in place of
    the cross-attention (its layer norm included); ``out`` collects every
    cross-attention's output in that order."""

    heatmaps: Optional[list] = None
    cache: Optional[list] = None
    out: Optional[list] = None


_NO_TAPS = _Taps()


def _transformer_apply(p, cfg: UNetConfig, x, cond: UNetCond, level: int,
                       heads, flash_opts, taps: _Taps = _NO_TAPS, mesh=None):
    b, hh, ww, c = x.shape
    residual = x
    h = group_norm(p["norm"], x, cfg.norm_num_groups, 1e-6)
    if cfg.use_linear_projection:
        h = linear(p["proj_in"], h.reshape(b, hh * ww, c))
    else:
        h = conv2d(p["proj_in"], h, padding="VALID").reshape(b, hh * ww, c)

    for bp in p["blocks"]:
        h = h + _self_attention(bp["attn1"], layer_norm(bp["norm1"], h),
                                heads, flash_opts)
        if taps.cache is not None:
            xo = taps.cache.pop(0)
        else:
            xo = _cross_attention(bp["attn2"], layer_norm(bp["norm2"], h),
                                  cond, level, heads, flash_opts,
                                  taps.heatmaps, mesh)
        if taps.out is not None:
            taps.out.append(xo)
        h = h + xo.to(h.dtype)
        h = h + _geglu_ff(bp["ff"], layer_norm(bp["norm3"], h))

    if cfg.use_linear_projection:
        h = linear(p["proj_out"], h).reshape(b, hh, ww, c)
    else:
        h = conv2d(p["proj_out"], h.reshape(b, hh, ww, c), padding="VALID")
    return h + residual


@dataclasses.dataclass(frozen=True)
class FreeUParams:
    """FreeU's backbone (b) and skip (s) scales at the first two up blocks
    (diffusers' ``enable_freeu``); SD1.5's recommended values."""

    b1: float = 1.5
    b2: float = 1.6
    s1: float = 0.9
    s2: float = 0.2


def _freeu_filter(skip: torch.Tensor, scale: float,
                  threshold: int = 1) -> torch.Tensor:
    """FreeU's Fourier gate on skip features: an fp32 FFT over H and W
    (cuFFT on the card), the low-frequency box of half-width ``threshold``
    around the shifted centre (h // 2, w // 2) scaled by ``scale``, then
    back; the real part in the skip's dtype."""
    h, w = skip.shape[1:3]
    xf = torch.fft.fftshift(torch.fft.fftn(skip.float(), dim=(1, 2)),
                            dim=(1, 2))
    rows = (torch.arange(h, device=skip.device) - h // 2).abs() <= threshold
    cols = (torch.arange(w, device=skip.device) - w // 2).abs() <= threshold
    box = (rows[:, None] & cols[None, :])[None, :, :, None]
    xf = torch.where(box, xf * scale, xf)
    xf = torch.fft.ifftshift(xf, dim=(1, 2))
    return torch.fft.ifftn(xf, dim=(1, 2)).real.to(skip.dtype)


def _freeu_scales(freeu: Optional[FreeUParams], i: int):
    """(b, s) of up block ``i``, or None where FreeU does not act."""
    if freeu is None or i not in (0, 1):
        return None
    return (freeu.b1, freeu.s1) if i == 0 else (freeu.b2, freeu.s2)


class _Run:
    """The state one UNet call threads through its blocks: the weights and
    options, the time projections in the order the resnets run, the skip
    stack, the taps and the mesh."""

    def __init__(self, cfg, cond, resnets, temb, conv_impl, flash_opts,
                 taps=_NO_TAPS, mesh=None):
        self.cfg, self.cond, self.taps, self.mesh = cfg, cond, taps, mesh
        self.conv_impl, self.flash_opts = conv_impl, flash_opts
        self.t_it = iter(_temb_projections(resnets, temb))
        self.skips: List[torch.Tensor] = []

    def resnet(self, p, h):
        return _resnet_apply(p, h, self.cfg.norm_num_groups,
                             self.cfg.norm_eps, next(self.t_it),
                             self.conv_impl)

    def transformer(self, p, h, level):
        return _transformer_apply(p, self.cfg, h, self.cond, level,
                                  self.cfg.heads_at(level), self.flash_opts,
                                  self.taps, self.mesh)

    def down_block(self, block, h, level, t2i=None, downsample=True):
        """A down block's layers, each output pushed on the skip stack; the
        block's T2I residual after its last layer, then its downsample."""
        n_res = len(block["resnets"])
        for j in range(n_res):
            h = self.resnet(block["resnets"][j], h)
            if block["attentions"]:
                h = self.transformer(block["attentions"][j], h, level)
            if j == n_res - 1 and t2i:
                h = h + t2i.pop(0).to(h.dtype)
            self.skips.append(h)
        if downsample and "downsample" in block:
            h = conv2d(block["downsample"], h, stride=2)
            self.skips.append(h)
        return h

    def mid_block(self, mid, h):
        top = self.cfg.num_levels - 1
        h = self.resnet(mid["resnet1"], h)
        h = self.transformer(mid["attention"], h, top)
        return self.resnet(mid["resnet2"], h)

    def up_block(self, block, h, level, freeu_scales=None):
        """An up block: each layer takes a skip from the stack (with FreeU,
        the first half of h's channels scaled by b and the skip filtered at
        s), then the upsample."""
        for j in range(len(block["resnets"])):
            skip = self.skips.pop()
            if freeu_scales is not None:
                b_scale, s_scale = freeu_scales
                c_half = h.shape[-1] // 2
                h = torch.cat([h[..., :c_half] * b_scale, h[..., c_half:]],
                              dim=-1)
                skip = _freeu_filter(skip, s_scale)
            h = self.resnet(block["resnets"][j], torch.cat([h, skip], dim=-1))
            if block["attentions"]:
                h = self.transformer(block["attentions"][j], h, level)
        if "upsample" in block:
            h = conv2d(block["upsample"], upsample_nearest2x(h))
        return h


def _time_embedding(params, cfg: UNetConfig, sample, timesteps):
    temb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                              cfg.flip_sin_to_cos, cfg.freq_shift)
    temb = linear(params["time_embedding"]["linear_1"],
                  temb.to(sample.dtype))
    return linear(params["time_embedding"]["linear_2"], silu(temb))


def _conv_out(params, cfg: UNetConfig, h):
    h = silu(group_norm(params["conv_norm_out"], h, cfg.norm_num_groups,
                        cfg.norm_eps))
    return conv2d(params["conv_out"], h)


def _all_resnets(params):
    """Every resnet in traversal order: down, mid, up."""
    out = [r for blk in params["down_blocks"] for r in blk["resnets"]]
    out += [params["mid_block"]["resnet1"], params["mid_block"]["resnet2"]]
    return out + [r for blk in params["up_blocks"] for r in blk["resnets"]]


def unet_apply(params: Dict[str, Any], cfg: UNetConfig,
               sample: torch.Tensor, timesteps: torch.Tensor,
               cond: UNetCond, attn_impl: str = "pallas",
               freeu: Optional[FreeUParams] = None,
               collect_heatmaps: bool = False,
               conv_impl: Optional[str] = None,
               xattn_cache: Optional[Tuple[torch.Tensor, ...]] = None,
               collect_xattn: bool = False, mesh=None):
    """UNet forward: sample (B, H, W, C) NHWC, timesteps (B,) possibly
    fractional. Returns the eps / v prediction (B, H, W, out_channels).

    ``cond``'s T2I residuals are added after the last layer of each down
    block (before its downsample, so the skip carries them), its ControlNet
    residuals to every skip after the down path and after the mid block's
    second resnet, each cast to the activations' dtype at the add. Its
    IP-Adapter tokens go to every cross-attention that carries ``"ip"``
    weights, one decoupled attention (K2) a adapter.

    ``freeu``: FreeU at up blocks 0 and 1 (``_freeu_filter``).
    ``collect_heatmaps``: also return a list of (level, (B, L, S)) softmax
    probabilities of every cross-attention summed over heads
    (``ops.attention.attention_probs``, plain torch; the attention output
    itself still comes from K1/K2), for DAAM. TGATE: ``collect_xattn``
    returns ``(out, outputs)``, the output of every cross-attention call in
    traversal order; ``xattn_cache`` (such a tuple) takes their place and
    skips every cross-attention, its layer norm included, and must hold
    exactly one entry a cross-attention. The three exclude each other.

    ``mesh``: ``sample`` is this rank's shard of a data-parallel batch and
    each region-mapped cross-attention all-reduces its std over the mesh
    (the JAX package's ``axis_name``)."""
    if collect_xattn and (xattn_cache is not None or collect_heatmaps):
        raise ValueError("collect_xattn is exclusive with xattn_cache / "
                         "collect_heatmaps")
    if xattn_cache is not None and collect_heatmaps:
        raise ValueError("heatmap introspection needs live cross-attention "
                         "(xattn_cache skips it)")
    taps = _Taps(heatmaps=[] if collect_heatmaps else None,
                 cache=None if xattn_cache is None else list(xattn_cache),
                 out=[] if collect_xattn else None)
    run = _Run(cfg, cond, _all_resnets(params),
               _time_embedding(params, cfg, sample, timesteps),
               check_conv_impl(conv_impl), flash_options(attn_impl), taps,
               mesh)

    h = conv2d(params["conv_in"], sample)
    run.skips.append(h)
    t2i = list(cond.t2i_residuals or ())
    for level, block in enumerate(params["down_blocks"]):
        h = run.down_block(block, h, level, t2i)
    if cond.controlnet_down is not None:
        run.skips = [s + r.to(s.dtype)
                     for s, r in zip(run.skips, cond.controlnet_down)]
    h = run.mid_block(params["mid_block"], h)
    if cond.controlnet_mid is not None:
        h = h + cond.controlnet_mid.to(h.dtype)
    for i, block in enumerate(params["up_blocks"]):
        h = run.up_block(block, h, cfg.num_levels - 1 - i,
                         _freeu_scales(freeu, i))
    out = _conv_out(params, cfg, h)
    if taps.cache:
        raise ValueError(
            f"xattn_cache has {len(taps.cache)} unconsumed entries — it "
            f"must hold exactly one output per cross-attention call")
    if collect_xattn:
        return out, tuple(taps.out)
    if collect_heatmaps:
        return out, taps.heatmaps
    return out


def deepcache_shape(cfg: UNetConfig, batch: int, lat_h: int,
                    lat_w: int) -> Tuple[int, int, int, int]:
    """Shape of the deep-feature cache: the next-to-last up block's output
    (back at full latent resolution, level-1 channel width)."""
    return (batch, lat_h, lat_w, cfg.block_out_channels[1])


def unet_apply_deepcache(params: Dict[str, Any], cfg: UNetConfig,
                         sample: torch.Tensor, timesteps: torch.Tensor,
                         cond: UNetCond, cache: torch.Tensor, use_cache,
                         attn_impl: str = "pallas",
                         freeu: Optional[FreeUParams] = None,
                         conv_impl: Optional[str] = None, mesh=None):
    """UNet forward with DeepCache's deep/shallow split. Returns
    ``(out, new_cache)``.

    The deep branch is down blocks 1.., the mid block and every up block
    but the last; the shallow layers (conv_in, down block 0, the last up
    block, conv_out) run every call. ``use_cache``: a host-side number
    from the static caching schedule (the JAX package's traced flag of
    ``lax.cond``); above 0.5 the deep branch is skipped and its output is
    ``cache``, which is returned as it is; else the deep branch runs (FreeU
    inside it) and its output is the new cache (``deepcache_shape``). The
    skips keep ``unet_apply``'s bookkeeping, and a full call runs the same
    operations in the same order as ``unet_apply``, so it equals it. The
    time projections are one GEMM over the resnets the call runs.
    ControlNet and T2I residuals inject into the deep branch and are
    rejected. ``mesh`` as in ``unet_apply``."""
    if cond.controlnet_down is not None or cond.t2i_residuals is not None:
        raise ValueError(
            "deepcache does not support ControlNet/T2I-Adapter residuals "
            "(they inject into the cached deep branch)")
    reuse = float(use_cache) > 0.5
    down, up = params["down_blocks"], params["up_blocks"]
    resnets = (down[0]["resnets"] + up[-1]["resnets"] if reuse
               else _all_resnets(params))
    run = _Run(cfg, cond, resnets,
               _time_embedding(params, cfg, sample, timesteps),
               check_conv_impl(conv_impl), flash_options(attn_impl),
               mesh=mesh)

    h = conv2d(params["conv_in"], sample)
    run.skips.append(h)
    h = run.down_block(down[0], h, 0, downsample=not reuse)
    if reuse:
        h = cache
    else:
        for level in range(1, cfg.num_levels):
            h = run.down_block(down[level], h, level)
        h = run.mid_block(params["mid_block"], h)
        for i, block in enumerate(up[:-1]):
            h = run.up_block(block, h, cfg.num_levels - 1 - i,
                             _freeu_scales(freeu, i))
        cache = h
    h = run.up_block(up[-1], h, 0)
    assert not run.skips
    return _conv_out(params, cfg, h), cache
