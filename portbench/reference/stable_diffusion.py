"""Plain PyTorch Stable Diffusion txt2img (SD1.x and SD2.x), the reference
that decides whether a benchmark run is correct.

It reads the weights as the benchmark made them, under the diffusers /
transformers names of the published checkpoints (``unet``, ``vae``,
``text_encoder``), and the sizes from the configuration file's groups of
the same names. It imports nothing of the program under test and takes
nothing the program made: the token ids, the prompt weights, the region
biases and the initial noise are worked out here again from the request.

What it computes, in float32 with TF32 off (``precision="fp32"``):

* the hash tokenizer the program uses where a checkpoint ships no
  ``vocab.json`` (FNV-1a of each lower-cased word modulo 49000, trailing
  commas split off as token 264; bos 49406, eos 49407 = pad), and the
  AUTOMATIC1111 emphasis grammar (a frozen copy of its parser) with one
  75-token chunk wrapped in bos/eos and padded with eos;
* the CLIP text encoder up to the hidden state ``clip_skip`` layers from
  the end, then the final layer norm; the pair [negative, prompt] weighted
  by the emphasis multipliers and its mean restored (A1111);
* the region map: each phrase's token n-gram counted in the prompt's ids,
  each mask resized by an antialiased bicubic filter to every UNet level
  (ratios 8, 16, 32, 64), rounded and set to 1 where it equals its
  maximum, ``weight`` inside and ``-mask_outsides`` outside, contracted
  with the counts; in every cross-attention the bias times sigma times the
  unbiased std of that call's whole logits tensor (both CFG halves) is
  added to the logits before the softmax;
* the UNet2DConditionModel (resnets, transformers with self-attention,
  cross-attention and GEGLU, down/up sampling, skips; the stride-2
  downsample padded as the configuration's ``downsample_padding`` says),
  epsilon or v prediction through the k-diffusion denoiser
  (c_in = 1 / sqrt(sigma^2 + 1), t from log-sigma interpolation), CFG,
  DPM-Solver++(2M) on the Karras schedule (rho 7) of the scaled-linear
  betas, initial latents N(0, 1) times sqrt(sigma_0^2 + 1), the standard
  normals drawn from a CPU ``torch.Generator`` seeded with the request's
  seed plus the image's index, in (h, w, 4) order;
* the VAE decoder and the uint8 conversion floor(clamp(x / 2 + 1/2, 0, 1)
  255 + 1/2).

``precision="fp8"`` is the control: every operand of a matrix product or
convolution (weights, activations, and attention's Q, K, V and
probabilities) is rounded to float8 e4m3 with one scale a tensor (its
largest magnitude over 448), as an fp8 inference path computes them;
norms, softmax and sums stay float32.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BOS, EOS, COMMA = 49406, 49407, 264
CHUNK = 75
LEVEL_RATIOS = (8, 16, 32, 64)
FP8_MAX = 448.0


# ---------------------------------------------------------------------------
# Tokens
# ---------------------------------------------------------------------------


def hash_tokenize(text: str) -> List[int]:
    """Ids of ``text`` without specials: FNV-1a 32 of each word mod 49000,
    each trailing comma its own token."""
    ids: List[int] = []
    for word in re.sub(r"\s+", " ", text).strip().lower().split(" "):
        if not word:
            continue
        n_commas = len(word) - len(word.rstrip(","))
        word = word.rstrip(",")
        if word:
            h = 2166136261
            for ch in word.encode("utf-8"):
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            ids.append(h % 49000)
        ids.extend([COMMA] * n_commas)
    return ids


_RE_ATTENTION = re.compile(r"""
\\\(|\\\)|\\\[|\\]|\\\\|\\|\(|\[|:([+-]?[.\d]+)\)|\)|]|[^\\()\[\]:]+|:
""", re.X)


def parse_prompt_attention(text: str) -> List[List]:
    """AUTOMATIC1111's emphasis grammar: [[text, weight], ...]."""
    res: List[List] = []
    round_br: List[int] = []
    square_br: List[int] = []

    def multiply(start, mult):
        for p in range(start, len(res)):
            res[p][1] *= mult

    for m in _RE_ATTENTION.finditer(text):
        tok, weight = m.group(0), m.group(1)
        if tok.startswith("\\"):
            res.append([tok[1:], 1.0])
        elif tok == "(":
            round_br.append(len(res))
        elif tok == "[":
            square_br.append(len(res))
        elif weight is not None and round_br:
            multiply(round_br.pop(), float(weight))
        elif tok == ")" and round_br:
            multiply(round_br.pop(), 1.1)
        elif tok == "]" and square_br:
            multiply(square_br.pop(), 1 / 1.1)
        else:
            if re.search(r"\bBREAK\b", tok):
                raise ValueError("BREAK: the reference takes one chunk")
            res.append([tok, 1.0])
    for pos in round_br:
        multiply(pos, 1.1)
    for pos in square_br:
        multiply(pos, 1 / 1.1)
    if not res:
        res = [["", 1.0]]
    i = 0
    while i + 1 < len(res):
        if res[i][1] == res[i + 1][1]:
            res[i][0] += res[i + 1][0]
            res.pop(i + 1)
        else:
            i += 1
    return res


def a1111_chunk(text: str) -> Tuple[List[int], List[float]]:
    """(77 ids, 77 multipliers) of a prompt that fits one chunk."""
    ids: List[int] = []
    mults: List[float] = []
    for part, weight in parse_prompt_attention(text):
        toks = hash_tokenize(part)
        ids += toks
        mults += [weight] * len(toks)
    if len(ids) > CHUNK:
        raise ValueError(f"{len(ids)} tokens: the reference takes one chunk")
    pad = CHUNK - len(ids)
    return ([BOS] + ids + [EOS] * (pad + 1),
            [1.0] + mults + [1.0] * (pad + 1))


# ---------------------------------------------------------------------------
# Precision
# ---------------------------------------------------------------------------


class Ops:
    """The reference's arithmetic at one precision over one weight dict
    (name -> tensor in the dtype the benchmark made). Weights are widened to
    float32 once, at first use; under ``fp8`` they are also rounded once."""

    def __init__(self, weights: Dict[str, torch.Tensor],
                 precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.src, self.precision, self._w = weights, precision, {}

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp32":
            return t
        scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def w(self, name: str, quantize: bool = True) -> torch.Tensor:
        key = (name, quantize)
        if key not in self._w:
            t = self.src[name].float()
            self._w[key] = self.q(t) if quantize else t
        return self._w[key]

    def linear(self, x, name, bias=True):
        b = self.w(name + ".bias", False) if bias else None
        return F.linear(self.q(x), self.w(name + ".weight"), b)

    def conv(self, x, name, stride=1, padding=1):
        return F.conv2d(self.q(x), self.w(name + ".weight"),
                        self.w(name + ".bias", False), stride=stride,
                        padding=padding)

    def group_norm(self, x, name, groups, eps):
        return F.group_norm(x, groups, self.w(name + ".weight", False),
                            self.w(name + ".bias", False), eps)

    def layer_norm(self, x, name, eps=1e-5):
        return F.layer_norm(x, (x.shape[-1],), self.w(name + ".weight", False),
                            self.w(name + ".bias", False), eps)

    def bmm(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


def _chunks(n: int, row_bytes: int, budget: int = 1 << 30):
    step = max(1, budget // max(row_bytes, 1))
    return range(0, n, step), step


def attention(ops: Ops, q, k, v, bias=None, sigma=None):
    """softmax(q k^T / sqrt(D) + region term) v on (N, H, L, D) operands;
    the region term is ``bias`` (N, L, S) times sigma times the unbiased std
    of the whole logits tensor. Rows are taken in blocks that fit; on the
    card an unbiased float32 attention runs as PyTorch's memory-efficient
    attention, which keeps float32 throughout and needs no logits in
    memory (L = S = 32640 at 1088 x 1920)."""
    scale = q.shape[-1] ** -0.5
    n, h, l, _ = q.shape
    s = k.shape[2]
    if bias is None and q.is_cuda and ops.precision == "fp32":
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v)
    starts, step = _chunks(l, n * h * s * 4)
    whole = None
    std = None
    if bias is not None:
        # the whole tensor's moments, block by block, in float64
        tot, tot2, cnt = 0.0, 0.0, 0
        for i in starts:
            lg = ops.bmm(q[:, :, i:i + step], k.transpose(-1, -2)) * scale
            if step >= l:
                whole = lg
            lg = lg.double()
            tot += float(lg.sum())
            tot2 += float((lg * lg).sum())
            cnt += lg.numel()
        mean = tot / cnt
        std = math.sqrt(max(tot2 - cnt * mean * mean, 0.0) / (cnt - 1))
    out = torch.empty_like(q)
    for i in starts:
        lg = (whole if whole is not None else
              ops.bmm(q[:, :, i:i + step], k.transpose(-1, -2)) * scale)
        if bias is not None:
            lg = lg + (bias[:, None, i:i + step] * (sigma * std)).float()
        out[:, :, i:i + step] = ops.bmm(torch.softmax(lg, dim=-1), v)
    return out


# ---------------------------------------------------------------------------
# CLIP text encoder
# ---------------------------------------------------------------------------


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    raise ValueError(f"hidden_act {name!r}")


def clip_forward(ops: Ops, cfg: dict, ids: torch.Tensor, clip_skip: int):
    """(N, 77) ids -> (N, 77, hidden): the hidden state ``clip_skip``
    layers from the end, then the final layer norm."""
    p = "text_encoder.text_model."
    heads, eps = cfg["num_attention_heads"], cfg["layer_norm_eps"]
    act = _act(cfg["hidden_act"])
    x = (ops.w(p + "embeddings.token_embedding.weight", False)[ids]
         + ops.w(p + "embeddings.position_embedding.weight", False)
         [None, :ids.shape[1]])
    n, l, d = x.shape
    causal = torch.full((l, l), float("-inf"), device=x.device).triu(1)
    for i in range(cfg["num_hidden_layers"] - (clip_skip - 1)):
        lp = f"{p}encoder.layers.{i}."
        h = ops.layer_norm(x, lp + "layer_norm1", eps)

        def heads_of(t):
            return t.reshape(n, l, heads, d // heads).transpose(1, 2)

        q = heads_of(ops.linear(h, lp + "self_attn.q_proj"))
        k = heads_of(ops.linear(h, lp + "self_attn.k_proj"))
        v = heads_of(ops.linear(h, lp + "self_attn.v_proj"))
        lg = ops.bmm(q, k.transpose(-1, -2)) * (d // heads) ** -0.5 + causal
        a = ops.bmm(torch.softmax(lg, dim=-1), v)
        a = a.transpose(1, 2).reshape(n, l, d)
        x = x + ops.linear(a, lp + "self_attn.out_proj")
        h = ops.layer_norm(x, lp + "layer_norm2", eps)
        x = x + ops.linear(act(ops.linear(h, lp + "mlp.fc1")), lp + "mlp.fc2")
    return ops.layer_norm(x, p + "final_layer_norm", eps)


def encode_prompt(ops: Ops, cfg: dict, prompt: str, negative: str,
                  clip_skip: int, device):
    """(uncond (77, C), cond (77, C), the prompt's 77 ids)."""
    (ids_n, m_n), (ids_p, m_p) = a1111_chunk(negative), a1111_chunk(prompt)
    ids = torch.tensor([ids_n, ids_p], dtype=torch.long, device=device)
    mults = torch.tensor([m_n, m_p], dtype=torch.float32, device=device)
    z = clip_forward(ops, cfg["text_encoder"], ids, clip_skip)
    mean0 = z.mean()
    z = z * mults[..., None]
    z = z * (mean0 / z.mean())
    return z[0], z[1], ids_p


# ---------------------------------------------------------------------------
# Region map
# ---------------------------------------------------------------------------


def region_biases(state: Dict[str, dict], prompt_ids: Sequence[int],
                  height: int, width: int, device) -> List[torch.Tensor]:
    """One (L_r, S) float32 bias a UNet level."""
    phrases = list(state)
    s_len = len(prompt_ids)
    counts = np.zeros((len(phrases), s_len), np.float32)
    for pi, phrase in enumerate(phrases):
        ids = hash_tokenize(phrase)
        for i in range(s_len - len(ids) + 1):
            if ids and list(prompt_ids[i:i + len(ids)]) == ids:
                counts[pi, i:i + len(ids)] += 1.0
    masks = torch.from_numpy(np.stack(
        [np.asarray(state[k]["mask"], np.float32) for k in phrases]))
    weights = torch.tensor([float(state[k]["weight"]) for k in phrases])
    outs = torch.tensor([float(state[k].get("mask_outsides", 0.0))
                         for k in phrases])
    out = []
    for r in LEVEL_RATIOS:
        size = (-(-height // r), -(-width // r))
        m = F.interpolate(masks[None].double(), size=size, mode="bicubic",
                          align_corners=False, antialias=True)[0].float()
        m = torch.round(torch.clamp(m, 0.0, 255.0))
        m = (m == m.amax(dim=(1, 2), keepdim=True)).float()
        pix = (m * weights[:, None, None]
               - (1.0 - m) * outs[:, None, None]).reshape(len(phrases), -1)
        out.append((pix.T @ torch.from_numpy(counts)).to(device))
    return out


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool,
                       shift: float) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - shift))
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


def _heads(cfg: dict, n_levels: int) -> List[int]:
    a = cfg.get("num_attention_heads") or cfg["attention_head_dim"]
    return list(a) if isinstance(a, (list, tuple)) else [a] * n_levels


class UNet:
    """UNet2DConditionModel forward over ``unet.*`` weights (NCHW)."""

    def __init__(self, ops: Ops, cfg: dict):
        self.ops, self.cfg = ops, cfg
        self.levels = len(cfg["block_out_channels"])
        self.heads = _heads(cfg, self.levels)
        self.groups, self.eps = cfg["norm_num_groups"], cfg["norm_eps"]
        self.attn = [t.startswith("CrossAttn")
                     for t in cfg["down_block_types"]]

    def resnet(self, x, temb, p):
        o = self.ops
        h = o.conv(F.silu(o.group_norm(x, p + "norm1", self.groups, self.eps)),
                   p + "conv1")
        h = h + o.linear(F.silu(temb), p + "time_emb_proj")[:, :, None, None]
        h = o.conv(F.silu(o.group_norm(h, p + "norm2", self.groups, self.eps)),
                   p + "conv2")
        if p + "conv_shortcut.weight" in o.src:
            x = o.conv(x, p + "conv_shortcut", padding=0)
        return x + h

    def transformer(self, x, ctx, p, level, region):
        o = self.ops
        n, c, hh, ww = x.shape
        heads = self.heads[level]
        linear_proj = self.cfg.get("use_linear_projection", False)
        h = o.group_norm(x, p + "norm", self.groups, 1e-6)
        if linear_proj:
            h = o.linear(h.permute(0, 2, 3, 1).reshape(n, hh * ww, c),
                         p + "proj_in")
        else:
            h = o.conv(h, p + "proj_in", padding=0)
            h = h.permute(0, 2, 3, 1).reshape(n, hh * ww, c)

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], heads,
                             c // heads).transpose(1, 2)

        def merge(t):
            return t.transpose(1, 2).reshape(n, -1, c)

        for b in range(self.cfg.get("transformer_layers_per_block", 1)):
            bp = f"{p}transformer_blocks.{b}."
            a = o.layer_norm(h, bp + "norm1")
            out = attention(o, split(o.linear(a, bp + "attn1.to_q", False)),
                            split(o.linear(a, bp + "attn1.to_k", False)),
                            split(o.linear(a, bp + "attn1.to_v", False)))
            h = h + o.linear(merge(out), bp + "attn1.to_out.0")
            a = o.layer_norm(h, bp + "norm2")
            bias = sigma = None
            if region is not None:
                bias, sigma = region[0][level], region[1]
            out = attention(o, split(o.linear(a, bp + "attn2.to_q", False)),
                            split(o.linear(ctx, bp + "attn2.to_k", False)),
                            split(o.linear(ctx, bp + "attn2.to_v", False)),
                            bias, sigma)
            h = h + o.linear(merge(out), bp + "attn2.to_out.0")
            a = o.layer_norm(h, bp + "norm3")
            val, gate = o.linear(a, bp + "ff.net.0.proj").chunk(2, dim=-1)
            h = h + o.linear(val * F.gelu(gate, approximate="none"),
                             bp + "ff.net.2")
        if linear_proj:
            h = o.linear(h, p + "proj_out").reshape(n, hh, ww, c)
            h = h.permute(0, 3, 1, 2)
        else:
            h = h.reshape(n, hh, ww, c).permute(0, 3, 1, 2)
            h = o.conv(h, p + "proj_out", padding=0)
        return h + x

    def downsample(self, h, p):
        pad = self.cfg.get("downsample_padding", 1)
        if pad == 0:
            return self.ops.conv(F.pad(h, (0, 1, 0, 1)), p, stride=2,
                                 padding=0)
        return self.ops.conv(h, p, stride=2, padding=pad)

    def __call__(self, x, t, ctx, region=None):
        """x (N, C, h, w) float32, t (N,) fractional timesteps, ctx (N, S,
        cross), region None or (one (N, L, S) bias a level, sigma)."""
        o, cfg = self.ops, self.cfg
        temb = timestep_embedding(t, cfg["block_out_channels"][0],
                                  cfg["flip_sin_to_cos"], cfg["freq_shift"])
        temb = o.linear(F.silu(o.linear(temb, "unet.time_embedding.linear_1")),
                        "unet.time_embedding.linear_2")
        h = o.conv(x, "unet.conv_in")
        skips = [h]
        for lv in range(self.levels):
            p = f"unet.down_blocks.{lv}."
            for j in range(cfg["layers_per_block"]):
                h = self.resnet(h, temb, f"{p}resnets.{j}.")
                if self.attn[lv]:
                    h = self.transformer(h, ctx, f"{p}attentions.{j}.", lv,
                                         region)
                skips.append(h)
            if lv < self.levels - 1:
                h = self.downsample(h, p + "downsamplers.0.conv")
                skips.append(h)
        top = self.levels - 1
        h = self.resnet(h, temb, "unet.mid_block.resnets.0.")
        h = self.transformer(h, ctx, "unet.mid_block.attentions.0.", top,
                             region)
        h = self.resnet(h, temb, "unet.mid_block.resnets.1.")
        for i in range(self.levels):
            lv = top - i
            p = f"unet.up_blocks.{i}."
            for j in range(cfg["layers_per_block"] + 1):
                h = self.resnet(torch.cat([h, skips.pop()], dim=1), temb,
                                f"{p}resnets.{j}.")
                if self.attn[lv]:
                    h = self.transformer(h, ctx, f"{p}attentions.{j}.", lv,
                                         region)
            if i < self.levels - 1:
                h = o.conv(F.interpolate(h, scale_factor=2.0, mode="nearest"),
                           p + "upsamplers.0.conv")
        h = F.silu(o.group_norm(h, "unet.conv_norm_out", self.groups,
                                self.eps))
        return o.conv(h, "unet.conv_out")


# ---------------------------------------------------------------------------
# VAE decoder
# ---------------------------------------------------------------------------


def vae_decode(ops: Ops, cfg: dict, latents: torch.Tensor) -> torch.Tensor:
    """Scaled latents (N, 4, h, w) -> images (N, 3, 8h, 8w) in [-1, 1]."""
    g, eps = cfg["norm_num_groups"], 1e-6
    chans = cfg["block_out_channels"]

    def resnet(x, p):
        h = ops.conv(F.silu(ops.group_norm(x, p + "norm1", g, eps)),
                     p + "conv1")
        h = ops.conv(F.silu(ops.group_norm(h, p + "norm2", g, eps)),
                     p + "conv2")
        if p + "conv_shortcut.weight" in ops.src:
            x = ops.conv(x, p + "conv_shortcut", padding=0)
        return x + h

    def attn(x, p):
        n, c, hh, ww = x.shape
        h = ops.group_norm(x, p + "group_norm", g, eps)
        h = h.reshape(n, c, hh * ww).transpose(1, 2)
        q, k, v = (ops.linear(h, p + name)[:, None]
                   for name in ("to_q", "to_k", "to_v"))
        out = attention(ops, q, k, v)[:, 0]
        out = ops.linear(out, p + "to_out.0")
        return x + out.transpose(1, 2).reshape(n, c, hh, ww)

    z = latents / cfg["scaling_factor"]
    h = ops.conv(z, "vae.post_quant_conv", padding=0)
    h = ops.conv(h, "vae.decoder.conv_in")
    h = resnet(h, "vae.decoder.mid_block.resnets.0.")
    h = attn(h, "vae.decoder.mid_block.attentions.0.")
    h = resnet(h, "vae.decoder.mid_block.resnets.1.")
    for i in range(len(chans)):
        p = f"vae.decoder.up_blocks.{i}."
        for j in range(cfg["layers_per_block"] + 1):
            h = resnet(h, f"{p}resnets.{j}.")
        if i < len(chans) - 1:
            h = ops.conv(F.interpolate(h, scale_factor=2.0, mode="nearest"),
                         p + "upsamplers.0.conv")
    h = F.silu(ops.group_norm(h, "vae.decoder.conv_norm_out", g, eps))
    return ops.conv(h, "vae.decoder.conv_out")


def to_uint8(images: torch.Tensor) -> np.ndarray:
    """(N, 3, H, W) in [-1, 1] -> (N, H, W, 3) uint8."""
    v = torch.clamp(images * 0.5 + 0.5, 0.0, 1.0) * 255.0
    u8 = torch.floor(v + 0.5).to(torch.uint8)
    return u8.permute(0, 2, 3, 1).cpu().numpy()


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def sigma_table(sched: dict) -> np.ndarray:
    if sched["beta_schedule"] != "scaled_linear":
        raise ValueError(f"beta_schedule {sched['beta_schedule']!r}")
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5,
                        sched["num_train_timesteps"], dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas)
    return np.sqrt((1.0 - ac) / ac)


def karras_sigmas(table: np.ndarray, steps: int, rho: float = 7.0):
    ramp = np.linspace(0.0, 1.0, steps)
    lo, hi = table[0] ** (1 / rho), table[-1] ** (1 / rho)
    return np.append((hi + ramp * (lo - hi)) ** rho, 0.0)


def initial_noise(seed: int, n: int, h: int, w: int) -> torch.Tensor:
    """(n, 4, h, w): image i's N(0, 1) draw of shape (h, w, 4) from a CPU
    generator seeded with seed + i."""
    out = []
    for i in range(n):
        g = torch.Generator().manual_seed(int(seed) + i)
        out.append(torch.randn((h, w, 4), generator=g, dtype=torch.float32))
    return torch.stack(out).permute(0, 3, 1, 2).contiguous()


def generate(weights: Dict[str, torch.Tensor], cfg: dict, request: dict,
             precision: str = "fp32", device="cuda") -> np.ndarray:
    """The request's images, (B, H, W, 3) uint8. ``request``: prompt,
    negative_prompt, height, width, num_images_per_prompt, steps,
    cfg_scale, clip_skip, seed, region_state (phrase -> mask, weight,
    mask_outsides) or None; the sampler is DPM++ 2M Karras."""
    if request.get("sampler", "DPM++ 2M Karras") != "DPM++ 2M Karras":
        raise ValueError("the reference samples DPM++ 2M Karras only")
    if request.get("encoding_mode", "a1111") != "a1111":
        raise ValueError("the reference encodes prompts in a1111 mode only")
    ops = Ops(weights, precision)
    b = int(request["num_images_per_prompt"])
    hgt, wid = int(request["height"]), int(request["width"])
    lh, lw = hgt // 8, wid // 8
    with torch.no_grad():
        unc, con, ids = encode_prompt(ops, cfg, request["prompt"],
                                      request["negative_prompt"],
                                      int(request["clip_skip"]), device)
        ctx = torch.cat([unc[None].expand(b, -1, -1),
                         con[None].expand(b, -1, -1)])
        biases = None
        if request.get("region_state"):
            biases = [t[None].expand(2 * b, -1, -1) for t in region_biases(
                request["region_state"], ids, hgt, wid, device)]
        unet = UNet(ops, cfg["unet"])
        table = sigma_table(cfg["scheduler"])
        log_table = np.log(table)
        sigmas = karras_sigmas(table, int(request["steps"]))
        v_pred = cfg["scheduler"].get("prediction_type") == "v_prediction"
        gscale = float(request["cfg_scale"])
        x = initial_noise(request["seed"], b, lh, lw).to(device) * float(
            np.sqrt(sigmas[0] ** 2 + 1.0))

        def denoise(x, sigma):
            x_in = torch.cat([x, x])
            t = float(np.interp(np.log(sigma), log_table,
                                np.arange(len(table), dtype=np.float64)))
            t_b = torch.full((2 * b,), t, device=device)
            c_in = 1.0 / math.sqrt(sigma ** 2 + 1.0)
            out = unet(x_in * c_in, t_b, ctx,
                       None if biases is None else (biases, sigma))
            if v_pred:
                d = (x_in / (sigma ** 2 + 1.0)
                     - out * (sigma / math.sqrt(sigma ** 2 + 1.0)))
            else:
                d = x_in - out * sigma
            d_u, d_c = d[:b], d[b:]
            return d_u + gscale * (d_c - d_u)

        old = None
        for i in range(len(sigmas) - 1):
            s, s_next = float(sigmas[i]), float(sigmas[i + 1])
            d = denoise(x, s)
            if s_next == 0.0:
                x = d
            else:
                h = math.log(s) - math.log(s_next)
                if old is None:
                    d_use = d
                else:
                    r = (math.log(float(sigmas[i - 1])) - math.log(s)) / h
                    d_use = (1 + 1 / (2 * r)) * d - (1 / (2 * r)) * old
                x = (s_next / s) * x - math.expm1(-h) * d_use
            old = d
        images = torch.cat([vae_decode(ops, cfg["vae"], x[i:i + 1])
                            for i in range(b)])
    return to_uint8(images)
