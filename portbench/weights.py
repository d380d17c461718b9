"""Random weights from the run's seed, made on the device in the published
checkpoints' names and shapes, in the type they are served in: for Stable
Diffusion the diffusers / transformers names (``unet.*``, ``vae.*`` with
its encoder, ``text_encoder.*``), for the HED detector those of
``ControlNetHED.pth`` (``norm``, ``block{b}.convs.{i}.*``,
``block{b}.projection.*``).

All tensors are views into one flat buffer filled by one ``randn`` call
of a ``torch.Generator`` on the device, then scaled and offset per tensor
by two vectors spread with ``repeat_interleave``: three large calls, not
one a tensor. The same seed on the same device gives the same bits, so
the reference can make them again after the program is gone
(``checksum`` tells the two apart).

Distributions (the configuration file's ``assumed``): a linear or conv
weight N(0, 1 / (3 fan_in)), the variance of the U(+-1/sqrt(fan_in)) init;
biases, norm offsets and norm scales minus 1 N(0, 0.02^2); the token
embedding N(0, 0.02^2), the position embedding N(0, 0.01^2); the text
encoder's final layer-norm bias N(0, 0.5^2), as trained weights have one
(the A1111 prompt weighting divides by the embedding's mean). HED: the
3x3 conv weights He-normal N(0, 2 / fan_in), the first one's divided by
64 (the network reads raw 0..255 pixels), the 1x1 side projections
N(0, 1 / fan_in), biases N(0, 0.02^2), the pixel shift ``norm``
N(127.5, 10^2); so every side output's logits are of order one and the
edge map is not saturated.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], float, float]  # name, shape, std, mean

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def dtype_of(cfg: dict) -> torch.dtype:
    return _DTYPES[cfg["dtype"]]


def _linear(name, d_out, d_in, bias=True) -> Iterator[Spec]:
    yield (name + ".weight", (d_out, d_in), 1 / math.sqrt(3 * d_in), 0.0)
    if bias:
        yield (name + ".bias", (d_out,), 0.02, 0.0)


def _conv(name, c_out, c_in, k) -> Iterator[Spec]:
    yield (name + ".weight", (c_out, c_in, k, k),
           1 / math.sqrt(3 * c_in * k * k), 0.0)
    yield (name + ".bias", (c_out,), 0.02, 0.0)


def _norm(name, c) -> Iterator[Spec]:
    yield (name + ".weight", (c,), 0.02, 1.0)
    yield (name + ".bias", (c,), 0.02, 0.0)


def _heads(cfg: dict, n_levels: int) -> List[int]:
    a = cfg.get("num_attention_heads") or cfg["attention_head_dim"]
    return list(a) if isinstance(a, (list, tuple)) else [a] * n_levels


def unet_specs(cfg: dict, pre: str = "unet.") -> Iterator[Spec]:
    chans = cfg["block_out_channels"]
    levels = len(chans)
    temb = 4 * chans[0]
    cross = cfg["cross_attention_dim"]
    attn = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
    lin_proj = cfg.get("use_linear_projection", False)

    def resnet(p, c_in, c_out):
        yield from _norm(p + "norm1", c_in)
        yield from _conv(p + "conv1", c_out, c_in, 3)
        yield from _linear(p + "time_emb_proj", c_out, temb)
        yield from _norm(p + "norm2", c_out)
        yield from _conv(p + "conv2", c_out, c_out, 3)
        if c_in != c_out:
            yield from _conv(p + "conv_shortcut", c_out, c_in, 1)

    def transformer(p, c):
        yield from _norm(p + "norm", c)
        proj = ((lambda n: _linear(n, c, c)) if lin_proj
                else (lambda n: _conv(n, c, c, 1)))
        yield from proj(p + "proj_in")
        for b in range(cfg.get("transformer_layers_per_block", 1)):
            bp = f"{p}transformer_blocks.{b}."
            yield from _norm(bp + "norm1", c)
            for k in ("to_q", "to_k", "to_v"):
                yield from _linear(f"{bp}attn1.{k}", c, c, bias=False)
            yield from _linear(bp + "attn1.to_out.0", c, c)
            yield from _norm(bp + "norm2", c)
            yield from _linear(bp + "attn2.to_q", c, c, bias=False)
            yield from _linear(bp + "attn2.to_k", c, cross, bias=False)
            yield from _linear(bp + "attn2.to_v", c, cross, bias=False)
            yield from _linear(bp + "attn2.to_out.0", c, c)
            yield from _norm(bp + "norm3", c)
            yield from _linear(bp + "ff.net.0.proj", 8 * c, c)
            yield from _linear(bp + "ff.net.2", c, 4 * c)
        yield from proj(p + "proj_out")

    yield from _conv(pre + "conv_in", chans[0], cfg["in_channels"], 3)
    yield from _linear(pre + "time_embedding.linear_1", temb, chans[0])
    yield from _linear(pre + "time_embedding.linear_2", temb, temb)
    skips, c = [chans[0]], chans[0]
    for lv, c_out in enumerate(chans):
        p = f"{pre}down_blocks.{lv}."
        for j in range(cfg["layers_per_block"]):
            yield from resnet(f"{p}resnets.{j}.", c, c_out)
            c = c_out
            if attn[lv]:
                yield from transformer(f"{p}attentions.{j}.", c)
            skips.append(c)
        if lv < levels - 1:
            yield from _conv(p + "downsamplers.0.conv", c, c, 3)
            skips.append(c)
    yield from resnet(pre + "mid_block.resnets.0.", c, c)
    yield from transformer(pre + "mid_block.attentions.0.", c)
    yield from resnet(pre + "mid_block.resnets.1.", c, c)
    for i in range(levels):
        lv = levels - 1 - i
        p = f"{pre}up_blocks.{i}."
        for j in range(cfg["layers_per_block"] + 1):
            yield from resnet(f"{p}resnets.{j}.", c + skips.pop(), chans[lv])
            c = chans[lv]
            if attn[lv]:
                yield from transformer(f"{p}attentions.{j}.", c)
        if i < levels - 1:
            yield from _conv(p + "upsamplers.0.conv", c, c, 3)
    yield from _norm(pre + "conv_norm_out", c)
    yield from _conv(pre + "conv_out", cfg["out_channels"], c, 3)


def vae_specs(cfg: dict, pre: str = "vae.") -> Iterator[Spec]:
    chans = cfg["block_out_channels"]
    lat = cfg["latent_channels"]

    def resnet(p, c_in, c_out):
        yield from _norm(p + "norm1", c_in)
        yield from _conv(p + "conv1", c_out, c_in, 3)
        yield from _norm(p + "norm2", c_out)
        yield from _conv(p + "conv2", c_out, c_out, 3)
        if c_in != c_out:
            yield from _conv(p + "conv_shortcut", c_out, c_in, 1)

    def mid(p, c):
        yield from resnet(p + "resnets.0.", c, c)
        yield from _norm(p + "attentions.0.group_norm", c)
        for k in ("to_q", "to_k", "to_v", "to_out.0"):
            yield from _linear(f"{p}attentions.0.{k}", c, c)
        yield from resnet(p + "resnets.1.", c, c)

    e = pre + "encoder."
    yield from _conv(e + "conv_in", chans[0], cfg["in_channels"], 3)
    c = chans[0]
    for lv, c_out in enumerate(chans):
        for j in range(cfg["layers_per_block"]):
            yield from resnet(f"{e}down_blocks.{lv}.resnets.{j}.", c, c_out)
            c = c_out
        if lv < len(chans) - 1:
            yield from _conv(f"{e}down_blocks.{lv}.downsamplers.0.conv",
                             c, c, 3)
    yield from mid(e + "mid_block.", c)
    yield from _norm(e + "conv_norm_out", c)
    yield from _conv(e + "conv_out", 2 * lat, c, 3)
    yield from _conv(pre + "quant_conv", 2 * lat, 2 * lat, 1)
    yield from _conv(pre + "post_quant_conv", lat, lat, 1)
    d = pre + "decoder."
    rev = list(reversed(chans))
    c = rev[0]
    yield from _conv(d + "conv_in", c, lat, 3)
    yield from mid(d + "mid_block.", c)
    for i, c_out in enumerate(rev):
        for j in range(cfg["layers_per_block"] + 1):
            yield from resnet(f"{d}up_blocks.{i}.resnets.{j}.", c, c_out)
            c = c_out
        if i < len(rev) - 1:
            yield from _conv(f"{d}up_blocks.{i}.upsamplers.0.conv", c, c, 3)
    yield from _norm(d + "conv_norm_out", c)
    yield from _conv(d + "conv_out", cfg["out_channels"], c, 3)


def text_encoder_specs(cfg: dict,
                       pre: str = "text_encoder.") -> Iterator[Spec]:
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    t = pre + "text_model."
    yield (t + "embeddings.token_embedding.weight", (cfg["vocab_size"], d),
           0.02, 0.0)
    yield (t + "embeddings.position_embedding.weight",
           (cfg["max_position_embeddings"], d), 0.01, 0.0)
    for i in range(cfg["num_hidden_layers"]):
        p = f"{t}encoder.layers.{i}."
        yield from _norm(p + "layer_norm1", d)
        for k in ("q_proj", "k_proj", "v_proj", "out_proj"):
            yield from _linear(f"{p}self_attn.{k}", d, d)
        yield from _norm(p + "layer_norm2", d)
        yield from _linear(p + "mlp.fc1", ff, d)
        yield from _linear(p + "mlp.fc2", d, ff)
    yield (t + "final_layer_norm.weight", (d,), 0.02, 1.0)
    yield (t + "final_layer_norm.bias", (d,), 0.5, 0.0)


def hed_specs(cfg: dict) -> Iterator[Spec]:
    yield ("norm", (1, 3, 1, 1), 10.0, 127.5)
    c_in = 3
    for b, (n, c) in enumerate(zip(cfg["convs"], cfg["widths"]), start=1):
        for i in range(n):
            fan = 9 * (c_in if i == 0 else c)
            scale = 1 / 64 if (b, i) == (1, 0) else 1.0
            yield (f"block{b}.convs.{i}.weight",
                   (c, c_in if i == 0 else c, 3, 3),
                   scale * math.sqrt(2 / fan), 0.0)
            yield (f"block{b}.convs.{i}.bias", (c,), 0.02, 0.0)
        yield (f"block{b}.projection.weight", (1, c, 1, 1),
               1 / math.sqrt(c), 0.0)
        yield (f"block{b}.projection.bias", (1,), 0.02, 0.0)
        c_in = c


def specs(cfg: dict) -> List[Spec]:
    if "hed" in cfg:
        return list(hed_specs(cfg["hed"]))
    return (list(unet_specs(cfg["unet"])) + list(vae_specs(cfg["vae"]))
            + list(text_encoder_specs(cfg["text_encoder"])))


def make(cfg: dict, seed: int, device) -> Tuple[Dict[str, torch.Tensor],
                                                 torch.Tensor]:
    """(name -> tensor, the flat buffer they view) for ``seed``."""
    entries = specs(cfg)
    dtype = dtype_of(cfg)
    counts = [math.prod(shape) for _, shape, _, _ in entries]
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(sum(counts), generator=g, dtype=dtype, device=device)
    n = torch.tensor(counts, device=device)
    for col in (2, 3):  # std, then mean
        vals = torch.tensor([e[col] for e in entries], dtype=dtype,
                            device=device)
        spread = torch.repeat_interleave(vals, n)
        if col == 2:
            flat.mul_(spread)
        else:
            flat.add_(spread)
        del spread
    out, off = {}, 0
    for (name, shape, _, _), c in zip(entries, counts):
        out[name] = flat[off:off + c].view(shape)
        off += c
    return out, flat


def checksum(flat: torch.Tensor, block: int = 1 << 26) -> int:
    """Sum of the buffer's bit patterns, exact."""
    bits = flat.view(torch.int16 if flat.element_size() == 2 else torch.int32)
    return int(sum(int(bits[i:i + block].sum(dtype=torch.int64))
                   for i in range(0, bits.numel(), block)))


def component(weights: Dict[str, torch.Tensor], prefix: str
              ) -> Dict[str, torch.Tensor]:
    """The tensors under ``prefix`` (``"unet."``, ...), the prefix cut."""
    return {k[len(prefix):]: v for k, v in weights.items()
            if k.startswith(prefix)}
