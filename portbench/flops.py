"""The work of a request, counted from the configuration's widths and the
request's shapes: every convolution, linear layer and attention product
(Q K^T and P V) of the text encoder, the UNet and the VAE decoder, or
every convolution of the HED detector, two operations a multiply-add.
Norms, activations, pooling, resizing, softmax and the region std are not
counted. ``tests/test_portbench_flops.py`` holds the counts
to ``torch.utils.flop_counter`` over the plain reference.

Each operation is a tuple:

* ``("conv", n, c_in, c_out, k, h_out, w_out, stride)``
* ``("linear", rows, d_in, d_out)``
* ``("attn", n, heads, l, s, d, biased, where)``, ``where`` "unet",
  "clip" or "vae".
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

Op = Tuple


def _heads(cfg: dict, n_levels: int) -> List[int]:
    a = cfg.get("num_attention_heads") or cfg["attention_head_dim"]
    return list(a) if isinstance(a, (list, tuple)) else [a] * n_levels


def unet_ops(cfg: dict, n: int, h: int, w: int, s_ctx: int,
             biased: bool) -> Iterator[Op]:
    """One UNet forward on n latents of h x w."""
    chans = cfg["block_out_channels"]
    levels = len(chans)
    heads = _heads(cfg, levels)
    attn = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
    temb = 4 * chans[0]
    cross = cfg["cross_attention_dim"]
    linear_proj = cfg.get("use_linear_projection", False)
    sizes = []
    hh, ww = h, w
    for _ in range(levels):
        sizes.append((hh, ww))
        hh, ww = -(-hh // 2), -(-ww // 2)

    def resnet(c_in, c_out, size):
        yield ("conv", n, c_in, c_out, 3, *size, 1)
        yield ("linear", n, temb, c_out)
        yield ("conv", n, c_out, c_out, 3, *size, 1)
        if c_in != c_out:
            yield ("conv", n, c_in, c_out, 1, *size, 1)

    def transformer(c, lv):
        size = sizes[lv]
        l = size[0] * size[1]
        d = c // heads[lv]
        if linear_proj:
            yield ("linear", n * l, c, c)
        else:
            yield ("conv", n, c, c, 1, *size, 1)
        for _ in range(cfg.get("transformer_layers_per_block", 1)):
            yield from (("linear", n * l, c, c),) * 3
            yield ("attn", n, heads[lv], l, l, d, False, "unet")
            yield ("linear", n * l, c, c)
            yield ("linear", n * l, c, c)
            yield ("linear", n * s_ctx, cross, c)
            yield ("linear", n * s_ctx, cross, c)
            yield ("attn", n, heads[lv], l, s_ctx, d, biased, "unet")
            yield ("linear", n * l, c, c)
            yield ("linear", n * l, c, 8 * c)
            yield ("linear", n * l, 4 * c, c)
        if linear_proj:
            yield ("linear", n * l, c, c)
        else:
            yield ("conv", n, c, c, 1, *size, 1)

    yield ("linear", n, chans[0], temb)
    yield ("linear", n, temb, temb)
    yield ("conv", n, cfg["in_channels"], chans[0], 3, *sizes[0], 1)
    skips = [chans[0]]
    c = chans[0]
    for lv, c_out in enumerate(chans):
        for _ in range(cfg["layers_per_block"]):
            yield from resnet(c, c_out, sizes[lv])
            c = c_out
            if attn[lv]:
                yield from transformer(c, lv)
            skips.append(c)
        if lv < levels - 1:
            yield ("conv", n, c, c, 3, *sizes[lv + 1], 2)
            skips.append(c)
    top = levels - 1
    yield from resnet(c, c, sizes[top])
    yield from transformer(c, top)
    yield from resnet(c, c, sizes[top])
    for i in range(levels):
        lv = top - i
        c_out = chans[lv]
        for _ in range(cfg["layers_per_block"] + 1):
            yield from resnet(c + skips.pop(), c_out, sizes[lv])
            c = c_out
            if attn[lv]:
                yield from transformer(c, lv)
        if i < levels - 1:
            yield ("conv", n, c, c, 3, *sizes[lv - 1], 1)
    yield ("conv", n, c, cfg["out_channels"], 3, *sizes[0], 1)


def clip_ops(cfg: dict, n: int, l: int, clip_skip: int) -> Iterator[Op]:
    """The text encoder on n sequences of l tokens, up to ``clip_skip``."""
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    for _ in range(cfg["num_hidden_layers"] - (clip_skip - 1)):
        yield from (("linear", n * l, d, d),) * 3
        yield ("attn", n, heads, l, l, d // heads, False, "clip")
        yield ("linear", n * l, d, d)
        yield ("linear", n * l, d, cfg["intermediate_size"])
        yield ("linear", n * l, cfg["intermediate_size"], d)


def vae_decoder_ops(cfg: dict, n: int, h: int, w: int) -> Iterator[Op]:
    """The VAE decoder on n latents of h x w."""
    chans = list(reversed(cfg["block_out_channels"]))
    lat = cfg["latent_channels"]

    def resnet(c_in, c_out, size):
        yield ("conv", n, c_in, c_out, 3, *size, 1)
        yield ("conv", n, c_out, c_out, 3, *size, 1)
        if c_in != c_out:
            yield ("conv", n, c_in, c_out, 1, *size, 1)

    size = (h, w)
    yield ("conv", n, lat, lat, 1, *size, 1)
    c = chans[0]
    yield ("conv", n, lat, c, 3, *size, 1)
    yield from resnet(c, c, size)
    yield from (("linear", n * h * w, c, c),) * 3
    yield ("attn", n, 1, h * w, h * w, c, False, "vae")
    yield ("linear", n * h * w, c, c)
    yield from resnet(c, c, size)
    for i, c_out in enumerate(chans):
        for _ in range(cfg["layers_per_block"] + 1):
            yield from resnet(c, c_out, size)
            c = c_out
        if i < len(chans) - 1:
            size = (2 * size[0], 2 * size[1])
            yield ("conv", n, c, c, 3, *size, 1)
    yield ("conv", n, c, cfg["out_channels"], 3, *size, 1)


def hed_ops(cfg: dict, h: int, w: int) -> Iterator[Op]:
    """The HED network on one h x w picture: each block's 3x3 convs and its
    1x1 side projection, blocks 2-5 after a 2x2 pool."""
    c_in = 3
    for b, (n, c) in enumerate(zip(cfg["convs"], cfg["widths"])):
        if b:
            h, w = h // 2, w // 2
        for i in range(n):
            yield ("conv", 1, c_in if i == 0 else c, c, 3, h, w, 1)
        yield ("conv", 1, c, 1, 1, h, w, 1)
        c_in = c


def request_ops(cfg: dict, request: dict, s_ctx: int = 77) -> Iterator[Op]:
    """Every counted operation of one request. txt2img with CFG: the text
    encoder on the [negative, prompt] pair, ``steps`` UNet calls on the 2B
    CFG rows, and B decodes. A picture: the HED network once."""
    if "hed" in cfg:
        yield from hed_ops(cfg["hed"], int(request["height"]),
                           int(request["width"]))
        return
    b = int(request["num_images_per_prompt"])
    h, w = int(request["height"]) // 8, int(request["width"]) // 8
    yield from clip_ops(cfg["text_encoder"], 2, s_ctx,
                        int(request["clip_skip"]))
    biased = bool(request.get("region_state"))
    step = list(unet_ops(cfg["unet"], 2 * b, h, w, s_ctx, biased))
    for _ in range(int(request["steps"])):
        yield from step
    yield from vae_decoder_ops(cfg["vae"], b, h, w)


def flops(op: Op) -> float:
    kind = op[0]
    if kind == "conv":
        _, n, c_in, c_out, k, ho, wo, _ = op
        return 2.0 * n * c_in * c_out * k * k * ho * wo
    if kind == "linear":
        _, rows, d_in, d_out = op
        return 2.0 * rows * d_in * d_out
    if kind == "attn":
        _, n, heads, l, s, d, _, _ = op
        return 4.0 * n * heads * l * s * d
    raise ValueError(f"op {kind!r}")


def bytes_moved(op: Op, elem: int = 2) -> float:
    """Each input read once and each output written once, in ``elem``-byte
    elements; a region bias is float32 (N, L, S)."""
    kind = op[0]
    if kind == "conv":
        _, n, c_in, c_out, k, ho, wo, stride = op
        hi, wi = ho * stride, wo * stride
        return elem * (n * c_in * hi * wi + c_out * c_in * k * k + c_out
                       + n * c_out * ho * wo)
    if kind == "attn":
        _, n, heads, l, s, d, biased, _ = op
        c = heads * d
        return elem * (2 * n * l * c + 2 * n * s * c) + (
            4 * n * l * s if biased else 0)
    raise ValueError(f"op {kind!r}")


ELEM_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def least_seconds(op: Op, peaks: dict, dtype: str) -> float:
    """The least time the chip could take: operations at its dense peak for
    ``dtype`` (float32: without TF32) or bytes at the memory bandwidth,
    whichever is longer."""
    return max(flops(op) / peaks["flops_per_s"][dtype],
               bytes_moved(op, ELEM_BYTES[dtype]) / peaks["hbm_bytes_per_s"])
