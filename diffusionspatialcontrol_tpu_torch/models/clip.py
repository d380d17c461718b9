"""CLIP text encoder with clip-skip (port of ``models/clip.py``).

``hidden_states[-clip_skip]`` followed by the final layer norm, as the
reference and the JAX package take it. Its attention is plain in the JAX
package (a materialized einsum with a causal mask), so it is plain here.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..config import CLIPTextConfig
from .layers import ACTIVATIONS, layer_norm, linear, linear_init, norm_init


def clip_init(generator: torch.Generator, cfg: CLIPTextConfig,
              dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    d = cfg.hidden_size

    def normal(shape, std):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return (t.normal_(generator=generator) * std).to(dtype)

    params: Dict[str, Any] = {
        "token_embedding": normal((cfg.vocab_size, d), 0.02),
        "position_embedding": normal((cfg.max_position_embeddings, d), 0.01),
        "layers": [],
        "final_layer_norm": norm_init(d, dtype, device),
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "layer_norm1": norm_init(d, dtype, device),
            "q_proj": linear_init(generator, d, d, dtype=dtype, device=device),
            "k_proj": linear_init(generator, d, d, dtype=dtype, device=device),
            "v_proj": linear_init(generator, d, d, dtype=dtype, device=device),
            "out_proj": linear_init(generator, d, d, dtype=dtype,
                                    device=device),
            "layer_norm2": norm_init(d, dtype, device),
            "fc1": linear_init(generator, d, cfg.intermediate_size,
                               dtype=dtype, device=device),
            "fc2": linear_init(generator, cfg.intermediate_size, d,
                               dtype=dtype, device=device),
        })
    return params


def _causal_mask(seq_len: int, device) -> torch.Tensor:
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(j <= i, zero, torch.full_like(zero, float("-inf")))


def _clip_attention(p, x, num_heads: int, mask):
    b, l, d = x.shape
    hd = d // num_heads
    scale = hd ** -0.5

    def split(t):
        return t.reshape(b, l, num_heads, hd).transpose(1, 2)

    q = split(linear(p["q_proj"], x)) * scale
    k = split(linear(p["k_proj"], x))
    v = split(linear(p["v_proj"], x))
    logits = torch.einsum("bhld,bhsd->bhls", q.float(), k.float()) + mask
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhls,bhsd->bhld", probs.float(), v.float())
    out = out.to(x.dtype).transpose(1, 2).reshape(b, l, d)
    return linear(p["out_proj"], out)


def clip_apply(params: Dict[str, Any], cfg: CLIPTextConfig,
               input_ids: torch.Tensor, clip_skip: int = 1) -> torch.Tensor:
    """Encode token ids (B, 77) to (B, 77, hidden). ``clip_skip`` k takes the
    hidden state k layers from the end (k=1: final layer), then applies the
    final layer norm."""
    act = ACTIVATIONS[cfg.hidden_act]
    x = params["token_embedding"][input_ids]
    x = x + params["position_embedding"][None, : x.shape[1]]
    mask = _causal_mask(x.shape[1], x.device)

    n_run = cfg.num_layers - (clip_skip - 1)
    for layer in params["layers"][:n_run]:
        h = layer_norm(layer["layer_norm1"], x)
        x = x + _clip_attention(layer, h, cfg.num_heads, mask)
        h = layer_norm(layer["layer_norm2"], x)
        h = linear(layer["fc2"], act(linear(layer["fc1"], h)))
        x = x + h
    return layer_norm(params["final_layer_norm"], x)
