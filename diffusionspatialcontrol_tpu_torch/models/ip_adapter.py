"""IP-Adapter: image-prompt projection models and the UNet's decoupled K/V
weights (port of ``models/ip_adapter.py``).

The six variants of the app's table (``registry.IP_ADAPTER_MODELS``):
base and light (``ImageProjection``: a linear layer and a LayerNorm),
full-face (an MLP over the image embeds, one token), plus and plus-face
(the perceiver Resampler over the image tower's penultimate hidden states)
and FaceID (the MLP over a 512-d identity embedding).

State-dict layout (diffusers): ``image_proj.*`` is the projection model;
``ip_adapter.{2k+1}.to_k_ip/to_v_ip.weight`` are the decoupled K/V weights
of the k-th cross-attention in diffusers' processor order, **down blocks,
up blocks, then mid**. The weights arrive in torch's (out, in) layout,
which is the port's own linear layout, so nothing is transposed. The
Resampler's fused ``to_kv`` splits into K (its first ``dim`` output rows)
and V (the rest).

The Resampler's attention runs through K2 (``flash_attention_nlhd``; its
plain version on CPU tensors), as every attention of the port does; the
JAX package runs it as plain XLA attention.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import UNetConfig
from ..convert.safetensors import load_file
from ..device import resolve_device
from ..ops.kernels.flash_attention import flash_attention_nlhd
from .layers import layer_norm, linear

# ---------------------------------------------------------------------------
# Projection models
# ---------------------------------------------------------------------------


def image_projection_apply(p, image_embeds: torch.Tensor,
                           num_tokens: int = 4) -> torch.Tensor:
    """Base/light ImageProjection: linear -> (B, num_tokens, cross_dim)
    -> LayerNorm."""
    x = linear(p["proj"], image_embeds)
    return layer_norm(p["norm"], x.reshape(x.shape[0], num_tokens, -1))


def full_projection_apply(p, image_embeds: torch.Tensor,
                          num_tokens: int = 1) -> torch.Tensor:
    """IPAdapterFullImageProjection: FeedForward (exact GELU) -> tokens ->
    LayerNorm; one token keeps a token axis of 1."""
    h = linear(p["ff_out"], F.gelu(linear(p["ff_in"], image_embeds)))
    if num_tokens > 1:
        h = h.reshape(-1, num_tokens, p["norm"]["scale"].shape[0])
        return layer_norm(p["norm"], h)
    return layer_norm(p["norm"], h)[:, None, :]


def resampler_apply(p, hidden_states: torch.Tensor,
                    heads: int = 20) -> torch.Tensor:
    """Perceiver Resampler (plus variants): learned latents cross-attend to
    the image tower's penultimate hidden states, each layer's keys and
    values being [hidden states, latents]."""
    x = linear(p["proj_in"], hidden_states)
    b = x.shape[0]
    latents = p["latents"][None].expand(b, -1, -1).to(x.dtype)
    for layer in p["layers"]:
        residual = latents
        ln_q = layer_norm(layer["ln0"], latents)
        kv = torch.cat([layer_norm(layer["ln1"], x), ln_q], dim=1)
        q = linear(layer["to_q"], ln_q)
        k = linear(layer["to_k"], kv)
        v = linear(layer["to_v"], kv)

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], heads, -1)

        out = flash_attention_nlhd(split(q), split(k), split(v))
        latents = residual + linear(layer["to_out"], out.reshape(q.shape))
        h = layer_norm(layer["ff_norm"], latents)
        latents = latents + linear(layer["ff_out"],
                                   F.gelu(linear(layer["ff_in"], h)))
    return layer_norm(p["norm_out"], linear(p["proj_out"], latents))


def faceid_projection_apply(p, id_embeds: torch.Tensor,
                            num_tokens: int = 4) -> torch.Tensor:
    """FaceID MLP projection over 512-d identity embeddings."""
    h = linear(p["ff_out"], F.gelu(linear(p["ff_in"], id_embeds)))
    h = h.reshape(-1, num_tokens, p["norm"]["scale"].shape[0])
    return layer_norm(p["norm"], h)


# ---------------------------------------------------------------------------
# State-dict conversion
# ---------------------------------------------------------------------------


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32)).to(dtype=dtype,
                                                      device=device)


def _lin(sd, name, dtype, device, bias=True):
    p = {"kernel": _tensor(sd[f"{name}.weight"], dtype, device)}
    if bias and f"{name}.bias" in sd:
        p["bias"] = _tensor(sd[f"{name}.bias"], dtype, device)
    return p


def _ln(sd, name, dtype, device):
    return {"scale": _tensor(sd[f"{name}.weight"], dtype, device),
            "bias": _tensor(sd[f"{name}.bias"], dtype, device)}


def detect_variant(image_proj_sd: Dict[str, np.ndarray]) -> str:
    keys = set(image_proj_sd)
    if "latents" in keys:
        return "resampler"  # plus / plus-face
    if "proj.weight" in keys:
        return "linear"  # base / light
    if any(k.startswith("proj.0") for k in keys):
        return "mlp"  # full-face / faceid
    raise ValueError(f"unknown image_proj layout: {sorted(keys)[:8]}")


def convert_image_proj(image_proj_sd: Dict[str, np.ndarray],
                       dtype=torch.bfloat16, device=None
                       ) -> Tuple[str, Dict[str, Any], int]:
    """(variant, params, num_tokens) of an ``image_proj`` state dict."""
    device = resolve_device(device)
    sd = image_proj_sd
    variant = detect_variant(sd)
    if variant == "linear":
        p = {"proj": _lin(sd, "proj", dtype, device),
             "norm": _ln(sd, "norm", dtype, device)}
        cross = p["norm"]["scale"].shape[0]
        return "linear", p, p["proj"]["kernel"].shape[0] // cross
    if variant == "mlp":
        p = {"ff_in": _lin(sd, "proj.0", dtype, device),
             "ff_out": _lin(sd, "proj.2", dtype, device),
             "norm": _ln(sd, "norm", dtype, device)}
        cross = p["norm"]["scale"].shape[0]
        return "mlp", p, max(1, p["ff_out"]["kernel"].shape[0] // cross)
    layers = []
    i = 0
    while any(k.startswith(f"layers.{i}.") for k in sd):
        pre = f"layers.{i}"
        kv = _tensor(sd[f"{pre}.0.to_kv.weight"], dtype, device)
        half = kv.shape[0] // 2
        layers.append({
            "ln0": _ln(sd, f"{pre}.0.norm1", dtype, device),
            "ln1": _ln(sd, f"{pre}.0.norm2", dtype, device),
            "to_q": _lin(sd, f"{pre}.0.to_q", dtype, device, bias=False),
            "to_k": {"kernel": kv[:half].contiguous()},
            "to_v": {"kernel": kv[half:].contiguous()},
            "to_out": _lin(sd, f"{pre}.0.to_out", dtype, device, bias=False),
            "ff_norm": _ln(sd, f"{pre}.1.0", dtype, device),
            "ff_in": _lin(sd, f"{pre}.1.1", dtype, device),
            "ff_out": _lin(sd, f"{pre}.1.3", dtype, device),
        })
        i += 1
    p = {
        "latents": _tensor(np.asarray(sd["latents"], np.float32)[0], dtype,
                           device),
        "proj_in": _lin(sd, "proj_in", dtype, device),
        "proj_out": _lin(sd, "proj_out", dtype, device),
        "norm_out": _ln(sd, "norm_out", dtype, device),
        "layers": layers,
    }
    # 64-wide heads: 12 on SD1.5's 768-wide latents (an int, not a tensor)
    p["heads"] = max(1, p["latents"].shape[-1] // 64)
    return "resampler", p, p["latents"].shape[0]


def cross_attn_paths(unet_cfg: UNetConfig) -> List[Tuple]:
    """Paths to every cross-attention ('attn2') dict of the UNet tree, in
    diffusers' processor order: down blocks, up blocks, mid."""
    paths: List[Tuple] = []
    for level in range(unet_cfg.num_levels):
        if unet_cfg.attn_levels[level]:
            for j in range(unet_cfg.layers_per_block):
                for tb in range(unet_cfg.transformer_layers_per_block):
                    paths.append(("down_blocks", level, "attentions", j,
                                  "blocks", tb, "attn2"))
    for i in range(unet_cfg.num_levels):
        level = unet_cfg.num_levels - 1 - i
        if unet_cfg.attn_levels[level]:
            for j in range(unet_cfg.layers_per_block + 1):
                for tb in range(unet_cfg.transformer_layers_per_block):
                    paths.append(("up_blocks", i, "attentions", j,
                                  "blocks", tb, "attn2"))
    for tb in range(unet_cfg.transformer_layers_per_block):
        paths.append(("mid_block", "attention", "blocks", tb, "attn2"))
    return paths


def cross_attn_hidden_dims(unet_cfg: UNetConfig) -> List[int]:
    """Query/output width of each cross-attention, in ``cross_attn_paths``
    order."""
    ch = unet_cfg.block_out_channels
    n = unet_cfg.num_levels
    dims: List[int] = []
    for path in cross_attn_paths(unet_cfg):
        if path[0] == "down_blocks":
            dims.append(ch[path[1]])
        elif path[0] == "up_blocks":
            dims.append(ch[n - 1 - path[1]])
        else:
            dims.append(ch[-1])
    return dims


def _node(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def install_ip_adapter_weights(
    unet_params: Dict[str, Any],
    unet_cfg: UNetConfig,
    ip_adapter_sds: Sequence[Dict[str, np.ndarray]],
    dtype=torch.bfloat16,
    device=None,
) -> Dict[str, Any]:
    """Writes an ``"ip"`` list (one {to_k, to_v} a adapter) into every
    cross-attention of ``unet_params``, in place; the weights stay in their
    (out, in) layout."""
    device = resolve_device(device)
    for li, path in enumerate(cross_attn_paths(unet_cfg)):
        key_id = 2 * li + 1
        _node(unet_params, path)["ip"] = [
            {"to_k": {"kernel": _tensor(sd[f"{key_id}.to_k_ip.weight"],
                                        dtype, device)},
             "to_v": {"kernel": _tensor(sd[f"{key_id}.to_v_ip.weight"],
                                        dtype, device)}}
            for sd in ip_adapter_sds]
    return unet_params


def uninstall_ip_adapter_weights(unet_params: Dict[str, Any],
                                 unet_cfg: UNetConfig) -> Dict[str, Any]:
    for path in cross_attn_paths(unet_cfg):
        _node(unet_params, path).pop("ip", None)
    return unet_params


@dataclasses.dataclass
class LoadedIPAdapter:
    variant: str
    proj_params: Dict[str, Any]
    num_tokens: int

    def project(self, image_embeds: torch.Tensor) -> torch.Tensor:
        if self.variant == "linear":
            return image_projection_apply(self.proj_params, image_embeds,
                                          self.num_tokens)
        if self.variant == "mlp":
            return full_projection_apply(self.proj_params, image_embeds,
                                         self.num_tokens)
        return resampler_apply(self.proj_params, image_embeds,
                               heads=self.proj_params.get("heads", 20))


def copy_tree_containers(tree):
    """A copy of the dict/list/tuple skeleton that shares the tensors, so
    that installing an adapter into a request's UNet tree leaves the
    manager's cached tree as it was."""
    if isinstance(tree, dict):
        return {k: copy_tree_containers(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [copy_tree_containers(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(copy_tree_containers(v) for v in tree)
    return tree


def split_ip_adapter_state_dict(
    flat: Dict[str, np.ndarray],
) -> Dict[str, Dict[str, np.ndarray]]:
    """Flat {'image_proj.x': t, 'ip_adapter.y': t} -> {'image_proj': {...},
    'ip_adapter': {...}}."""
    out: Dict[str, Dict[str, np.ndarray]] = {"image_proj": {},
                                             "ip_adapter": {}}
    for k, v in flat.items():
        group, _, rest = k.partition(".")
        if group in out:
            out[group][rest] = v
    return out


def load_ip_adapter_file(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """One IP-Adapter weight file (``.safetensors`` with ``image_proj.`` and
    ``ip_adapter.`` prefixes, or a torch pickle, read with
    ``weights_only=True``, of the two groups or of prefixed names) -> the
    split {image_proj, ip_adapter} groups of fp32 numpy arrays."""
    if path.endswith(".safetensors"):
        return split_ip_adapter_state_dict(
            {k: v.float().numpy() for k, v in load_file(path).items()})
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "image_proj" in sd and "ip_adapter" in sd:
        return {
            g: {k: v.float().numpy() for k, v in sd[g].items()}
            for g in ("image_proj", "ip_adapter")
        }
    return split_ip_adapter_state_dict(
        {k: v.float().numpy() for k, v in sd.items()})


def random_state_dict(
    unet_cfg: UNetConfig,
    variant: str = "linear",
    seed: int = 0,
    embed_dim: int = 1024,
    num_tokens: int = 4,
    hidden_dims: Optional[List[int]] = None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """A synthetic {image_proj, ip_adapter} state dict with the layout of
    the real weight files, drawn from ``np.random.RandomState(seed)`` in the
    JAX package's order, so both packages get the same weights by name.

    ``variant``: 'linear' (base/light), 'mlp' (full-face), 'faceid' (512-d
    id embeds) or 'resampler' (plus / plus-face)."""
    rng = np.random.RandomState(seed)
    cross = unet_cfg.cross_attention_dim

    def r(*shape, s=0.02):
        return (rng.randn(*shape) * s).astype(np.float32)

    if variant == "linear":
        proj = {
            "proj.weight": r(num_tokens * cross, embed_dim),
            "proj.bias": np.zeros(num_tokens * cross, np.float32),
            "norm.weight": np.ones(cross, np.float32),
            "norm.bias": np.zeros(cross, np.float32),
        }
    elif variant in ("mlp", "faceid"):
        in_dim = 512 if variant == "faceid" else embed_dim
        tokens = num_tokens if variant == "faceid" else 1
        proj = {
            "proj.0.weight": r(in_dim * 2, in_dim),
            "proj.0.bias": np.zeros(in_dim * 2, np.float32),
            "proj.2.weight": r(tokens * cross, in_dim * 2),
            "proj.2.bias": np.zeros(tokens * cross, np.float32),
            "norm.weight": np.ones(cross, np.float32),
            "norm.bias": np.zeros(cross, np.float32),
        }
    elif variant == "resampler":
        dim = max(cross, 64)
        proj = {
            "latents": r(1, 16, dim, s=1.0),
            "proj_in.weight": r(dim, embed_dim),
            "proj_in.bias": np.zeros(dim, np.float32),
            "proj_out.weight": r(cross, dim),
            "proj_out.bias": np.zeros(cross, np.float32),
            "norm_out.weight": np.ones(cross, np.float32),
            "norm_out.bias": np.zeros(cross, np.float32),
        }
        for i in range(2):
            pre = f"layers.{i}"
            proj.update({
                f"{pre}.0.norm1.weight": np.ones(dim, np.float32),
                f"{pre}.0.norm1.bias": np.zeros(dim, np.float32),
                f"{pre}.0.norm2.weight": np.ones(dim, np.float32),
                f"{pre}.0.norm2.bias": np.zeros(dim, np.float32),
                f"{pre}.0.to_q.weight": r(dim, dim),
                f"{pre}.0.to_kv.weight": r(2 * dim, dim),
                f"{pre}.0.to_out.weight": r(dim, dim),
                f"{pre}.1.0.weight": np.ones(dim, np.float32),
                f"{pre}.1.0.bias": np.zeros(dim, np.float32),
                f"{pre}.1.1.weight": r(4 * dim, dim),
                f"{pre}.1.1.bias": np.zeros(4 * dim, np.float32),
                f"{pre}.1.3.weight": r(dim, 4 * dim),
                f"{pre}.1.3.bias": np.zeros(dim, np.float32),
            })
    else:
        raise ValueError(f"unknown variant {variant!r}")

    ip = {}
    dims = hidden_dims or cross_attn_hidden_dims(unet_cfg)
    for li, hidden in enumerate(dims):
        ip[f"{2*li+1}.to_k_ip.weight"] = r(hidden, cross, s=0.05)
        ip[f"{2*li+1}.to_v_ip.weight"] = r(hidden, cross, s=0.05)
    return {"image_proj": proj, "ip_adapter": ip}


def load_ip_adapter(
    unet_params: Dict[str, Any],
    unet_cfg: UNetConfig,
    state_dicts: Sequence[Dict[str, Dict[str, np.ndarray]]],
    dtype=torch.bfloat16,
    device=None,
) -> List[LoadedIPAdapter]:
    """Converts each adapter's projection model, installs every adapter's
    K/V weights into ``unet_params`` (in place) and returns the
    projections."""
    device = resolve_device(device)
    adapters = []
    for sd in state_dicts:
        variant, proj, num_tokens = convert_image_proj(sd["image_proj"],
                                                       dtype, device)
        adapters.append(LoadedIPAdapter(variant, proj, num_tokens))
    install_ip_adapter_weights(unet_params, unet_cfg,
                               [sd["ip_adapter"] for sd in state_dicts],
                               dtype, device)
    return adapters
