"""LoRA merge into the weights (port of ``convert/lora.py``).

The reference's kohya-format merging (source/app.py:532-597
``load_lora_control_pipeline``): for every ``lora_unet_*`` / ``lora_te*_*``
down/up pair,

    W += lora_scale * up @ down

straight into the target weight, with the user's scale alone (``.alpha``
keys are skipped, as the reference does). Linear layers, 1x1 convs and
full kxk conv pairs (``einsum("or,rihw->oihw")``); the diffusers/PEFT names
(``lora_A``/``lora_B``) too.

The arithmetic is the JAX package's: numpy fp32 on the host, the kernel
widened to fp32, ``kernel + scale * delta`` and one cast to the leaf's
dtype, so the merged leaves equal the JAX package's bit for bit (the port's
kernels are (out, in) and OIHW where the JAX package's are transposed,
which changes no value). No matmul runs on the card, where TF32 could
round differently. A merged kernel replaces the tensor in its dict (the
caller passes a copy of the tree's containers, so the tensors of the tree
it came from stay as they were) and keeps ``channels_last``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _module_index(tree) -> Dict[str, Tuple]:
    """name (diffusers dotted, e.g. down_blocks.0.attentions.0.
    transformer_blocks.0.attn1.to_q) -> path tuple into the tree."""
    out: Dict[str, Tuple] = {}

    def walk(node, path, names, in_ff):
        if isinstance(node, dict):
            if "kernel" in node:
                out[".".join(names)] = tuple(path)
                return
            for k, v in node.items():
                seg = k
                nxt_ff = in_ff
                if k == "blocks":
                    seg = "transformer_blocks"
                elif k == "ff":
                    nxt_ff = True
                elif k == "proj_in" and in_ff:
                    seg = "net.0.proj"
                elif k == "proj_out" and in_ff:
                    seg = "net.2"
                elif k == "to_out":
                    seg = "to_out.0"
                elif k == "downsample":
                    seg = "downsamplers.0.conv"
                elif k == "upsample":
                    seg = "upsamplers.0.conv"
                elif k == "resnet1":
                    seg = "resnets.0"
                elif k == "resnet2":
                    seg = "resnets.1"
                elif k == "attention" and names and names[-1] == "mid_block":
                    seg = "attentions.0"
                walk(v, path + [k], names + [seg], nxt_ff)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [i], names + [str(i)], in_ff)

    walk(tree, [], [], False)
    return out


_CLIP_RENAMES = {
    "q_proj": "self_attn.q_proj",
    "k_proj": "self_attn.k_proj",
    "v_proj": "self_attn.v_proj",
    "out_proj": "self_attn.out_proj",
    "fc1": "mlp.fc1",
    "fc2": "mlp.fc2",
}


def _clip_module_index(tree) -> Dict[str, Tuple]:
    out: Dict[str, Tuple] = {}
    for i, layer in enumerate(tree.get("layers", [])):
        for k in layer:
            if isinstance(layer[k], dict) and "kernel" in layer[k]:
                name = _CLIP_RENAMES.get(k, k)
                out[f"text_model.encoder.layers.{i}.{name}"] = (
                    "layers", i, k)
    return out


def _get(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return node


def _normalize(name: str) -> str:
    return name.replace(".", "_")


def _f32(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()
    return np.asarray(value, np.float32)


def merged_kernel(kernel: torch.Tensor, up: np.ndarray, down: np.ndarray,
                  scale: float) -> torch.Tensor:
    """``kernel + scale * up @ down`` in numpy fp32, cast once to the
    kernel's dtype, on its device and in its memory format."""
    w = _f32(kernel)
    if up.ndim == 4:
        up2 = up.reshape(up.shape[0], up.shape[1])
        if down.shape[2:] == (1, 1):
            delta = (up2 @ down.reshape(down.shape[0], down.shape[1]))
        else:
            delta = np.einsum("or,rihw->oihw", up2, down)
    else:
        delta = up @ down
    if delta.ndim != w.ndim:  # a linear pair on a conv, or the other way
        delta = delta.reshape(delta.shape[:2] + (1,) * (w.ndim - 2))
    new = torch.from_numpy(w + scale * delta).to(kernel.dtype)
    fmt = (torch.channels_last if new.dim() == 4
           else torch.contiguous_format)
    return new.to(kernel.device).contiguous(memory_format=fmt)


def merge_lora(params: Dict[str, Any], state_dict: Dict[str, Any],
               scale: float = 1.0) -> Dict[str, Any]:
    """Merge a LoRA state dict (name -> tensor or array) into {unet, clip}
    params: each merged kernel replaces the tensor in its dict. Returns
    params."""
    unet_index = {
        _normalize(k): v for k, v in _module_index(params["unet"]).items()
    }
    clip_index = {
        _normalize(k): v
        for k, v in _clip_module_index(params["clip"]).items()
    }

    pairs: Dict[str, Dict[str, np.ndarray]] = {}
    for key, val in state_dict.items():
        m = re.match(
            r"(lora_unet|lora_te\d*)_(.+)\.(lora_down|lora_up|lora_A|lora_B)"
            r"\.weight",
            key,
        )
        if not m:
            continue
        prefix, module, role = m.group(1), m.group(2), m.group(3)
        role = {"lora_A": "down", "lora_B": "up",
                "lora_down": "down", "lora_up": "up"}[role]
        pairs.setdefault(f"{prefix}_{module}", {})[role] = _f32(val)

    merged = 0
    skipped: List[str] = []
    for module, pair in pairs.items():
        if "down" not in pair or "up" not in pair:
            skipped.append(module)
            continue
        is_te = module.startswith("lora_te")
        name = re.sub(r"^(lora_unet_|lora_te\d*_)", "", module)
        index = clip_index if is_te else unet_index
        tree = params["clip"] if is_te else params["unet"]
        if name not in index:
            skipped.append(module)
            continue
        node = _get(tree, index[name])
        node["kernel"] = merged_kernel(node["kernel"], pair["up"],
                                       pair["down"], scale)
        merged += 1

    if merged == 0 and pairs:
        raise ValueError(
            f"no LoRA modules matched; examples: {list(pairs)[:5]}"
        )
    return params
