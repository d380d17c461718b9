"""Converted-checkpoint cache (port of ``convert/cache.py``).

A converted parameter tree is snapshotted once and read back on any later
process without converting again. The snapshot is one safetensors file
(``convert/safetensors.py``): every tensor under its path in the tree
(``unet/down_blocks/0/resnets/0/conv1/kernel``), and in the metadata the
tree's structure (dict keys, list positions, ``None`` leaves; a tensor's
place holds its path) and which tensors are stored ``channels_last``. The
JAX package keeps an orbax checkpoint; orbax is not on the card's
machine.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import torch

from ..device import resolve_device
from .safetensors import load_file, load_metadata, save_file

_FORMAT = "diffusionspatialcontrol-tree-1"


def _flatten(tree, path, tensors, channels_last):
    if isinstance(tree, dict):
        return {k: _flatten(v, f"{path}/{k}" if path else k, tensors,
                            channels_last) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flatten(v, f"{path}/{i}" if path else str(i), tensors,
                         channels_last) for i, v in enumerate(tree)]
    if tree is None:
        return None
    tensors[path] = tree
    if tree.dim() == 4 and tree.stride() == torch.empty(
            tree.shape, device="meta",
            memory_format=torch.channels_last).stride():
        channels_last.append(path)
    return path


def save_params(path: str, params: Dict[str, Any]) -> None:
    """Snapshot ``params`` (tensors on any device) to the file ``path``; it
    replaces an earlier one only once it is written whole."""
    tensors: Dict[str, torch.Tensor] = {}
    channels_last: list = []
    structure = _flatten(params, "", tensors, channels_last)
    tmp = f"{path}.tmp"
    save_file(tensors, tmp, metadata={
        "format": _FORMAT, "tree": json.dumps(structure),
        "channels_last": json.dumps(channels_last)})
    os.replace(tmp, path)


def _restore(node, tensors, channels_last, device):
    if isinstance(node, list):
        return [_restore(v, tensors, channels_last, device) for v in node]
    if isinstance(node, str):
        t = tensors[node]
        fmt = (torch.channels_last if node in channels_last
               else torch.contiguous_format)
        out = torch.empty(t.shape, dtype=t.dtype, device=device,
                          memory_format=fmt)
        return out.copy_(t)
    if isinstance(node, dict):
        return {k: _restore(v, tensors, channels_last, device)
                for k, v in node.items()}
    return node


def load_params(path: str, device=None) -> Dict[str, Any]:
    """The tree ``save_params`` wrote, each tensor in its dtype and memory
    format on ``device`` (CUDA by default; it raises when there is none)."""
    device = resolve_device(device)
    meta = load_metadata(path)
    if meta.get("format") != _FORMAT:
        raise ValueError(f"{path} is not a parameter-tree snapshot")
    return _restore(json.loads(meta["tree"]), load_file(path),
                    set(json.loads(meta["channels_last"])), device)


def cached_convert(model_dir: str, cache_dir: str, cfg, dtype,
                   n_extra_tokens: int = 64, device=None) -> Dict[str, Any]:
    """Convert a diffusers checkpoint, snapshotting the tree under
    ``cache_dir`` keyed by the model directory's name and the config's;
    later calls restore it."""
    key = os.path.basename(os.path.normpath(model_dir))
    snap = os.path.join(cache_dir, f"{key}-{cfg.name}")
    if os.path.exists(snap):
        return load_params(snap, device)
    from .hf import load_pipeline_params

    params = load_pipeline_params(model_dir, cfg, dtype, n_extra_tokens,
                                  device)
    os.makedirs(cache_dir, exist_ok=True)
    save_params(snap, params)
    return params
