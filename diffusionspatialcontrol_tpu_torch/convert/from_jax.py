"""Convert the JAX package's parameter tree to the port's.

The tree comes in as nested dicts and lists of **numpy** arrays (the caller
applies ``np.asarray`` to each leaf), so this module imports no JAX.
Structure and names are kept; layouts change where PyTorch's differ:

* a conv ``kernel`` (4-d) goes from HWIO to OIHW (stored ``channels_last``);
* a linear ``kernel`` (2-d) goes from (in, out) to (out, in);
* everything else (embeddings, norm scales, biases) is copied as it is;
* a ``None`` leaf stays ``None`` (a T2I-Adapter level without ``in_conv``).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..device import resolve_device


def _leaf(name: Optional[str], a: np.ndarray, dtype, device) -> torch.Tensor:
    t = torch.tensor(np.asarray(a))  # a copy: JAX's host arrays are read-only
    if name == "kernel" and t.dim() == 4:
        t = t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    elif name == "kernel" and t.dim() == 2:
        t = t.t().contiguous()
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: Any, dtype: Optional[torch.dtype] = None,
                    device=None, _name: Optional[str] = None) -> Any:
    """The port's parameters from a JAX parameter tree of numpy arrays.
    ``dtype`` (optional) casts every tensor; ``device`` defaults to CUDA and
    raises when there is none."""
    if _name is None:
        device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dtype, device, k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, dtype, device, "") for v in tree]
    if tree is None:
        return None
    return _leaf(_name, np.asarray(tree), dtype, device)
