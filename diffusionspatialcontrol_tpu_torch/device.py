"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The entry points run on the card unless the caller names a device.

    ``None`` means ``cuda``; it raises when CUDA is not available rather than
    falling back to the CPU, so a CPU run is always an explicit choice
    (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
