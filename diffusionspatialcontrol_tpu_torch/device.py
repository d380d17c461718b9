"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The entry points run on the card unless the caller names a device.

    ``None`` means ``cuda``. A CUDA device, named or by default, raises when
    CUDA is not available rather than falling back to the CPU, so a CPU run
    is always an explicit choice (``device="cpu"``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device
