"""The system under test for the HED configuration: the port's "Soft Edge
(HED)" control preprocessor, as the app's ``/preprocess`` route and a
ControlNet unit reach it, ``ModelManager.get_preprocessor(name)(image)``.

The weights the benchmark made go through the port's own path for a
registered checkpoint: written once, in the published ``ControlNetHED.pth``
layout, to a directory of their own under the run's ``TMPDIR``,
registered with ``ModelManager.register_preprocessor`` and loaded by
``get_preprocessor`` (the port's ``convert_hed``); the file is removed
once loaded.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict

import torch

NAME = "Soft Edge (HED)"


class Program:
    """``run(request)`` -> (the (1, H, W, 3) float32 edge map on the host,
    no ``timings`` phases)."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], device,
                 dtype):
        from diffusionspatialcontrol_tpu_torch.app.api import ModelManager

        self.manager = ModelManager(device=device)
        where = tempfile.mkdtemp(prefix="portbench-hed-")
        try:
            path = os.path.join(where, "ControlNetHED.pth")
            torch.save({k: v.detach().to("cpu", copy=True)
                        for k, v in weights.items()}, path)
            self.manager.register_preprocessor(NAME, path)
            self.detect = self.manager.get_preprocessor(NAME)
        finally:
            shutil.rmtree(where, ignore_errors=True)

    def run(self, req: dict):
        return self.detect(req["image"])[None], {}
