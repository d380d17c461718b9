"""Faults planted in the program's timed path, each of which the output
check must see: ``tests/test_portbench_control.py`` runs a whole tiny run
under each, and ``control.py --faults`` reads them at a cell's own size.
``FAULTS`` holds them by the program they break (``programs/<name>.py``).
A cell of one chip has no exchange between chips to leave out.

Stable Diffusion (``sd_inference``):

* ``step_left_unchanged``: one denoising step returns its state unchanged
  (``step``, the first by default). A step near the end of the schedule
  moves the image by less than bfloat16 rounding does, so only the early
  ones are visible in the images; PERF.md gives the readings.
* ``half_batch_left_out``: the second half of a request's images are
  copies of the first half's.
* ``answer_altered``: the first image of a request is mirrored where the
  uint8 images are made.
* ``region_map_dropped``: the region map is not encoded; the request runs
  without spatial control.

HED (``hed_preprocess``), one picture a request and no steps:

* ``edge_map_altered``: the first side output is mirrored where the
  network produces it.
"""

from __future__ import annotations

import contextlib
from unittest import mock


@contextlib.contextmanager
def step_left_unchanged(step: int = 0):
    from diffusionspatialcontrol_tpu_torch.samplers import solvers

    run = solvers._run

    def broken(fn, init, n, **kw):
        def fn2(i, carry):
            return carry if i == step else fn(i, carry)
        return run(fn2, init, n, **kw)

    with mock.patch.object(solvers, "_run", broken):
        yield


@contextlib.contextmanager
def half_batch_left_out():
    from diffusionspatialcontrol_tpu_torch.app import api

    to_host = api._to_host_u8

    def broken(images):
        out = to_host(images).copy()
        half = out.shape[0] // 2
        out[half:] = out[:out.shape[0] - half]
        return out

    with mock.patch.object(api, "_to_host_u8", broken):
        yield


@contextlib.contextmanager
def answer_altered():
    from diffusionspatialcontrol_tpu_torch.pipeline import pipeline

    to_uint8 = pipeline.to_uint8

    def broken(images):
        out = to_uint8(images).clone()
        out[0] = out[0].flip(1)
        return out

    with mock.patch.object(pipeline, "to_uint8", broken):
        yield


@contextlib.contextmanager
def region_map_dropped():
    from diffusionspatialcontrol_tpu_torch.pipeline import pipeline

    with mock.patch.object(pipeline.StableDiffusionTorch, "encode_region",
                           lambda self, *a, **k: None):
        yield


@contextlib.contextmanager
def edge_map_altered():
    from diffusionspatialcontrol_tpu_torch.models import hed

    apply = hed.hed_apply

    def broken(params, pixels):
        outs = apply(params, pixels)
        outs[0] = outs[0].flip(2)
        return outs

    with mock.patch.object(hed, "hed_apply", broken):
        yield


FAULTS = {
    "sd_inference": {"step_left_unchanged": step_left_unchanged,
                     "half_batch_left_out": half_batch_left_out,
                     "answer_altered": answer_altered,
                     "region_map_dropped": region_map_dropped},
    "hed_preprocess": {"edge_map_altered": edge_map_altered},
}
