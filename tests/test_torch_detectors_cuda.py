"""The control preprocessors on the card against their CPU runs.

Marked ``cuda``: they need a CUDA device, and skip without one. This file
imports only torch, numpy and the port (no JAX), so it runs on a machine
with a card and no JAX; ``--noconftest`` skips tests/conftest.py, which
imports JAX:

    python -m pytest tests/test_torch_detectors_cuda.py -m cuda -q --noconftest

Two detector networks (DPT and MLSD, random weights at small widths, fp32
with TF32 off) on CUDA tensors within 1e-4 of their largest output value of
the same network on the CPU, HED's detector (its tail a kernel on the card)
within the same tolerance of its CPU run, and the OpenCV replacements
(``ops/cv.py``: elementwise float32 ops only) on CUDA tensors bit for bit
equal to their CPU runs.
"""

import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu_torch.models import dpt, hed, mlsd
from diffusionspatialcontrol_tpu_torch.ops import cv
from diffusionspatialcontrol_tpu_torch.ops.kernels import hed_fuse

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32


def _close(card, host, tol=1e-4):
    card, host = card.float().cpu().numpy(), host.float().numpy()
    assert card.shape == host.shape
    np.testing.assert_allclose(card, host, rtol=0,
                               atol=tol * np.abs(host).max())


@pytest.mark.cuda
def test_dpt_on_the_card_matches_the_cpu(dev):
    cfg = dpt.DPT_FALLBACK
    sd = dpt.random_state_dict(cfg, seed=1)
    x = torch.from_numpy((np.random.RandomState(1).rand(1, 128, 192, 3)
                          * 2 - 1).astype(np.float32))
    host = dpt.dpt_apply(dpt.convert_dpt(sd, cfg, "cpu"), cfg, x)
    card = dpt.dpt_apply(dpt.convert_dpt(sd, cfg, dev), cfg, x.to(dev))
    _close(card, host)


@pytest.mark.cuda
def test_mlsd_on_the_card_matches_the_cpu(dev):
    cfg = mlsd.MLSDConfig(stem=8, stage_widths=(4, 6, 8, 8, 12), decoder=8)
    sd = mlsd.random_state_dict(cfg, seed=1)
    x = torch.from_numpy((np.random.RandomState(2).rand(1, 128, 128, 4)
                          * 2 - 1).astype(np.float32))
    host = mlsd.mlsd_apply(mlsd.convert_mlsd(sd, "cpu"), x)
    card = mlsd.mlsd_apply(mlsd.convert_mlsd(sd, dev), x.to(dev))
    _close(card, host)


@pytest.mark.cuda
@pytest.mark.parametrize("scribble", [False, True])
def test_hed_on_the_card_matches_the_cpu(dev, monkeypatch, scribble):
    """A 100 x 130 picture (padded to 112 x 144, so the tail crops): one
    tail kernel a call. Scribble thins the card's one-channel map on the
    host: that map within the tolerance of the CPU's soft map, the sketch
    its thinning bit for bit (a threshold may flip a pixel between two
    maps that differ in their last bits)."""
    sd = hed.random_state_dict(hed.HEDConfig((8, 12, 16, 16, 24)), seed=1)
    img = (np.random.RandomState(2).rand(100, 130, 3) * 255).astype(
        np.uint8)
    host = hed.detect_edges(hed.convert_hed(sd, "cpu"), img)
    params = hed.convert_hed(sd, dev)
    launches = hed_fuse.hed_tail.launches
    if scribble:
        thin, seen = hed._nms_thin, []
        monkeypatch.setattr(hed, "_nms_thin",
                            lambda e: thin(seen.append(e.copy()) or e))
        card = hed.detect_edges(params, img, scribble=True)
        _close(torch.from_numpy(seen[0]), torch.from_numpy(host[..., 0]))
        np.testing.assert_array_equal(card, np.stack([thin(seen[0])] * 3,
                                                     -1))
    else:
        card = hed.detect_edges(params, img)
        assert card.dtype == np.float32 and card.flags.c_contiguous
        _close(torch.from_numpy(card), torch.from_numpy(host))
    assert hed_fuse.hed_tail.launches == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 96, 64, 48), (100, 130, 64, 64),
                                   (40, 56, 96, 96), (513, 333, 512, 512)])
def test_resize_area_on_the_card_is_the_cpus(dev, shape):
    h, w, oh, ow = shape
    img = torch.from_numpy((np.random.RandomState(h).rand(h, w, 3) * 255)
                           .astype(np.float32))
    for x in (img, img[..., 0].contiguous()):
        assert torch.equal(cv.resize_area(x.to(dev), ow, oh).cpu(),
                           cv.resize_area(x, ow, oh))


@pytest.mark.cuda
def test_sobel_and_draw_line_on_the_card_are_the_cpus(dev):
    d = torch.from_numpy(((np.random.RandomState(3).rand(37, 91) - 0.3) * 10)
                         .astype(np.float32))
    for dx, dy in ((1, 0), (0, 1)):
        assert torch.equal(cv.sobel(d.to(dev), dx, dy).cpu(),
                           cv.sobel(d, dx, dy))
    host, card = torch.zeros(40, 50), torch.zeros(40, 50, device=dev)
    for p in ((-10, 3, 70, 30), (5, 39, 45, 0), (20, -5, 21, 60)):
        cv.draw_line(host, p[:2], p[2:])
        cv.draw_line(card, p[:2], p[2:])
    assert torch.equal(card.cpu(), host)
