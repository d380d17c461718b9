"""The random init's conv kernels have a converted checkpoint's layout.

``convert/hf.py`` stores every conv kernel (O, I, kh, kw) in a tensor
allocated ``channels_last``; the random init must give the same strides,
the 1x1 kernels too (``.contiguous(memory_format=torch.channels_last)``
keeps a contiguous 1x1 kernel's strides, and cuDNN then copies it at every
call), with the same values bit for bit. Checked against the converter on a
checkpoint written from the init's own tree (the pipeline and a
ControlNet), and for the face networks' inits against the strides of a
``channels_last`` allocation.
"""

import os

import torch

import chip_smoke
from diffusionspatialcontrol_tpu_torch import tiny_config
from diffusionspatialcontrol_tpu_torch.convert import hf
from diffusionspatialcontrol_tpu_torch.convert.safetensors import save_file
from diffusionspatialcontrol_tpu_torch.models import arcface, face_detect
from diffusionspatialcontrol_tpu_torch.models.controlnet import (
    controlnet_init,
)
from diffusionspatialcontrol_tpu_torch.models.factory import (
    init_pipeline_params,
)

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)


def _kernels(tree, path=""):
    """(path, tensor) of every 4-d leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(path, tree)] if isinstance(tree, torch.Tensor) and \
            tree.dim() == 4 else []
    return [kv for k, v in items for kv in _kernels(v, f"{path}/{k}")]


def _assert_same_kernels(init, converted):
    got, want = dict(_kernels(init)), dict(_kernels(converted))
    assert got.keys() == want.keys()
    assert any(t.shape[2:] == (1, 1) for t in got.values())
    for path, t in got.items():
        assert t.stride() == want[path].stride(), path
        assert torch.equal(t, want[path]), path


def test_pipeline_init_has_the_converted_strides(tmp_path):
    cfg = tiny_config()
    params = init_pipeline_params(0, cfg, torch.float32, device="cpu")
    chip_smoke.write_diffusers_checkpoint(params, str(tmp_path),
                                          dtype=torch.float32)
    loaded = hf.load_pipeline_params(str(tmp_path), cfg, torch.float32,
                                     device="cpu")
    _assert_same_kernels(params, loaded)


def test_controlnet_init_has_the_converted_strides(tmp_path):
    """The zero convs (``conv_init(zero=True)``) among them."""
    unet_cfg = tiny_config().unet
    cn = controlnet_init(torch.Generator().manual_seed(0), unet_cfg,
                         dtype=torch.float32, device="cpu")
    path = os.path.join(tmp_path, "diffusion_pytorch_model.safetensors")
    save_file(chip_smoke.diffusers_state_dict(cn), path)
    loaded = hf.convert_controlnet(hf.load_state_dict(str(tmp_path)),
                                   unet_cfg, torch.float32, "cpu")
    _assert_same_kernels(cn, loaded)


def test_face_net_inits_are_channels_last():
    g = torch.Generator().manual_seed(0)
    for tree in (face_detect.scrfd_init(g, face_detect.FACEDETECT_TINY,
                                        torch.float32, "cpu"),
                 arcface.arcface_init(g, arcface.ARCFACE_TINY,
                                      torch.float32, "cpu")):
        kernels = _kernels(tree)
        assert any(t.shape[2:] == (1, 1) for _, t in kernels)
        for path, t in kernels:
            assert t.stride() == torch.empty(
                t.shape, memory_format=torch.channels_last).stride(), path
