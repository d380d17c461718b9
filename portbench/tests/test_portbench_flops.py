"""The analytic operation counts (``flops.py``) against
``torch.utils.flop_counter`` over the plain reference at a small size, and
the weight specs against the port's own checkpoint converters (CPU)."""

import copy
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, spec, weights
from portbench.reference import stable_diffusion as ref
from portbench.tests import helpers

torch.set_num_threads(2)


def _tiny(name):
    cfg = helpers.tiny_config()
    if name == "sd21v":
        base = json.loads((spec.HERE / "configs" / "sd21v.json").read_text())
        cfg["unet"].update({k: base["unet"][k] for k in (
            "use_linear_projection", "upcast_attention")})
        cfg["unet"]["attention_head_dim"] = [1, 2, 4, 4]
        cfg["text_encoder"]["hidden_act"] = "gelu"
        cfg["scheduler"] = base["scheduler"]
    cfg["dtype"] = "float32"
    return cfg


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("name", ["sd15", "sd21v"])
@pytest.mark.parametrize("size,biased", [((8, 16), True), ((16, 8), False)])
def test_unet_counts_match_the_flop_counter(name, size, biased):
    cfg = _tiny(name)
    w, _ = weights.make(cfg, 3, "cpu")
    ops = ref.Ops(w)
    n, s_ctx = 2, 77
    h, wd = size
    x = torch.randn(n, 4, h, wd)
    ctx = torch.randn(n, s_ctx, cfg["unet"]["cross_attention_dim"])
    region = None
    if biased:
        levels = len(cfg["unet"]["block_out_channels"])
        region = ([torch.randn(n, (-(-h // 2 ** lv)) * (-(-wd // 2 ** lv)),
                               s_ctx) for lv in range(levels)], 1.5)
    unet = ref.UNet(ops, cfg["unet"])
    got = _counted(lambda: unet(x, torch.tensor([10.0, 10.0]), ctx, region))
    want = sum(flops.flops(op) for op in flops.unet_ops(
        cfg["unet"], n, h, wd, s_ctx, biased))
    assert got == want


@pytest.mark.parametrize("name", ["sd15", "sd21v"])
def test_text_encoder_and_decoder_counts_match(name):
    cfg = _tiny(name)
    w, _ = weights.make(cfg, 4, "cpu")
    ops = ref.Ops(w)
    ids = torch.randint(0, 49000, (2, 77))
    got = _counted(lambda: ref.clip_forward(ops, cfg["text_encoder"], ids, 2))
    want = sum(flops.flops(op) for op in flops.clip_ops(
        cfg["text_encoder"], 2, 77, 2))
    assert got == want
    z = torch.randn(1, 4, 6, 10)
    got = _counted(lambda: ref.vae_decode(ops, cfg["vae"], z))
    want = sum(flops.flops(op) for op in flops.vae_decoder_ops(
        cfg["vae"], 1, 6, 10))
    assert got == want


def test_request_count_is_the_parts():
    cfg = json.loads((spec.HERE / "configs" / "sd15.json").read_text())
    req = {"num_images_per_prompt": 4, "height": 768, "width": 768,
           "clip_skip": 2, "steps": 25, "region_state": {"x": {}}}
    total = sum(flops.flops(op) for op in flops.request_ops(cfg, req))
    unet = sum(flops.flops(op) for op in flops.unet_ops(
        cfg["unet"], 8, 96, 96, 77, True))
    clip = sum(flops.flops(op) for op in flops.clip_ops(
        cfg["text_encoder"], 2, 77, 2))
    vae = sum(flops.flops(op) for op in flops.vae_decoder_ops(
        cfg["vae"], 4, 96, 96))
    assert total == 25 * unet + clip + vae
    # one 512^2 UNet row of SD1.5, as torch.utils.flop_counter counts the
    # program's own forward
    row = sum(flops.flops(op) for op in flops.unet_ops(
        cfg["unet"], 1, 64, 64, 77, False))
    assert abs(row / 1e9 - 803.3) < 0.1


def test_least_seconds_takes_the_larger_bound():
    peaks = {"flops_per_s": {"bfloat16": 1e12, "float32": 1e11},
             "hbm_bytes_per_s": 1e10}
    # a 1x1 conv over few channels is bound by its bytes
    op = ("conv", 1, 4, 4, 1, 100, 100, 1)
    assert flops.least_seconds(op, peaks, "bfloat16") == \
        flops.bytes_moved(op) / 1e10
    assert flops.least_seconds(op, peaks, "float32") == \
        flops.bytes_moved(op, 4) / 1e10
    # a wide 3x3 conv by its operations, at the peak of its type
    op = ("conv", 8, 1280, 1280, 3, 32, 32, 1)
    assert flops.least_seconds(op, peaks, "bfloat16") == flops.flops(op) / 1e12
    assert flops.least_seconds(op, peaks, "float32") == flops.flops(op) / 1e11
    # the region bias adds its float32 (N, L, S) bytes
    a = ("attn", 2, 8, 4096, 77, 40, False, "unet")
    b = a[:6] + (True, "unet")
    assert flops.bytes_moved(b) - flops.bytes_moved(a) == 4 * 2 * 4096 * 77


@pytest.mark.parametrize("name", ["sd15", "sd21v"])
def test_weights_are_what_the_port_converts(name):
    """Every tensor the benchmark makes is one the port's converters read,
    and every tensor they read is made."""
    from diffusionspatialcontrol_tpu_torch.convert.hf import (
        StateDict, convert_clip, convert_unet, convert_vae)

    from portbench.programs.sd_inference import port_config

    cfg = _tiny(name)
    w, _ = weights.make(cfg, 5, "cpu")
    pc = port_config(cfg)
    for prefix, conv, sub in (("unet.", convert_unet, pc.unet),
                              ("vae.", convert_vae, pc.vae),
                              ("text_encoder.", convert_clip, pc.clip)):
        sd = StateDict(weights.component(w, prefix))
        conv(sd, sub, torch.float32, device="cpu")
        assert sd.unused() == [], (prefix, sd.unused()[:5])


def test_weights_repeat_by_seed_and_checksum():
    cfg = _tiny("sd15")
    cfg["dtype"] = "bfloat16"
    a, fa = weights.make(cfg, 2 ** 31 + 7, "cpu")
    b, fb = weights.make(cfg, 2 ** 31 + 7, "cpu")
    c, fc = weights.make(cfg, 2 ** 31 + 8, "cpu")
    assert torch.equal(fa, fb)
    assert weights.checksum(fa) == weights.checksum(fb)
    assert weights.checksum(fa) != weights.checksum(fc)
    assert a.keys() == c.keys()
    bias = a["text_encoder.text_model.final_layer_norm.bias"].float()
    assert 0.3 < float(bias.std()) < 0.7
    norm = a["unet.conv_norm_out.weight"].float()
    assert abs(float(norm.mean()) - 1.0) < 0.02


def test_port_config_takes_the_file_groups():
    from portbench.programs.sd_inference import port_config

    for name, heads, proj, pred in (("sd15", (8,) * 4, False, "epsilon"),
                                    ("sd21v", (5, 10, 20, 20), True,
                                     "v_prediction")):
        cfg = json.loads((spec.HERE / "configs" / f"{name}.json")
                         .read_text())
        pc = port_config(copy.deepcopy(cfg))
        assert pc.unet.num_attention_heads == heads
        assert pc.unet.use_linear_projection is proj
        assert pc.unet.attn_levels == (True, True, True, False)
        assert pc.prediction_type == pred
        assert pc.clip.num_layers == cfg["text_encoder"]["num_hidden_layers"]
        assert pc.vae.scaling_factor == 0.18215


@pytest.mark.parametrize("size", [(32, 48), (64, 32)])
def test_hed_counts_match_the_flop_counter(size):
    from portbench.reference import hed as hed_ref

    cfg = helpers.tiny_hed_config()
    h, w = size
    wts, _ = weights.make(cfg, 3, "cpu")
    img = torch.randint(0, 256, (h, w, 3), dtype=torch.uint8).numpy()
    counted = _counted(lambda: hed_ref.generate(
        wts, cfg, {"image": img}, "fp32", "cpu"))
    ops = list(flops.request_ops(cfg, {"height": h, "width": w}))
    convs = sum(flops.flops(op) for op in ops)
    # the flop counter also counts the bilinear resizes as nothing and the
    # convolutions alone, as flops.py does
    assert counted == convs
    assert sum(op[4] == 3 for op in ops) == sum(cfg["hed"]["convs"])


def test_hed_weights_are_what_the_port_converts():
    from diffusionspatialcontrol_tpu_torch.models import hed

    cfg = json.loads((spec.HERE / "configs" / "hed.json").read_text())
    mine, _ = weights.make(cfg, 5, "cpu")
    theirs = hed.random_state_dict(hed.HEDConfig(), seed=0)
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: tuple(v.shape) for k, v in theirs.items()}
    # a 1024 x 768 picture's count, as PERF.md states it
    total = sum(flops.flops(op) for op in flops.request_ops(
        cfg, {"height": 768, "width": 1024}))
    assert abs(total / 1e9 - 481.26) < 0.01
