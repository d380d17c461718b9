"""The fused resnet convs (K4 ``"pallas"``, K5 ``"pallas2"``) at the large
requests' sizes: 1088 x 1920, and 512^2 and 768^2 at batch 4.

``chip_smoke.jax_conv_route`` restates where the JAX package's wrappers send
each conv (K4a, K4b, or no tile and unfused convs; whether K5 fits); it is
held here to the JAX package's own searches on every resnet conv of SD1.5 at
those sizes, and ``chip_smoke.jax_route`` (the route of a launch as the
wrappers tally it, without the skip) to the JAX resnet's fallback, which
runs both convs unfused when either has no tile. The port's fused resnet is
held to the JAX package's at a ragged map (the UNet's 17 x 30 level at
1088 x 1920, at tiny widths; the JAX kernels interpreted), with
tests/test_torch_conv_fused.py's tolerance, and ``resnet_conv_shapes`` to
the calls the port makes at a non-square size and at batch 4.
"""

import collections

import numpy as np
import pytest
import torch

import chip_smoke
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.models import unet as tunet
from diffusionspatialcontrol_tpu_torch.models import vae as tvae
from diffusionspatialcontrol_tpu_torch.ops.kernels import conv_fused as tconv
from diffusionspatialcontrol_tpu_torch.ops.kernels import hed_fuse

from test_torch_conv_fused import _jax_routes, _resnet_case

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

# (height, width, batch, with the encoder) -> the JAX package's K4 bodies
# by where (None: no tile, unfused convs) and its K5 convs that find no tile
ROUTES = {
    (512, 512, 1, True): ({("unet", "K4a"): 44, ("vae", "K4a"): 10,
                           ("vae", "K4b"): 18, ("vae_enc", "K4b"): 12,
                           ("vae_enc", "K4a"): 8}, 0),
    (1024, 1024, 1, False): ({("unet", "K4a"): 34, ("unet", "K4b"): 10,
                              ("vae", "K4b"): 28}, 0),
    (1088, 1920, 1, False): ({("unet", "K4a"): 24, ("unet", "K4b"): 20,
                              ("vae", "K4b"): 22, ("vae", None): 6}, 6),
    (512, 512, 4, False): ({("unet", "K4a"): 44, ("vae", "K4a"): 10,
                            ("vae", "K4b"): 18}, 0),
    (768, 768, 4, False): ({("unet", "K4a"): 34, ("unet", "K4b"): 10,
                            ("vae", "K4b"): 28}, 0),
}


@pytest.mark.parametrize("size", chip_smoke.CONV_SIZES,
                         ids=lambda s: "x".join(map(str, s[:3])))
def test_jax_route_is_the_jax_searches_and_resnet_fallback(size):
    """Every resnet conv of SD1.5 (bf16): the restated route equals the JAX
    package's tile searches conv by conv; ``jax_route`` equals the route
    of the JAX resnet the conv belongs to (a resnet without a tile for one
    of its two convs runs both unfused); and the counts are the table's:
    at 1088 x 1920 the decoder's 1920-wide level (3 resnets, 6 convs) has
    no tile for either body."""
    height, width, batch, encoder = size
    shapes = chip_smoke.resnet_conv_shapes(tcfg.sd15_config(), height, width,
                                           batch=batch, encoder=encoder)
    convs = [_jax_routes(h, w, c_in, c_out, skip)
             for _, _, h, w, c_in, c_out, _, skip in shapes]
    for sh, route in zip(shapes, convs):
        assert chip_smoke.jax_conv_route(*sh[2:6], sh[7]) == route, sh
    # resnet_conv_shapes lists each resnet's conv1, then its conv2
    k4s, k5s = collections.Counter(), 0
    for i in range(0, len(shapes), 2):
        (a4, a5), (b4, b5) = convs[i], convs[i + 1]
        for sh, k4 in zip(shapes[i:i + 2], (a4, b4)):
            resnet = (k4 if a4 and b4 else None, a5 and b5)
            assert chip_smoke.jax_route(*sh[2:6]) == resnet, sh
            k4s[sh[0], resnet[0]] += 1
            k5s += not resnet[1]
    assert (dict(k4s), k5s) == ROUTES[size]


def _served_shapes():
    """Every (H, W, C_in, C_out) of a fused launch that chip_smoke.py makes:
    SD1.5 at phase kernels' sizes, the tiny model at phase tiny's."""
    out = set()
    for height, width, batch, encoder in chip_smoke.CONV_SIZES:
        out.update(sh[2:6] for sh in chip_smoke.resnet_conv_shapes(
            tcfg.sd15_config(), height, width, batch, encoder=True))
    for height, width in ((64, 64), (128, 128), (128, 192)):
        out.update(sh[2:6] for sh in chip_smoke.resnet_conv_shapes(
            tcfg.tiny_config(), height, width, encoder=True))
    return out


def test_the_skip_never_decides_a_served_route():
    """The launch tallies keep no skip flag: on every served shape the
    route is the same with and without it, and where it is not, jax_route
    raises instead of guessing."""
    for shape in _served_shapes():
        chip_smoke.jax_route(*shape)
    with pytest.raises(ValueError, match="skip"):
        chip_smoke.jax_route(38, 128, 128, 128)


@pytest.mark.parametrize("conv_impl", ["pallas", "pallas2"])
def test_counts_label_the_large_launches_as_want_launches(monkeypatch,
                                                          conv_impl):
    """``_counts`` labels a tally of one 1088 x 1920 request's fused
    launches (25 UNet calls on the CFG pair, one decode) as
    ``want_launches`` expects: 1128 launches, of which 522 at K4b shapes
    and 6 where the JAX package runs unfused convs."""
    cfg = tcfg.sd15_config()
    shapes = chip_smoke.resnet_conv_shapes(cfg, *chip_smoke.LARGE)
    tally = collections.Counter()
    for sh in shapes:
        tally[sh[1:6]] += chip_smoke.STEPS if sh[0] == "unet" else 1
    wrappers = chip_smoke._wrappers()
    for name, fn in wrappers.items():
        mine = name == ("K4" if conv_impl == "pallas" else "K5")
        monkeypatch.setattr(fn, "launches", sum(tally.values()) if mine
                            else 0)
        monkeypatch.setattr(fn, "shapes", tally if mine
                            else collections.Counter())
    want = chip_smoke.want_launches(cfg, chip_smoke.LARGE, chip_smoke.STEPS,
                                    True, conv_impl)
    got = chip_smoke._counts()
    for key in ("K4", "K5", "K4b", "K4 JAX-unfused", "K5 JAX-unfused"):
        assert got[key] == want[key], key
    name = "K4" if conv_impl == "pallas" else "K5"
    assert want[name] == 44 * chip_smoke.STEPS + 28 == 1128
    assert want[f"{name} JAX-unfused"] == 6
    assert want["K4b"] == (20 * chip_smoke.STEPS + 22
                           if conv_impl == "pallas" else 0)


def test_counts_and_want_launches_share_their_labels(monkeypatch):
    """Every label ``_counts`` tallies is one ``want_launches`` expects, so
    a request's launches compare whole; HED's tail kernel, which no
    diffusion request launches, is read from its wrapper, expected at 0
    and reset by ``_reset_counts`` with the others."""
    for fn in chip_smoke._wrappers().values():
        monkeypatch.setattr(fn, "launches", 5)
        monkeypatch.setattr(fn, "shapes", collections.Counter())
    monkeypatch.setattr(hed_fuse.hed_tail, "launches", 3)
    got = chip_smoke._counts()
    want = chip_smoke.want_launches(tcfg.sd15_config(), 512,
                                    chip_smoke.STEPS, True, "xla")
    assert set(got) == set(want)
    assert got["HED tail"] == 3 and want["HED tail"] == 0
    chip_smoke._reset_counts()
    assert set(chip_smoke._counts().values()) == {0}


@pytest.mark.parametrize("height,width,batch", [(64, 192, 1), (64, 64, 4)])
def test_conv_shapes_are_the_calls_at_a_wide_size_and_batch_4(
        monkeypatch, height, width, batch):
    """resnet_conv_shapes at a non-square size (its deepest UNet level
    1 x 3: an odd side, as 1088 x 1920's 17 x 30) and at batch 4 (the UNet
    on the CFG pair, B = 8) lists exactly the fused convs the tiny UNet and
    VAE decoder make."""
    calls = []
    plain = tconv.gn_silu_conv3x3_plain

    def record(x, scale, bias, kernel, conv_bias, channel_bias=None,
               skip=None):
        calls.append((*x.shape, kernel.shape[0], channel_bias is not None,
                      skip is not None))
        return plain(x, scale, bias, kernel, conv_bias, channel_bias, skip)

    monkeypatch.setattr(tconv, "gn_silu_conv3x3_plain", record)
    cfg = tcfg.tiny_config()
    g = torch.Generator().manual_seed(0)
    lh, lw = height // 8, width // 8
    cond = tunet.UNetCond(context=torch.zeros(2 * batch, 77, 64))
    tunet.unet_apply(tunet.unet_init(g, cfg.unet, torch.float32, "cpu"),
                     cfg.unet, torch.zeros(2 * batch, lh, lw, 4),
                     torch.full((2 * batch,), 10.0), cond,
                     conv_impl="pallas")
    tvae.vae_decode(tvae.vae_init(g, cfg.vae, torch.float32, "cpu"),
                    cfg.vae, torch.zeros(batch, lh, lw, 4),
                    conv_impl="pallas2")
    shapes = chip_smoke.resnet_conv_shapes(cfg, height, width, batch=batch)
    assert calls == [s[1:] for s in shapes]
    assert {s[1] for s in shapes if s[0] == "unet"} == {2 * batch}
    assert {s[1] for s in shapes if s[0] == "vae"} == {batch}


@pytest.mark.parametrize("conv_impl", ["pallas", "pallas2"])
@pytest.mark.parametrize("where", ["unet", "vae"])
def test_resnet_matches_jax_fused_resnet_at_a_ragged_map(where, conv_impl):
    """One resnet (with a conv shortcut) on a 17 x 30 map, which fills
    neither 8 x 16 tiles nor 16-pixel rows, through the fused path against
    the JAX resnet with the same conv_impl (its Pallas kernels
    interpreted), at tests/test_torch_conv_fused.py's tolerance."""
    got, want = _resnet_case(where, conv_impl, hw=(17, 30))
    assert got.shape == want.shape == (2, 17, 30, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
