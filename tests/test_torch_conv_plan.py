"""The launch plan of K4's and K5's bf16 bodies (``conv_plan``), in pure
Python: on every resnet conv of SD1.5 (UNet and VAE decoder, 512^2 and
1024^2) the grid fills the card's 132 SMs, splitting the C_in chunks only
where the output tiles alone would not, each split takes its chunks once,
and the split-K workspace stays within a stated bound."""

import pytest
import torch

import chip_smoke
from diffusionspatialcontrol_tpu_torch import sd15_config
from diffusionspatialcontrol_tpu_torch.ops.kernels import conv_fused as kc

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

# fp32 partials of at most 2 * SMS blocks of 128 pixels x 128 channels: a
# split launch has fewer than SMS tiles, each split into at most
# ceil(SMS / tiles) blocks, so fewer than 2 * SMS blocks in all.
WS_BOUND = 4 * 2 * kc.SMS * 128 * kc.TILE_N  # 17.3 MB


def _sd15_shapes():
    shapes = []
    for size in (512, 1024):
        for sh in chip_smoke.resnet_conv_shapes(sd15_config(), size, size):
            if sh[1:6] not in shapes:
                shapes.append(sh[1:6])
    return shapes


def _check_plan(version, b, h, w, c_in, c_out):
    plan = kc.conv_plan(version, b, h, w, c_in, c_out)
    base = plan.tiles_m * plan.tiles_n
    # the tiles cover the output: every pixel (K5's strips also cover the
    # padding between the images' rows) and every output channel
    if version == "K5" and plan.tile == 1:
        assert plan.tiles_m * 128 >= b * (h + 2) * (w + 2) - 2 * (w + 2)
    else:
        assert plan.tiles_m * plan.tile_pixels >= b * h * w
    assert plan.tiles_n * kc.TILE_N >= c_out
    assert plan.chunks * plan.chunk >= c_in > (plan.chunks - 1) * plan.chunk
    # split only where the tiles alone leave SMs idle, and then enough
    assert (plan.splits > 1) == (base < kc.SMS) or plan.chunks == 1
    assert plan.blocks == base * plan.splits
    # each chunk taken exactly once, in order, by a non-empty split
    ranges = plan.chunk_ranges()
    assert len(ranges) == plan.splits
    assert [c for c0, c1 in ranges for c in range(c0, c1)] == list(
        range(plan.chunks))
    assert all(c1 > c0 for c0, c1 in ranges)
    assert plan.ws_bytes <= WS_BOUND
    assert (plan.ws_bytes == 0) == (plan.splits == 1)
    return plan


@pytest.mark.parametrize("version", ["K4", "K5"])
def test_sd15_plans_fill_the_card(version):
    """At 16^2 and 8^2 the tiles alone are 20-80 blocks; split, every
    SD1.5 resnet conv runs at least 132 blocks."""
    shapes = _sd15_shapes()
    assert len(shapes) == 37
    split = 0
    for shape in shapes:
        plan = _check_plan(version, *shape)
        assert plan.blocks >= kc.SMS, (shape, plan)
        split += plan.splits > 1
    assert split >= 8  # the 16^2 and 8^2 levels of the UNet at 512^2


@pytest.mark.parametrize("version", ["K4", "K5"])
def test_plans_of_ragged_and_small_shapes(version):
    """Channels in multiples of 8 below, between and above the chunk and
    tile sizes, and maps down to one pixel: the split still takes every
    chunk once and the workspace stays bounded."""
    for b, h, w in ((1, 1, 1), (2, 7, 13), (1, 8, 8), (2, 9, 3), (1, 3, 130)):
        for c_in in (8, 16, 24, 64, 136, 640, 2560):
            for c_out in (8, 40, 128, 136, 1280):
                _check_plan(version, b, h, w, c_in, c_out)


def test_split_shapes_of_the_card_tests():
    """The card tests' SPLIT_SHAPES split in both kernels; the others that
    reach 132 blocks without a split do not."""
    for shape in ((2, 8, 8, 2560, 1280), (2, 16, 16, 1280, 1280)):
        for version in ("K4", "K5"):
            assert kc.conv_plan(version, *shape).splits > 1
    assert kc.conv_plan("K4", 2, 64, 64, 320, 320).splits == 1
    assert kc.conv_plan("K5", 1, 1024, 1024, 128, 128).splits == 1
    with pytest.raises(ValueError):
        kc.conv_plan("K6", 1, 8, 8, 8, 8)
