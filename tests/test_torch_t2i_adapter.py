"""The port's T2I-Adapter (``models/t2i_adapter.py``) against the JAX
package's, on the CPU, fp32, at the tiny UNet's level widths (32, 64, 128,
128): its last level keeps the width of the one before, so it has no
``in_conv`` (``None`` in both trees).

Parameters come from the port's own init, moved to the JAX layout. The
pixel unshuffle is a pure relayout: bit for bit. The adapters: rtol/atol
1e-5 on features of magnitude ~1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.models import t2i_adapter as jt2i
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.convert.from_jax import params_from_jax
from diffusionspatialcontrol_tpu_torch.models import t2i_adapter as tt2i
from tests.test_torch_controlnet import to_jax

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

CHANNELS = (32, 64, 128, 128)
JCFG = jcfg.T2IAdapterConfig(channels=CHANNELS)
TCFG = tcfg.T2IAdapterConfig(channels=CHANNELS)


def _adapter(seed):
    tp = tt2i.t2i_adapter_init(torch.Generator().manual_seed(seed), TCFG,
                               dtype=torch.float32, device="cpu")
    return tp, to_jax(tp)


def _image(seed, batch=2, side=64):
    return np.random.default_rng(seed).random((batch, side, side, 3)).astype(
        np.float32)


def test_configs_equal_jax():
    import dataclasses

    for j, t in ((jcfg.T2IAdapterConfig(), tcfg.T2IAdapterConfig()),
                 (jcfg.ControlNetConfig(), tcfg.ControlNetConfig())):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("factor,shape", [(8, (2, 64, 48, 3)),
                                          (2, (1, 6, 4, 5))])
def test_pixel_unshuffle_is_bitwise_jax(factor, shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jt2i._pixel_unshuffle(jnp.asarray(x), factor))
    got = tt2i._pixel_unshuffle(torch.from_numpy(x), factor).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want)
    # torch's own PixelUnshuffle orders the channels the same way (C, fh, fw)
    ref = torch.nn.functional.pixel_unshuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1)
    assert torch.equal(ref, torch.from_numpy(got))


def test_init_tree_has_jax_structure_with_none():
    tp, _ = _adapter(0)
    want = jax.eval_shape(lambda: jt2i.t2i_adapter_init(
        jax.random.PRNGKey(0), JCFG, jnp.float32))
    assert [b["in_conv"] is None for b in tp["blocks"]] == \
        [False, False, False, True]
    assert [b["in_conv"] is None for b in want["blocks"]] == \
        [False, False, False, True]
    assert jax.tree_util.tree_map(lambda a: a.shape, to_jax(tp)) == \
        jax.tree_util.tree_map(lambda a: a.shape, want)
    # a JAX tree with its None leaves converts and round-trips
    back = params_from_jax(jax.tree_util.tree_map(np.asarray, to_jax(tp)),
                           device="cpu")
    assert back["blocks"][3]["in_conv"] is None
    assert torch.equal(back["blocks"][0]["in_conv"]["kernel"],
                       tp["blocks"][0]["in_conv"]["kernel"])


def test_t2i_adapter_apply_matches_jax():
    tp, jp = _adapter(1)
    img = _image(2)
    want = jt2i.t2i_adapter_apply(jp, JCFG, jnp.asarray(img))
    got = tt2i.t2i_adapter_apply(tp, TCFG, torch.from_numpy(img))
    assert [tuple(f.shape) for f in got] == [
        (2, 8, 8, 32), (2, 4, 4, 64), (2, 2, 2, 128), (2, 1, 1, 128)]
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=f"level {i}")


def test_multi_adapter_apply_matches_jax():
    """Two adapters, scales 0.8 and -0.3, on two images, at a size whose
    last pool is odd (96 -> 12, 6, 3, 1: the VALID pool drops a row)."""
    (tp1, jp1), (tp2, jp2) = _adapter(3), _adapter(4)
    imgs = [_image(5, 1, 96), _image(6, 1, 96)]
    want = jt2i.multi_adapter_apply([jp1, jp2], JCFG,
                                    [jnp.asarray(i) for i in imgs],
                                    [0.8, -0.3])
    got = tt2i.multi_adapter_apply([tp1, tp2], TCFG,
                                   [torch.from_numpy(i) for i in imgs],
                                   [0.8, -0.3])
    assert [tuple(f.shape[1:3]) for f in got] == [(12, 12), (6, 6), (3, 3),
                                                  (1, 1)]
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=f"level {i}")
