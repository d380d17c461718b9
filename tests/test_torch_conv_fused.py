"""The port's fused GN+SiLU+conv3x3 path (K4/K5's plain version, the fused
resnets, the whole VAE decode) against the JAX package on the CPU, and the
shapes and routes of the path on SD1.5.

The JAX kernels run as tests/test_conv_fused.py runs them, in interpret
mode. Tolerances are that file's: fp32 5e-5 absolute for one conv, 1e-4 for
one resnet; bf16 2e-2 of the output's largest magnitude (the two sides
round the activation to bf16 from fp32 SiLUs that differ in the last bits);
2e-4 / rtol 1e-3 for a whole decode against the unfused ``xla`` path.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.models import unet as junet
from diffusionspatialcontrol_tpu.models import vae as jvae
from diffusionspatialcontrol_tpu.ops.pallas import conv_fused as jconv
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.convert.from_jax import params_from_jax
from diffusionspatialcontrol_tpu_torch.models import layers as tlayers
from diffusionspatialcontrol_tpu_torch.models import unet as tunet
from diffusionspatialcontrol_tpu_torch.models import vae as tvae
from diffusionspatialcontrol_tpu_torch.ops.kernels import conv_fused as tconv

from test_torch_vae import to_jax

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

_DT = {"fp32": (np.float32, jnp.float32, torch.float32),
       "bf16": (None, jnp.bfloat16, torch.bfloat16)}


def _case(b, h, w, c_in, c_out, seed):
    """numpy fp32 inputs: x, GN (scale, bias), HWIO kernel, conv bias, temb,
    skip."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, h, w, c_in)).astype(f),
            (rng.standard_normal(c_in) * 0.1 + 1.0).astype(f),
            (rng.standard_normal(c_in) * 0.1).astype(f),
            (rng.uniform(-1, 1, (3, 3, c_in, c_out))
             / np.sqrt(9 * c_in)).astype(f),
            (rng.standard_normal(c_out) * 0.1).astype(f),
            rng.standard_normal((b, c_out)).astype(f),
            rng.standard_normal((b, h, w, c_out)).astype(f))


# (shape, groups, temb, skip): tests/test_conv_fused.py:24 with and without
# extras, :77 (7x13, C not a lane multiple) and :159 (C_in = 640)
CASES = [((2, 12, 10, 32, 48), 8, True, True),
         ((2, 12, 10, 32, 48), 8, False, False),
         ((1, 7, 13, 24, 40), 4, True, True),
         ((1, 10, 6, 640, 32), 8, True, False)]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(
    map(str, c[0])) + ("+temb" if c[2] else "") + ("+skip" if c[3] else ""))
def test_plain_matches_jax_fused_kernels(case, dtype):
    (b, h, w, c_in, c_out), groups, with_temb, with_skip = case
    x, g_scale, g_bias, k_hwio, cb, temb, skip = _case(b, h, w, c_in, c_out,
                                                       seed=c_in + w)
    _, jdt, tdt = _DT[dtype]

    def jarr(a, dt=jdt):
        return jnp.asarray(a).astype(dt)

    def tarr(a, dt=tdt):
        return torch.from_numpy(a).to(dt)

    gn_j = {"scale": jarr(g_scale), "bias": jarr(g_bias)}
    gn_t = {"scale": tarr(g_scale), "bias": tarr(g_bias)}
    s_j, b_j = jconv.fold_group_norm(gn_j, jarr(x), groups)
    s_t, b_t = tconv.fold_group_norm(gn_t, tarr(x), groups)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-5,
                               atol=1e-6)

    kw_j = {"channel_bias": jarr(temb, jnp.float32) if with_temb else None,
            "skip": jarr(skip) if with_skip else None}
    kw_t = {"channel_bias": tarr(temb, torch.float32) if with_temb else None,
            "skip": tarr(skip) if with_skip else None}
    k_oihw = tarr(np.ascontiguousarray(k_hwio.transpose(3, 2, 0, 1)))
    k_oihw = k_oihw.contiguous(memory_format=torch.channels_last)
    got = tconv.gn_silu_conv3x3(tarr(x), s_t, b_t, k_oihw, tarr(cb), **kw_t)
    assert got.dtype == tdt and got.shape == (b, h, w, c_out)
    # both wrappers run the one plain version on CPU tensors
    assert torch.equal(got, tconv.gn_silu_conv3x3_v2(
        tarr(x), s_t, b_t, k_oihw, tarr(cb), **kw_t))
    g = got.float().numpy()
    for fused, kw in ((jconv.gn_silu_conv3x3, kw_j),
                      (jconv.gn_silu_conv3x3_v2, dict(kw_j, block_rows=64))):
        want = np.asarray(fused(jarr(x), s_j, b_j, jarr(k_hwio), jarr(cb),
                                **kw), np.float32)
        if dtype == "fp32":
            np.testing.assert_allclose(g, want, rtol=0, atol=5e-5)
        else:
            assert np.max(np.abs(g - want)) / np.max(np.abs(want)) < 2e-2


def _resnet_case(where, conv_impl, hw=(8, 8)):
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, *hw, 32)).astype(np.float32)
    if where == "unet":
        jp = junet._resnet_init(key, 32, 48, 64, jnp.float32)
        temb = rng.standard_normal((2, 64)).astype(np.float32)
        want = junet._resnet_apply(jp, jnp.asarray(x), jnp.asarray(temb), 8,
                                   1e-5, conv_impl=conv_impl)
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
        t = tlayers.linear(tp["time_emb_proj"],
                           tlayers.silu(torch.from_numpy(temb)))
        got = tunet._resnet_apply(tp, torch.from_numpy(x), 8, 1e-5, t,
                                  conv_impl)
    else:
        jp = jvae._resnet_init(key, 32, 48, jnp.float32)
        want = jvae._resnet_apply(jp, jnp.asarray(x), 8, conv_impl)
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
        got = tvae._resnet_apply(tp, torch.from_numpy(x), 8, conv_impl)
    return got, np.asarray(want)


@pytest.mark.parametrize("conv_impl", ["pallas", "pallas2"])
@pytest.mark.parametrize("where", ["unet", "vae"])
def test_resnet_matches_jax_fused_resnet(where, conv_impl):
    """One resnet (with a conv shortcut) through the fused path, against the
    JAX resnet with the same conv_impl (its Pallas kernels interpreted)."""
    got, want = _resnet_case(where, conv_impl)
    assert got.shape == want.shape == (2, 8, 8, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def vae_params():
    tp = tvae.vae_init(torch.Generator().manual_seed(0),
                       tcfg.tiny_config().vae, torch.float32, "cpu")
    return to_jax(tp), tp


@pytest.mark.parametrize("conv_impl", ["pallas", "pallas2"])
def test_vae_decode_fused_matches_jax_xla(vae_params, conv_impl):
    jp, tp = vae_params
    z = (np.random.default_rng(2).standard_normal((1, 8, 8, 4)) * 0.2).astype(
        np.float32)
    # jitted: one compile of the decoder, not one an op
    want = np.asarray(jax.jit(jvae.vae_decode, static_argnums=(1,))(
        jp, jcfg.tiny_config().vae, jnp.asarray(z)))
    got = tvae.vae_decode(tp, tcfg.tiny_config().vae, torch.from_numpy(z),
                          conv_impl=conv_impl)
    assert got.shape == (1, 64, 64, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=2e-4)


def test_conv_shapes_are_the_calls_the_port_makes(monkeypatch):
    """chip_smoke.resnet_conv_shapes, which sets the launch counts the card
    run asserts, lists exactly the fused convs the tiny UNet, VAE decoder
    and VAE encoder make."""
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
    cond = tunet.UNetCond(context=torch.zeros(2, 77, 64))
    tunet.unet_apply(tunet.unet_init(g, cfg.unet, torch.float32, "cpu"),
                     cfg.unet, torch.zeros(2, 8, 8, 4),
                     torch.tensor([10.0, 10.0]), cond, conv_impl="pallas")
    vae = tvae.vae_init(g, cfg.vae, torch.float32, "cpu")
    tvae.vae_decode(vae, cfg.vae, torch.zeros(1, 8, 8, 4),
                    conv_impl="pallas2")
    tvae.vae_encode(vae, cfg.vae, torch.zeros(1, 64, 64, 3),
                    sample_mode="argmax", conv_impl="pallas")
    shapes = chip_smoke.resnet_conv_shapes(cfg, 64, 64, encoder=True)
    assert calls == [s[1:] for s in shapes]
    assert collections.Counter(s[0] for s in shapes) == {
        "unet": 44, "vae": 28, "vae_enc": 20}
    assert chip_smoke.resnet_conv_shapes(cfg, 64, 64) == [
        s for s in shapes if s[0] != "vae_enc"]


def _jax_routes(h, w, c_in, c_out, has_skip, itemsize=2):
    """(K4a or K4b or None, K5 fits) as the JAX wrappers choose them."""
    r = jconv._round_up
    c_in_pad, c_out_pad = r(c_in, 128), r(c_out, 128)
    wp2 = w + 2
    m_pad = r((h + 2) * wp2, 8)
    if jconv._pick_tiles(m_pad, c_in_pad, c_out_pad, itemsize, has_skip):
        v1 = "K4a"
    elif jconv._pick_row_tiles(r(2 * wp2 + 2, 8), c_in_pad, c_out_pad,
                               itemsize, has_skip):
        v1 = "K4b"
    else:
        v1 = None
    wp2 = r(w + 2, 8)
    v2 = jconv._pick_tiles_v2((h + 2) * wp2, wp2, c_in_pad, c_out_pad,
                              itemsize, has_skip) is not None
    return v1, v2


@pytest.mark.parametrize("size", [512, 1024])
def test_no_sd15_resnet_conv_takes_the_jax_vmem_fallback(size):
    """On every resnet conv of SD1.5 at 512^2 and 1024^2 (bf16), the JAX
    tile searches succeed, so both packages run a fused kernel there; and
    K4b is taken exactly where chip_smoke.jax_route says."""
    shapes = chip_smoke.resnet_conv_shapes(tcfg.sd15_config(), size, size)
    routes = collections.Counter()
    for where, _, h, w, c_in, c_out, _, skip in shapes:
        v1, v2 = _jax_routes(h, w, c_in, c_out, skip)
        assert v1 is not None and v2, (where, h, w, c_in, c_out)
        assert (v1 == "K4b") == (
            chip_smoke.jax_route(h, w, c_in, c_out)[0] == "K4b")
        routes[where, v1] += 1
    want = {512: {("unet", "K4a"): 44, ("vae", "K4a"): 10,
                  ("vae", "K4b"): 18},
            1024: {("unet", "K4a"): 34, ("unet", "K4b"): 10,
                   ("vae", "K4b"): 28}}[size]
    assert routes == want


def test_no_sd15_encoder_conv_takes_the_jax_vmem_fallback():
    """The VAE encoder's resnet convs of a 512^2 image (img2img and
    inpaint) in bf16: the JAX tile searches succeed on every one, and K4b
    is taken exactly where chip_smoke.jax_route says, at 512^2, 256^2 and
    128^2."""
    shapes = [sh for sh in chip_smoke.resnet_conv_shapes(
        tcfg.sd15_config(), 512, 512, encoder=True) if sh[0] == "vae_enc"]
    routes = collections.Counter()
    for _, _, h, w, c_in, c_out, _, skip in shapes:
        v1, v2 = _jax_routes(h, w, c_in, c_out, skip)
        assert v1 is not None and v2, (h, w, c_in, c_out)
        assert (v1 == "K4b") == (
            chip_smoke.jax_route(h, w, c_in, c_out)[0] == "K4b")
        routes[v1, h] += 1
    assert routes == {("K4b", 512): 4, ("K4b", 256): 4, ("K4b", 128): 4,
                      ("K4a", 64): 8}
    assert {(c_in, c_out) for _, _, _, _, c_in, c_out, _, _ in shapes} == {
        (128, 128), (128, 256), (256, 256), (256, 512), (512, 512)}


def test_port_takes_a_map_the_jax_search_refuses():
    """A decoder map 1920 pixels wide: the JAX row-tiled search finds no
    tile (halo 3848 rows) and its callers fall back to the unfused convs;
    the port's kernels take every shape, so only rounding differs there."""
    assert _jax_routes(4, 1920, 128, 128, True)[0] is None
    x, g_scale, g_bias, k_hwio, cb, _, skip = _case(1, 4, 1920, 128, 128, 3)
    scale, bias = tconv.fold_group_norm(
        {"scale": torch.from_numpy(g_scale), "bias": torch.from_numpy(g_bias)},
        torch.from_numpy(x), 32)
    k = torch.from_numpy(np.ascontiguousarray(k_hwio.transpose(3, 2, 0, 1)))
    out = tconv.gn_silu_conv3x3(
        torch.from_numpy(x), scale, bias,
        k.contiguous(memory_format=torch.channels_last), torch.from_numpy(cb),
        skip=torch.from_numpy(skip))
    assert out.shape == (1, 4, 1920, 128) and torch.isfinite(out).all()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(1, 4, 4, 12)
    s = torch.zeros(1, 12)
    k = torch.zeros(16, 12, 3, 3).contiguous(memory_format=torch.channels_last)
    cb = torch.zeros(16)
    with pytest.raises(ValueError, match="multiples of 8"):
        tconv.gn_silu_conv3x3(x, s, s, k, cb)
    x, s = torch.zeros(1, 4, 4, 16), torch.zeros(1, 16)
    k = torch.zeros(16, 16, 3, 3)  # OIHW contiguous, not channels_last
    with pytest.raises(ValueError, match="channels_last"):
        tconv.gn_silu_conv3x3(x, s, s, k, cb)
    k = k.contiguous(memory_format=torch.channels_last)
    with pytest.raises(TypeError):
        tconv.gn_silu_conv3x3_v2(x.half(), s, s, k.half(), cb)
    with pytest.raises(ValueError, match="contiguous"):
        tconv.gn_silu_conv3x3(x.transpose(1, 2), s, s, k, cb)
    before = (tconv.gn_silu_conv3x3.launches,
              tconv.gn_silu_conv3x3_v2.launches)
    tconv.gn_silu_conv3x3(x, s, s, k, cb)
    assert (tconv.gn_silu_conv3x3.launches,
            tconv.gn_silu_conv3x3_v2.launches) == before
