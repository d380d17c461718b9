"""The port's UNet taps and DeepCache split against the JAX package's, on
the CPU: FreeU (``_freeu_filter``, even and odd sizes, and the whole UNet),
TGATE's collect / consume round trip, DAAM's heatmap taps and
``attention_probs``, the taps' exclusivity errors, and
``unet_apply_deepcache``'s full and reuse calls with its rejection.

Tiny config, fp32, the weights of tests/test_torch_unet.py (the port's
init moved to the JAX layouts) and its inputs. The JAX UNet compiles twice
(the TGATE collect and DeepCache with FreeU; at XLA's backend optimization
level 0, as in tests/test_torch_speed_modes.py): FreeU's UNet parity reads
the DeepCache full call, and the heatmap maps are held to the JAX UNet's in
tests/test_torch_daam.py, whose compiled program they share. Tolerances: the
UNet's outputs and the frozen cross-attention outputs rtol/atol 1e-4, as
tests/test_torch_unet.py holds the UNet (a ~40-layer fp32 network whose
convolutions and attention sum in another order on each side); the FreeU
filter and ``attention_probs`` on direct inputs 1e-5 / 1e-6. Port-only
identities (a consumed cache, a full DeepCache call against ``unet_apply``)
are bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.models import unet as junet
from diffusionspatialcontrol_tpu.ops import attention as jattn
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.models import unet as tunet
from diffusionspatialcontrol_tpu_torch.ops import attention as tattn
from tests.test_torch_speed_modes import JAX_DEEPCACHE, JAX_UNET
from tests.test_torch_unet import _inputs, unet_params  # noqa: F401

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

JUNET, TUNET = jcfg.tiny_config().unet, tcfg.tiny_config().unet
_jax_unet, _jax_deepcache = JAX_UNET, JAX_DEEPCACHE


def _conds(region: bool, seed: int = 1):
    """The same inputs for both packages: (jax args, torch args) of
    ``unet_apply`` up to its cond, B = 2, 16 x 16 latents."""
    x, ctx, t, biases = _inputs(seed)
    sigma = 2.0
    jcond = junet.UNetCond(
        context=jnp.asarray(ctx),
        region=(junet.RegionState(tuple(map(jnp.asarray, biases)),
                                  jnp.float32(sigma)) if region else None))
    tcond = tunet.UNetCond(
        context=torch.from_numpy(ctx),
        region=(tunet.RegionState(tuple(map(torch.from_numpy, biases)),
                                  torch.tensor(sigma)) if region else None))
    return ((jnp.asarray(x), jnp.asarray(t), jcond),
            (torch.from_numpy(x), torch.from_numpy(t), tcond))


def _close(got, want, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# -- FreeU --------------------------------------------------------------------

@pytest.mark.parametrize("shape,threshold", [
    ((2, 8, 8, 4), 1), ((1, 7, 9, 3), 1), ((1, 5, 6, 2), 2)],
    ids=str)
def test_freeu_filter_matches_jax(shape, threshold):
    """The fftshift box is centred at (h // 2, w // 2) in both packages, for
    even and odd sizes alike."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = junet._freeu_filter(jnp.asarray(x), 0.3, threshold)
    got = tunet._freeu_filter(torch.from_numpy(x), 0.3, threshold)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5, 1e-5)
    assert not np.allclose(got.numpy(), x)


def test_freeu_params_equal_jax():
    assert tunet.FreeUParams() == tunet.FreeUParams(
        **vars(junet.FreeUParams()))


@pytest.fixture(scope="module")
def jax_deepcache_freeu(unet_params):  # noqa: F811
    """The JAX package's DeepCache with FreeU on the inputs of ``_conds``: a
    full call from a zero cache and a reuse call of a random cache, one
    program for both (``use_cache`` is traced). Returns (full output, its
    cache, the given cache, reuse output)."""
    jp, _ = unet_params
    (jx, jt, jcond), _ = _conds(region=True)
    shape = tunet.deepcache_shape(TUNET, 2, 16, 16)
    freeu = junet.FreeUParams()
    full, cache = _jax_deepcache(jp, JUNET, jx, jt, jcond, jnp.zeros(shape),
                                 jnp.float32(0.0), freeu=freeu)
    given = np.random.default_rng(5).standard_normal(shape).astype(
        np.float32)
    reuse, kept = _jax_deepcache(jp, JUNET, jx, jt, jcond, jnp.asarray(given),
                                 jnp.float32(1.0), freeu=freeu)
    np.testing.assert_array_equal(np.asarray(kept), given)
    return np.asarray(full), np.asarray(cache), given, np.asarray(reuse)


def test_unet_freeu_matches_jax(unet_params, jax_deepcache_freeu):  # noqa: F811
    """FreeU at up blocks 0 and 1 (the first half of the channels scaled by
    b, the skip filtered at s), as tests/test_models.py's ``test_freeu``:
    it moves the output, and the port's matches the JAX package's full
    DeepCache call with FreeU (its own tests/test_deepcache.py holds that
    to its ``unet_apply`` within 2e-5; one JAX program serves both
    tests)."""
    _, tp = unet_params
    _, (tx, tt, tcond) = _conds(region=True)
    got = tunet.unet_apply(tp, TUNET, tx, tt, tcond,
                           freeu=tunet.FreeUParams())
    _close(got, jax_deepcache_freeu[0])
    plain = tunet.unet_apply(tp, TUNET, tx, tt, tcond)
    assert torch.isfinite(got).all()
    assert not torch.allclose(got, plain, rtol=1e-3, atol=1e-3)


# -- TGATE's taps -------------------------------------------------------------

def _n_cross_attentions(params):
    return sum(len(a["blocks"]) for blocks in (params["down_blocks"],
                                               params["up_blocks"])
               for b in blocks for a in b["attentions"]) + len(
        params["mid_block"]["attention"]["blocks"])


def test_xattn_collect_consume_round_trip(unet_params):  # noqa: F811
    """``collect_xattn`` returns one output a cross-attention in traversal
    order, equal to the JAX package's; fed back as ``xattn_cache`` it gives
    the plain output bit for bit (the JAX package's own outputs fed to the
    port give the JAX output), and a cache with entries left over raises
    as in the JAX package (tests/test_tgate.py)."""
    jp, tp = unet_params
    (jx, jt, jcond), (tx, tt, tcond) = _conds(region=True)
    want, jxa = _jax_unet(jp, JUNET, jx, jt, jcond, collect_xattn=True)
    out, xa = tunet.unet_apply(tp, TUNET, tx, tt, tcond, collect_xattn=True)
    plain = tunet.unet_apply(tp, TUNET, tx, tt, tcond)
    assert torch.equal(out, plain)
    assert len(xa) == len(jxa) == _n_cross_attentions(tp) == 16
    for got, ref in zip(xa, jxa):
        assert tuple(got.shape) == ref.shape
        _close(got, ref)
    _close(out, want)
    assert torch.equal(
        tunet.unet_apply(tp, TUNET, tx, tt, tcond, xattn_cache=xa), plain)
    fed = tuple(torch.from_numpy(np.array(e)) for e in jxa)
    _close(tunet.unet_apply(tp, TUNET, tx, tt, tcond, xattn_cache=fed),
           want)
    # the frozen outputs alone drive the cross-attentions: no cond needed
    blank = tunet.UNetCond(context=torch.zeros_like(tcond.context))
    assert torch.equal(
        tunet.unet_apply(tp, TUNET, tx, tt, blank, xattn_cache=xa), plain)
    with pytest.raises(ValueError, match="unconsumed") as t:
        tunet.unet_apply(tp, TUNET, tx, tt, tcond, xattn_cache=xa + xa)
    assert "16 unconsumed" in str(t.value)
    with pytest.raises(IndexError):
        tunet.unet_apply(tp, TUNET, tx, tt, tcond, xattn_cache=xa[:-1])


@pytest.mark.parametrize("options", [
    {"collect_xattn": True, "collect_heatmaps": True},
    {"collect_xattn": True, "xattn_cache": ()},
    {"collect_heatmaps": True, "xattn_cache": ()}], ids=str)
def test_taps_exclude_each_other(unet_params, options):  # noqa: F811
    """The same ValueError as the JAX package's, raised before any work."""
    jp, tp = unet_params
    (jx, jt, jcond), (tx, tt, tcond) = _conds(region=False)
    with pytest.raises(ValueError) as j:
        junet.unet_apply(jp, JUNET, jx, jt, jcond, **options)
    with pytest.raises(ValueError) as t:
        tunet.unet_apply(tp, TUNET, tx, tt, tcond, **options)
    assert str(t.value) == str(j.value)


# -- DAAM's taps --------------------------------------------------------------

@pytest.mark.parametrize("region", [True, False])
def test_attention_probs_matches_jax(region):
    """With a region map the logits take the bias scaled by the exact
    unbiased std of the full logits."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 3, 16, 8)).astype(np.float32)
    k = rng.standard_normal((2, 3, 11, 8)).astype(np.float32)
    w = (rng.standard_normal((2, 16, 11)) * 0.5).astype(np.float32)
    args = (w, 1.7) if region else ()
    want = jattn.attention_probs(jnp.asarray(q), jnp.asarray(k),
                                 *map(jnp.asarray, args))
    got = tattn.attention_probs(torch.from_numpy(q), torch.from_numpy(k),
                                *map(torch.as_tensor, args))
    _close(got, want, 1e-6, 1e-6)
    torch.testing.assert_close(got.sum(-1), torch.ones(2, 3, 16))


def test_heatmap_taps(unet_params):  # noqa: F811
    """``collect_heatmaps``: the output is the plain one bit for bit; one
    (level, probabilities summed over heads) a cross-attention in the JAX
    package's traversal order, each row summing to the head count
    (tests/test_torch_daam.py holds the maps to the JAX UNet's)."""
    _, tp = unet_params
    _, (tx, tt, tcond) = _conds(region=True)
    out, maps = tunet.unet_apply(tp, TUNET, tx, tt, tcond,
                                 collect_heatmaps=True)
    assert torch.equal(out, tunet.unet_apply(tp, TUNET, tx, tt, tcond))
    assert [lv for lv, _ in maps] == [0, 0, 1, 1, 2, 2, 3, 2, 2, 2, 1, 1, 1,
                                      0, 0, 0]
    for level, m in maps:
        assert tuple(m.shape) == (2, (16 >> level) ** 2, 77)
        torch.testing.assert_close(m.sum(-1), torch.full(m.shape[:2], 2.0))


# -- DeepCache ----------------------------------------------------------------

def test_deepcache_shape_matches_jax():
    assert tunet.deepcache_shape(TUNET, 2, 16, 12) == \
        junet.deepcache_shape(JUNET, 2, 16, 12) == (2, 16, 12, 64)


def test_deepcache_full_and_reuse_match_jax(unet_params,  # noqa: F811
                                            jax_deepcache_freeu):
    """With FreeU inside the deep branch. A full call (``use_cache`` 0)
    equals the JAX package's and, bit for bit, the port's ``unet_apply``
    (the same operations in the same order; without FreeU too); its cache
    equals the JAX one. A reuse call (``use_cache`` 1) returns the cache
    it was given as it is and its output equals the JAX one; the output
    follows the cache (the shallow layers see it), as
    tests/test_deepcache.py checks."""
    _, tp = unet_params
    _, (tx, tt, tcond) = _conds(region=True)
    want, jcache, given, want_reuse = jax_deepcache_freeu
    shape = tunet.deepcache_shape(TUNET, 2, 16, 16)
    zeros = torch.zeros(shape)
    tfreeu = tunet.FreeUParams()
    out, cache = tunet.unet_apply_deepcache(tp, TUNET, tx, tt, tcond, zeros,
                                            0.0, freeu=tfreeu)
    _close(out, want)
    _close(cache, jcache)
    assert tuple(cache.shape) == shape and cache.abs().max() > 0
    assert torch.equal(out, tunet.unet_apply(tp, TUNET, tx, tt, tcond,
                                             freeu=tfreeu))
    plain, _ = tunet.unet_apply_deepcache(tp, TUNET, tx, tt, tcond, zeros, 0)
    assert torch.equal(plain, tunet.unet_apply(tp, TUNET, tx, tt, tcond))

    src = torch.from_numpy(given)
    out, kept = tunet.unet_apply_deepcache(tp, TUNET, tx, tt, tcond, src, 1.0,
                                           freeu=tfreeu)
    assert kept is src
    _close(out, want_reuse)
    other, _ = tunet.unet_apply_deepcache(tp, TUNET, tx, tt, tcond, src + 1.0,
                                          1.0, freeu=tfreeu)
    assert not torch.allclose(other, out)


def test_deepcache_rejects_deep_branch_conditioning(unet_params):  # noqa: F811
    """ControlNet and T2I residuals inject into the cached branch: the same
    ValueError as the JAX package's."""
    jp, tp = unet_params
    (jx, jt, jcond), (tx, tt, tcond) = _conds(region=False)
    t2i = [np.zeros((2, 16 >> i, 16 >> i, c), np.float32)
           for i, c in enumerate(TUNET.block_out_channels)]
    shape = tunet.deepcache_shape(TUNET, 2, 16, 16)
    jcond.t2i_residuals = tuple(map(jnp.asarray, t2i))
    tcond.t2i_residuals = tuple(map(torch.from_numpy, t2i))
    with pytest.raises(ValueError, match="deepcache") as j:
        junet.unet_apply_deepcache(jp, JUNET, jx, jt, jcond,
                                   jnp.zeros(shape), 0.0)
    with pytest.raises(ValueError, match="deepcache") as t:
        tunet.unet_apply_deepcache(tp, TUNET, tx, tt, tcond,
                                   torch.zeros(shape), 0.0)
    assert str(t.value) == str(j.value)
