"""The port's ControlNet (``models/controlnet.py``) against the JAX package's,
tiny config, fp32, on the CPU.

Parameters come from the port's own init with random heads written over
the zero ones (a fresh ControlNet's residuals are exactly zero in both
packages, so a parity check on them would compare zeros), moved to the JAX
layout (the JAX init takes a quarter of a minute on the CPU). The same
numpy latents, timesteps, context and control image go through both.
Tolerance: rtol/atol 1e-5 on residuals of magnitude ~1 (the down path is
about 20 layers deep; the port's attention is K2's plain version, the JAX
package's XLA's attention).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.models import controlnet as jcn
from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.convert.from_jax import params_from_jax
from diffusionspatialcontrol_tpu_torch.models import controlnet as tcn
from diffusionspatialcontrol_tpu_torch.ops.kernels import flash_attention as k2

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

UNET = tcfg.tiny_config().unet
HEAD_RMS = 0.05  # the random heads' RMS: residuals of magnitude ~1


def to_jax(tree):
    """The port's parameter tree in the JAX package's layout (the inverse of
    ``params_from_jax``); ``None`` leaves stay ``None``."""
    if isinstance(tree, dict):
        return {k: _leaf(v, k) if isinstance(v, torch.Tensor) else to_jax(v)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaf(v, "") if isinstance(v, torch.Tensor) else to_jax(v)
                for v in tree]
    return tree


def _leaf(t, name):
    if name == "kernel" and t.dim() == 4:
        t = t.permute(2, 3, 1, 0)
    elif name == "kernel" and t.dim() == 2:
        t = t.t()
    return jnp.asarray(t.contiguous().numpy())


def head_convs(params):
    """The zero-initialized heads: the cond embedding's conv_out, every zero
    conv and the mid zero conv."""
    return ([params["cond_embedding"]["conv_out"]] + params["zero_convs"]
            + [params["mid_zero_conv"]])


def random_heads(params, seed, rms=HEAD_RMS):
    """``params`` with every head's kernel and bias drawn at ``rms``."""
    g = torch.Generator().manual_seed(seed)
    for conv in head_convs(params):
        for k in ("kernel", "bias"):
            t = conv[k]
            conv[k] = (rms * torch.randn(t.shape, generator=g)).to(
                t.dtype).contiguous(memory_format=torch.channels_last
                                    if t.dim() == 4 else torch.contiguous_format)
    return params


def controlnet_params(seed=1, heads=True):
    """(the port's ControlNet on the CPU, fp32; the same in the JAX
    layout)."""
    tp = tcn.controlnet_init(torch.Generator().manual_seed(seed), UNET,
                             dtype=torch.float32, device="cpu")
    if heads:
        random_heads(tp, seed + 100)
    return tp, to_jax(tp)


def _inputs(seed, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 8, 8, 4)).astype(np.float32)
    t = np.array([500.0, 31.5][:batch], np.float32)
    ctx = rng.standard_normal((batch, 77, 64)).astype(np.float32)
    img = rng.random((batch, 64, 64, 3)).astype(np.float32)
    return x, t, ctx, img


@pytest.fixture(scope="module")
def cn():
    return controlnet_params()


# one program a guess mode: the scale is always passed as an fp32 array.
# On fp32 residuals a Python scale (a weak fp32 scalar in JAX) gives the
# same values, and a weak scalar would compile a second program; the bf16
# promotion that tells the two apart is held by
# test_guess_mode_ramp_and_bf16_promotion_follow_jax.
_jax_controlnet = jax.jit(jcn.controlnet_apply, static_argnums=(1,),
                          static_argnames=("guess_mode",))


def _jax_apply(jp, x, t, ctx, img, conditioning_scale=1.0, **kw):
    down, mid = _jax_controlnet(jp, jcfg.tiny_config().unet, jnp.asarray(x),
                                jnp.asarray(t), jnp.asarray(ctx),
                                jnp.asarray(img),
                                jnp.float32(conditioning_scale), **kw)
    return [np.asarray(r) for r in down], np.asarray(mid)


def _torch_apply(tp, x, t, ctx, img, **kw):
    """The port's ``controlnet_apply`` on the embedding of ``img``, which
    the JAX package's takes at every call."""
    emb = tcn.controlnet_cond_embedding(tp, torch.from_numpy(img),
                                        torch.float32)
    return tcn.controlnet_apply(tp, UNET, torch.from_numpy(x),
                                torch.from_numpy(t), torch.from_numpy(ctx),
                                emb, **kw)


@pytest.mark.parametrize("guess_mode", [False, True])
@pytest.mark.parametrize("scale", ["0.7", "tensor 1.3"])
def test_controlnet_apply_matches_jax(cn, guess_mode, scale):
    tp, jp = cn
    x, t, ctx, img = _inputs(3)
    if scale == "0.7":
        jscale = tscale = 0.7
    else:  # a per-step scale as the denoiser gathers it: an fp32 array
        jscale, tscale = 1.3, torch.tensor(1.3)
    jd, jm = _jax_apply(jp, x, t, ctx, img, conditioning_scale=jscale,
                        guess_mode=guess_mode)
    td, tm = _torch_apply(tp, x, t, ctx, img, conditioning_scale=tscale,
                          guess_mode=guess_mode)
    assert len(td) == len(jd) == 12  # SD topology: 12 skips, conv_in's too
    for i, (a, b) in enumerate(zip(td, jd)):
        assert a.shape == b.shape and a.dtype == torch.float32, i
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5,
                                   err_msg=f"down residual {i}")
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-5, atol=1e-5)
    # the heads reach every residual: none is zero
    assert min(float(r.abs().max()) for r in td + (tm,)) > 1e-3


def test_guess_mode_ramp_and_bf16_promotion_follow_jax(cn):
    """Guess mode scales the residuals by logspace(-1, 0) over the 12 down
    residuals then the mid one. A bf16 residual times an fp32 scale is fp32
    in JAX; so is a guess-mode residual whatever the scale's type; a Python
    scale keeps bf16."""
    tp, _ = cn
    x, t, ctx, img = _inputs(4)
    plain_d, plain_m = _torch_apply(tp, x, t, ctx, img)
    guess_d, guess_m = _torch_apply(tp, x, t, ctx, img, guess_mode=True)
    ramp = np.asarray(jnp.logspace(-1.0, 0.0, 13))
    for i, (p, g) in enumerate(zip(plain_d, guess_d)):
        np.testing.assert_allclose(g.numpy(), p.numpy() * ramp[i],
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(guess_m.numpy(), plain_m.numpy() * ramp[-1],
                               rtol=1e-6)
    tp16 = _cast(tp, torch.bfloat16)
    args = (tp16, UNET, torch.from_numpy(x).bfloat16(), torch.from_numpy(t),
            torch.from_numpy(ctx).bfloat16(),
            tcn.controlnet_cond_embedding(tp16, torch.from_numpy(img),
                                          torch.bfloat16))
    assert tcn.controlnet_apply(*args, conditioning_scale=0.5)[1].dtype == \
        torch.bfloat16
    assert tcn.controlnet_apply(
        *args, conditioning_scale=torch.tensor(0.5))[1].dtype == torch.float32
    assert tcn.controlnet_apply(*args, guess_mode=True)[1].dtype == \
        torch.float32


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def test_fresh_controlnet_is_noop():
    """Zero heads (the port's init, as the JAX init makes them): every
    residual exactly zero in both packages' ``controlnet_apply``."""
    tp, jp = controlnet_params(seed=5, heads=False)
    x, t, ctx, img = _inputs(6)
    td, tm = _torch_apply(tp, x, t, ctx, img, conditioning_scale=2.0)
    jd, jm = _jax_apply(jp, x, t, ctx, img, conditioning_scale=2.0)
    for r in list(td) + [tm]:
        assert float(r.abs().max()) == 0.0
    for r in jd + [jm]:
        assert float(np.abs(r).max()) == 0.0
    for conv in head_convs(tp):
        assert not conv["kernel"].any() and not conv["bias"].any()


def test_cond_embedding_once_equals_per_call(cn):
    """One embedding, computed once and passed to calls at two timesteps,
    gives the residuals of embedding the image before each call (as the
    JAX package does) bit for bit."""
    tp, _ = cn
    x, t, ctx, img = _inputs(7)
    emb = tcn.controlnet_cond_embedding(tp, torch.from_numpy(img),
                                        torch.float32)
    for k in range(2):
        xk, tk = torch.from_numpy(x * (k + 1)), torch.from_numpy(t / (k + 1))
        got = tcn.controlnet_apply(tp, UNET, xk, tk, torch.from_numpy(ctx),
                                   emb, conditioning_scale=0.9)
        want = tcn.controlnet_apply(
            tp, UNET, xk, tk, torch.from_numpy(ctx),
            tcn.controlnet_cond_embedding(tp, torch.from_numpy(img),
                                          torch.float32),
            conditioning_scale=0.9)
        for a, b in zip(got[0] + (got[1],), want[0] + (want[1],)):
            assert torch.equal(a, b)


def test_init_tree_matches_jax_and_runs_k2(cn):
    """The port's tree has the JAX init's keys, list lengths and shapes (in
    the port's layout), and its 7 transformers' 14 attentions all go
    through K2 (on CPU tensors, its plain version: no launch is counted)."""
    tp, _ = cn
    want = jax.eval_shape(lambda: jcn.controlnet_init(
        jax.random.PRNGKey(0), jcfg.tiny_config().unet, dtype=jnp.float32))
    got = jax.tree_util.tree_map(lambda a: a.shape, to_jax(tp))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(
            lambda a: a.shape, want))
    assert jax.tree_util.tree_leaves(got, is_leaf=lambda a: isinstance(
        a, tuple)) == jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            lambda a: a.shape, want), is_leaf=lambda a: isinstance(a, tuple))
    n_attn = sum(len(b["attentions"]) for b in tp["down_blocks"]) + 1
    assert n_attn == 7
    calls = []
    orig = tcn._transformer_apply

    def spy(p, cfg, x, cond, level, heads, flash_opts):
        calls.append(flash_opts)
        return orig(p, cfg, x, cond, level, heads, flash_opts)

    before = k2.flash_attention_nlhd.launches
    tcn._transformer_apply = spy
    try:
        _torch_apply(tp, *_inputs(8))
    finally:
        tcn._transformer_apply = orig
    assert calls == [{"pv_bf16": False, "use_exp2": False}] * 7
    assert k2.flash_attention_nlhd.launches == before


def test_controlnet_for_a_nine_channel_unet_raises():
    """A ControlNet built for the 9-channel inpaint UNet takes 9 channels
    but is fed the 4 latent ones: a ValueError that says so (JAX fails on
    the shapes; tests/test_torch_units.py has the pipeline's raise)."""
    import dataclasses

    unet9 = dataclasses.replace(UNET, in_channels=9)
    tp = tcn.controlnet_init(torch.Generator().manual_seed(0), unet9,
                             dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="9 channels"):
        tcn.check_input_channels(tp, 4)
    tcn.check_input_channels(controlnet_params(heads=False)[0], 4)


def test_params_from_jax_round_trips_the_tree(cn):
    tp, jp = cn
    back = params_from_jax({k: v for k, v in _numpy(jp).items()},
                           device="cpu")
    for a, b in zip(_flat(back), _flat(tp)):
        assert torch.equal(a, b)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return None if tree is None else np.asarray(tree)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]
