"""K1 (region attention) and K2 (attention) of the PyTorch port: their plain
versions against the JAX Pallas kernels (interpret mode on the CPU, as
tests/test_pallas.py runs them) and the JAX references, the centered-Gram
std against an fp64 oracle, and the CPU dispatch rule.

Tolerances are the JAX package's own: rtol 2e-4 / atol 2e-5 in fp32
(test_pallas.py:34, :66), 2e-2 for the bf16 kernel options (:204-220),
< 1e-4 relative for the std (:172, :189).

The CUDA kernels themselves need a card and nvcc:
tests/test_torch_kernels_cuda.py (marked ``cuda``) holds them against their
plain versions there, and ``chip_smoke.py`` does so at every main-path
shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu.ops import attention as jattn
from diffusionspatialcontrol_tpu.ops.pallas.flash_attention import (
    flash_attention as pallas_flash,
)
from diffusionspatialcontrol_tpu.ops.pallas.flash_attention import (
    flash_attention_nlhd as pallas_flash_nlhd,
)
from diffusionspatialcontrol_tpu.ops.pallas.region_attention import (
    region_attention_nlhd as pallas_region_nlhd,
)
from diffusionspatialcontrol_tpu_torch.ops import attention as tattn
from diffusionspatialcontrol_tpu_torch.ops.kernels import flash_attention as k2
from diffusionspatialcontrol_tpu_torch.ops.kernels import region_attention as k1

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)


def _qkv(seed, b, l, s, h, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, h, d)).astype(dtype)
    k = rng.standard_normal((b, s, h, d)).astype(dtype)
    v = rng.standard_normal((b, s, h, d)).astype(dtype)
    return q, k, v


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("b,l,s,h,d", [(2, 64, 77, 4, 40), (1, 50, 154, 2, 16)])
def test_k1_plain_matches_pallas_and_reference(b, l, s, h, d):
    q, k, v = _qkv(0, b, l, s, h, d)
    region = (np.random.default_rng(1).standard_normal((b, l, s)) * 0.5
              ).astype(np.float32)
    sigma = 4.2
    want = np.asarray(pallas_region_nlhd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(region),
        jnp.asarray(sigma)))
    ref = np.asarray(jattn.region_attention_reference(
        *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)),
        jnp.asarray(region), jnp.asarray(sigma))).transpose(0, 2, 1, 3)
    got = k1.region_attention_nlhd(_t(q), _t(k), _t(v), _t(region),
                                   torch.tensor(sigma)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    # and the port's own materialized oracle
    oracle = tattn.region_attention_reference(
        *(_t(a).transpose(1, 2) for a in (q, k, v)), _t(region),
        torch.tensor(sigma)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-5)


def test_k1_plain_head_broadcast():
    """The bias broadcasts over heads: identical q/k/v per head give
    identical outputs (test_pallas.py:38-54)."""
    rng = np.random.default_rng(2)
    b, h, l, s, d = 1, 3, 16, 5, 8
    q = np.repeat(rng.standard_normal((b, l, 1, d)), h, 2).astype(np.float32)
    k = np.repeat(rng.standard_normal((b, s, 1, d)), h, 2).astype(np.float32)
    v = np.repeat(rng.standard_normal((b, s, 1, d)), h, 2).astype(np.float32)
    w = rng.standard_normal((b, l, s)).astype(np.float32)
    out = k1.region_softmax_attention(_t(q), _t(k), _t(v), _t(w))
    for hh in range(1, h):
        np.testing.assert_allclose(out[:, :, 0].numpy(),
                                   out[:, :, hh].numpy(), atol=1e-6)


@pytest.mark.parametrize("b,l,s,h,d", [(2, 64, 64, 4, 40), (1, 200, 200, 2, 40),
                                       (2, 64, 77, 2, 80)])
def test_k2_plain_matches_pallas_and_reference(b, l, s, h, d):
    q, k, v = _qkv(3, b, l, s, h, d)
    want = np.asarray(pallas_flash_nlhd(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v)))
    ref = np.asarray(jattn.attention_reference(
        *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)))
    ).transpose(0, 2, 1, 3)
    got = k2.flash_attention_nlhd(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    oracle = tattn.attention_reference(
        *(_t(a).transpose(1, 2) for a in (q, k, v))).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("opts", [
    {"qk_bf16": True}, {"pv_bf16": True}, {"use_exp2": True},
    {"qk_bf16": True, "pv_bf16": True, "use_exp2": True}])
def test_k2_plain_options_match_pallas(opts):
    """bf16 operands through each attn_impl option, against the Pallas
    kernel with the same option and the fp32 reference (2e-2). The port
    takes no ``qk_bf16``: it selects the math its kernels always do
    (test_k2_qk_bf16_changes_nothing_in_pallas)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 200, 2, 40)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    port_opts = {k: v for k, v in opts.items() if k != "qk_bf16"}
    got = k2.flash_attention_nlhd(xt, xt, xt, **port_opts).float().numpy()
    want = np.asarray(pallas_flash_nlhd(xb, xb, xb, **opts).astype(
        jnp.float32))
    ref = np.asarray(jattn.attention_reference(
        *(xb.astype(jnp.float32).transpose(0, 2, 1, 3),) * 3)
    ).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_qk_bf16_changes_nothing_in_pallas(dtype):
    """The Pallas kernel's ``qk_bf16`` only skips casting Q and K to fp32
    before an fp32-accumulated QK^T: for fp32 operands and for bf16 ones
    (whose products are exact in fp32) it gives the kernel's default result,
    and so the port's plain version, which has no such option. Tolerance:
    fp32 as above; bf16 outputs one bf16 unit in the last place (2^-7
    relative) apart at most, from fp32 results rounded on either side of a
    rounding boundary."""
    rtol, atol = (2e-4, 2e-5) if dtype == "float32" else (2.0 ** -7, 1e-4)
    x = _qkv(10, 1, 96, 96, 2, 40)
    q, k, v = (jnp.asarray(a).astype(dtype) for a in x)
    on = np.asarray(pallas_flash_nlhd(q, k, v, qk_bf16=True).astype(
        jnp.float32))
    off = np.asarray(pallas_flash_nlhd(q, k, v).astype(jnp.float32))
    np.testing.assert_allclose(on, off, rtol=rtol, atol=atol)
    port = k2.flash_attention_nlhd(
        *(_t(a).to(getattr(torch, dtype)) for a in x))
    assert port.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(port.float().numpy(), on, rtol=rtol,
                               atol=atol)


def test_attention_reference_bhld_matches_jax():
    q, k, v = _qkv(8, 1, 30, 20, 2, 16)
    bhld = [a.transpose(0, 2, 1, 3) for a in (q, k, v)]
    want = np.asarray(pallas_flash(*(jnp.asarray(a) for a in bhld)))
    got = tattn.attention_reference(*(_t(a) for a in bhld)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def _std_fp64_oracle(q, k, scale):
    logits = np.einsum("blhd,bshd->bhls", np.asarray(q, np.float64),
                       np.asarray(k, np.float64)) * scale
    return logits.std(ddof=1)


@pytest.mark.parametrize("mean_shift", [0.0, 0.5])
def test_gram_std_small_shapes_vs_fp64(mean_shift):
    """test_pallas.py:157's shapes, including the mean >> std regime."""
    rng = np.random.default_rng(0)
    q = (rng.standard_normal((2, 64, 4, 16)) * 0.05 + mean_shift).astype(
        np.float32)
    k = (rng.standard_normal((2, 11, 4, 16)) * 0.05 + mean_shift).astype(
        np.float32)
    scale = 16 ** -0.5
    got = float(tattn.logits_std_gram_nlhd(_t(q), _t(k), scale))
    want = _std_fp64_oracle(q, k, scale)
    assert abs(got - want) / want < 1e-4
    jax_got = float(jattn.logits_std_gram_nlhd(jnp.asarray(q),
                                               jnp.asarray(k), scale))
    assert abs(got - jax_got) / want < 1e-5


def test_gram_std_largest_latent_shape_vs_fp64():
    """1920x1088 latents (L = 32640) with a strong common mean
    (test_pallas.py:175)."""
    rng = np.random.default_rng(1)
    L = (1920 // 8) * (1088 // 8)
    q = (rng.standard_normal((1, L, 8, 40)) * 0.03 + 0.4).astype(np.float32)
    k = (rng.standard_normal((1, 77, 8, 40)) * 0.03 + 0.4).astype(np.float32)
    scale = 40 ** -0.5
    got = float(tattn.logits_std_gram_nlhd(_t(q), _t(k), scale))
    want = _std_fp64_oracle(q, k, scale)
    assert abs(got - want) / want < 1e-4, (got, want)


def test_gram_std_bhld_matches_nlhd():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    a = float(tattn.logits_std_gram(_t(q).transpose(1, 2),
                                    _t(k).transpose(1, 2), 0.25))
    b = float(tattn.logits_std_gram_nlhd(_t(q), _t(k), 0.25))
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_cpu_tensors_increment_no_kernel_counter():
    q, k, v = _qkv(9, 1, 16, 16, 2, 40)
    w = torch.zeros(1, 16, 16)
    before = (k1.region_softmax_attention.launches,
              k2.flash_attention_nlhd.launches)
    k2.flash_attention_nlhd(_t(q), _t(k), _t(v))
    k1.region_softmax_attention(_t(q), _t(k), _t(v), w)
    k1.region_attention_nlhd(_t(q), _t(k), _t(v), w, torch.tensor(1.0))
    assert (k1.region_softmax_attention.launches,
            k2.flash_attention_nlhd.launches) == before


def test_non_cpu_tensors_never_take_the_plain_version():
    """Tensors that are not on the CPU go to the kernel or raise: here a
    'meta' tensor (neither CPU nor CUDA) and a CPU/meta mix both raise."""
    meta = torch.empty(1, 16, 2, 40, device="meta")
    cpu = torch.zeros(1, 16, 2, 40)
    with pytest.raises(ValueError):
        k2.flash_attention_nlhd(meta, meta, meta)
    with pytest.raises(ValueError):
        k1.region_softmax_attention(cpu, cpu, cpu,
                                    torch.empty(1, 16, 16, device="meta"))
