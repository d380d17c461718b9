"""Attention ops, including the region-biased cross-attention core (port of
``ops/attention.py``).

The mechanism:

    s   = Q @ K^T * scale
    w   = region_state * sigma * std(s)      # std over the WHOLE logits tensor
    out = softmax(s + broadcast_over_heads(w)) @ V

``std`` is the unbiased (ddof=1) standard deviation over every element of the
(B, H, L, S) logits tensor, across both CFG halves. The bias ``w`` is
(B, L, S) and is broadcast across heads. Softmax is float32.

Everything here is plain PyTorch: the materialized oracles the tests hold
the kernels to, the centered-Gram std with the bias it scales (plain
reductions in the JAX package too), and ``attention_probs``, the softmax
probabilities the heatmap taps of ``models/unet.py`` read (a plain XLA op in
the JAX package). The BTNH entry points the UNet calls,
``flash_attention_nlhd`` and ``region_attention_nlhd``, live with their
kernels in ``ops/kernels``. The JAX package's ``axis_name`` branch (the
std inside ``shard_map``) is ``logits_std_gram_nlhd``'s ``mesh``: the moment
sums all-reduced over the ranks of a data-parallel mesh (``parallel/``).
"""

from __future__ import annotations

from typing import Optional

import torch


def _std_unbiased(x: torch.Tensor) -> torch.Tensor:
    """torch.Tensor.std() over all elements, in fp32."""
    return x.float().std()


def attention_reference(q, k, v, scale: Optional[float] = None):
    """Materialized-logits attention. q: (B, H, L, D); k, v: (B, H, S, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhld,bhsd->bhls", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhls,bhsd->bhld", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def _centered_gram_moments(qc, kc, q_mean, k_mean, scale, L, S):
    """Per-(b,h) mean and centered sum of squares of s = scale * Q K^T from
    centered Gram matrices (see the JAX package's docstring for the
    derivation; every term is non-negative, so there is no cancellation)."""
    qc_gram = torch.einsum("bhld,bhle->bhde", qc, qc)
    kc_gram = torch.einsum("bhsd,bhse->bhde", kc, kc)
    tr = torch.einsum("bhde,bhde->bh", qc_gram, kc_gram)
    term_q = S * torch.einsum("bhd,bhde,bhe->bh", k_mean, qc_gram, k_mean)
    term_k = L * torch.einsum("bhd,bhde,bhe->bh", q_mean, kc_gram, q_mean)
    means = torch.einsum("bhd,bhd->bh", q_mean, k_mean) * scale
    m2 = (tr + term_q + term_k) * (scale * scale)
    return means, m2


def _combine_moments(means, m2, n_group: int) -> torch.Tensor:
    """Parallel-variance rule over equal-sized groups -> unbiased std."""
    n = means.numel() * n_group
    grand_mean = means.mean()
    total_m2 = m2.sum() + n_group * ((means - grand_mean) ** 2).sum()
    return torch.sqrt(torch.clamp(total_m2 / (n - 1), min=0.0))


def logits_std_gram(q, k, scale: float) -> torch.Tensor:
    """Unbiased std of s = scale * Q K^T without materializing s.
    q: (B, H, L, D); k: (B, H, S, D). Returns a 0-d fp32 tensor."""
    qf, kf = q.float(), k.float()
    L, S = q.shape[2], k.shape[2]
    q_mean = qf.mean(dim=2)
    k_mean = kf.mean(dim=2)
    means, m2 = _centered_gram_moments(
        qf - q_mean[:, :, None], kf - k_mean[:, :, None],
        q_mean, k_mean, scale, L, S)
    return _combine_moments(means, m2, L * S)


def logits_std_gram_nlhd(q, k, scale: float, mesh=None) -> torch.Tensor:
    """BTNH variant of ``logits_std_gram`` (q: (B, L, H, D)).

    With ``mesh`` (``parallel.mesh.Mesh``; q and k this rank's equal shard
    of the batch) the std is global over every rank's batch, as the
    reference's is over the whole CFG batch (attention_modify.py:95): one
    fp32 tensor [sum m2, sum means, sum means^2] is all-reduced, the only
    collective of a sampling step, and combined by the JAX package's
    ``axis_name`` formula (its attention.py:232-240), which differs from
    ``_combine_moments`` by rounding. The result stays a 0-d tensor on the
    device: nothing waits for the host."""
    qf, kf = q.float(), k.float()
    L, S = q.shape[1], k.shape[1]
    q_mean = qf.mean(dim=1)  # (B, H, D)
    k_mean = kf.mean(dim=1)
    qc = (qf - q_mean[:, None]).transpose(1, 2)  # (B, H, L, D)
    kc = (kf - k_mean[:, None]).transpose(1, 2)
    means, m2 = _centered_gram_moments(qc, kc, q_mean, k_mean, scale, L, S)
    n_group = L * S
    if mesh is None:
        return _combine_moments(means, m2, n_group)
    sums = mesh.all_reduce(torch.stack(
        [m2.sum(), means.sum(), (means * means).sum()]))
    t_m2, t_mean, t_mean2 = sums.unbind()
    groups = means.numel() * mesh.world_size
    grand_mean = t_mean / groups
    between = torch.clamp(t_mean2 - groups * grand_mean ** 2, min=0.0)
    total_m2 = t_m2 + n_group * between
    return torch.sqrt(torch.clamp(total_m2 / (groups * n_group - 1),
                                  min=0.0))


def region_bias(region_state, sigma, std, weight_scale: float = 1.0):
    """w = region_state * (weight_scale * sigma * std), fp32 (B, L, S)."""
    return region_state.float() * (
        weight_scale * sigma.float() * std)


def region_attention_reference(q, k, v, region_state, sigma,
                               weight_scale: float = 1.0,
                               scale: Optional[float] = None):
    """Materialized-logits oracle, step by step like the reference
    (q: (B, H, L, D))."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhld,bhsd->bhls", q.float(), k.float()) * scale
    std = _std_unbiased(logits)
    w = region_bias(region_state, sigma, std, weight_scale)
    probs = torch.softmax(logits + w[:, None], dim=-1)
    out = torch.einsum("bhls,bhsd->bhld", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def attention_probs(q, k, region_state=None, sigma=None) -> torch.Tensor:
    """Softmax attention probabilities (B, H, L, S), fp32, for the DAAM
    heatmaps. q: (B, H, L, D); k: (B, H, S, D). With ``region_state`` the
    logits take the region term, its std the exact unbiased std of the full
    logits (``_std_unbiased``, as the JAX package's), not the Gram form."""
    logits = (torch.einsum("bhld,bhsd->bhls", q.float(), k.float())
              * q.shape[-1] ** -0.5)
    if region_state is not None:
        std = _std_unbiased(logits)
        logits = logits + region_bias(region_state, sigma, std)[:, None]
    return torch.softmax(logits, dim=-1)
