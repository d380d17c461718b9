"""The UNet's attentions against their roofline: the least time of every
self- and cross-attention the profiled requests need (the larger of the
operations at the bf16 peak and the bytes at the HBM bandwidth, each of Q,
K, V, a region bias and O moved once), over the device time of the
kernels that compute attention, matched by name (K1, K2, PyTorch's SDPA
kernels). The text encoder's and the VAE's attentions are plain matrix
products and count on neither side."""

from portbench import flops, profiles


def read(run):
    p = run.profile
    if not p:
        return None
    spent = sum(e - s for name, s, e in p["events"]
                if profiles.is_attention(name)) / 1e9
    if spent <= 0:
        return None
    least = p["requests"] * sum(
        flops.least_seconds(op, run.peaks, run.dtype) for op in run.request_ops
        if op[0] == "attn" and op[7] == "unet")
    return 100.0 * least / spent
