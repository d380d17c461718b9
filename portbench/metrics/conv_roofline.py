"""The convolutions against their roofline: the least time of every 3x3
convolution the profiled requests need (UNet and VAE decoder, or the HED
network; the larger of the operations at the peak of the configuration's
type and the bytes at the HBM bandwidth, input, weights and output moved
once), over the device time of the conv group's kernels (cuDNN's fprop
kernels, K4, K5). The 1x1 convolutions are not counted: their share of
the work is small and what runs them depends on the library."""

from portbench import flops, profiles


def read(run):
    p = run.profile
    if not p:
        return None
    spent = sum(e - s for name, s, e in p["events"]
                if profiles.is_conv(name)) / 1e9
    if spent <= 0:
        return None
    least = p["requests"] * sum(
        flops.least_seconds(op, run.peaks, run.dtype) for op in run.request_ops
        if op[0] == "conv" and op[4] == 3)
    return 100.0 * least / spent
