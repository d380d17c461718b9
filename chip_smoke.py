"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. build: compile every CUDA source of the port with nvcc (one process per
   source, all started together) and print the card's name and power limit;
2. kernels: K1 (region attention) and K2 (attention) against their plain
   PyTorch versions at every shape the SD1.5 512^2 main path gives them,
   and their times beside the plain version's, the least time the card
   could take (bound) and ``scaled_dot_product_attention`` as a yardstick
   (``library_ms``; the port never calls it);
3. tiny: the tiny config's txt2img (fp32, 64x64, 4 steps, with and without a
   two-phrase region map, the same weights and latents) on the card against
   the port on the CPU, where the kernels' plain versions run;
4. main: SD1.5 at full width (random bf16 weights from a seed), the request
   ``bench.py`` times: 512^2, 25 DPM++ 2M steps on Karras sigmas, CFG 7.5,
   a two-phrase region map, VAE decode to uint8. It serves spatial requests
   at batch 1, vanilla requests at batch 1 and spatial requests at batch 2,
   checks every image and the kernels' launch counts, and prints the p50
   seconds per image of each request type after one warm-up.

Then it prints the card's name and power limit, one ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": {...}}``.

``--phases`` runs a subset (for example ``--phases build,kernels``); the
result lines are printed only when every phase ran.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

PHASES = ("build", "kernels", "tiny", "main")

PROMPT = "a red cat sitting on a wooden bench, a blue bird flying"
NEG = "bad quality, low quality, jpeg artifact, cropped"

# SD1.5 at 512^2: (L, D) of the attention at each UNet level, and the
# transformers at that level in one UNet call (2 down + 3 up, 1 in the mid
# block). Batch is the CFG pair, 8 heads, S = 77 text tokens.
LEVELS = ((4096, 40, 5), (1024, 80, 5), (256, 160, 5), (64, 160, 1))
BATCH, HEADS, TEXT = 2, 8, 77
STEPS = 25
PER_UNET = sum(n for _, _, n in LEVELS)  # 16 transformers

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and the rate of
# the operand type (bf16 on the tensor cores, fp32 on the CUDA cores).
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

K1_REPLACES = "diffusionspatialcontrol_tpu/ops/pallas/region_attention.py:41"
K2_REPLACES = "diffusionspatialcontrol_tpu/ops/pallas/flash_attention.py:77"


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


def check_close(name, got, want, rtol, atol) -> float:
    """Assert |got - want| <= atol + rtol |want| elementwise; returns the max
    absolute error."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)}, expected "
                             f"{tuple(want.shape)}")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise AssertionError(
            f"{name}: max abs err {float(err.max()):.3e} exceeds "
            f"rtol {rtol} / atol {atol} at {int(bad.sum())} elements")
    return float(err.max())


class ColdTimer:
    """Median device time of one call, with the 50 MB L2 cache flushed
    before each call (the main path finds its operands mostly evicted by
    the convolutions in between), timed with CUDA events."""

    def __init__(self, device):
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, reps: int = 10, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def rms(t: torch.Tensor) -> float:
    return float(t.float().square().mean().sqrt())


def bound(b, h, l, s, d, dtype, bias: bool):
    """(ms, what bounds it) of softmax(QK^T + w)V: each input read once and
    the output written once, against the operations of QK^T and PV."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * (2 * b * l * h * d + 2 * b * s * h * d)
    if bias:
        nbytes += 4 * b * l * s
    ops = 4 * b * h * l * s * d
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), t_bytes, t_ops


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build(ctx):
    from diffusionspatialcontrol_tpu_torch.ops.kernels import _build

    seconds = _build.build()
    log(f"build: {len(_build.SOURCES)} CUDA sources in {seconds:.1f} s "
        f"({', '.join(str(_build.library_path(n).name) for n in _build.SOURCES)})")
    log(f"card: {card_line()}")


def _qkv(g, b, l, s, h, d, dtype, device):
    q = torch.randn(b, l, h, d, generator=g, device=device).to(dtype)
    k = torch.randn(b, s, h, d, generator=g, device=device).to(dtype)
    v = torch.randn(b, s, h, d, generator=g, device=device).to(dtype)
    return q, k, v


def phase_kernels(ctx):
    """K1 and K2, through the wrappers the UNet calls, against their plain
    versions at every main-path shape.

    Tolerances: fp32 operands rtol 2e-4 / atol 2e-5 (the JAX package's own
    kernel tolerance, tests/test_pallas.py). bf16 operands against the plain
    version in fp32 on the same bf16 values: rtol 1e-2, over the output's
    bf16 rounding (at most 2^-8 relative), and atol 5% of the reference's
    RMS, for outputs near zero; at level-0 self-attention the RMS is about
    0.026, so a fault in the bf16 loads or stores cannot hide under a fixed
    atol. K2 with pv_bf16 and exp2 on, against the plain version with the
    same options, at the same tolerance: each side rounds P to bf16 (2^-9
    relative) against its own running or final max, which moves an output
    by about 2^-9 of its typical size."""
    import torch.nn.functional as F

    from diffusionspatialcontrol_tpu_torch.ops.kernels import flash_attention as k2
    from diffusionspatialcontrol_tpu_torch.ops.kernels import region_attention as k1

    dev = ctx["device"]
    g = torch.Generator(device=dev).manual_seed(0)
    timer = ColdTimer(dev)
    rows = {"K1": [], "K2": [], "K2 cross": []}
    errs = {"K1": [0.0, 0.0], "K2": [0.0, 0.0]}  # [fp32, bf16]

    def sdpa(q, k, v, mask=None):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask)

    cases = []
    for l, d, n in LEVELS:
        cases.append(("K2", l, l, d, n))          # self-attention
        cases.append(("K2 cross", l, TEXT, d, n))  # cross-attention, vanilla
        cases.append(("K1", l, TEXT, d, n))       # cross-attention, spatial
    for name, l, s, d, n in cases:
        kern = "K1" if name == "K1" else "K2"
        tag = f"{name} L={l} S={s} D={d}"
        q, k, v = _qkv(g, BATCH, l, s, HEADS, d, torch.float32, dev)
        w = torch.randn(BATCH, l, s, generator=g, device=dev)
        if kern == "K1":
            def run(q, k, v):
                return k1.region_softmax_attention(q, k, v, w)

            def plain(q, k, v):
                return k1.region_softmax_attention_plain(q, k, v, w)
        else:
            run, plain = k2.flash_attention_nlhd, k2.flash_attention_plain
        e32 = check_close(f"{tag} fp32", run(q, k, v), plain(q, k, v),
                          2e-4, 2e-5)
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        q16, k16, v16 = (t.float() for t in (qb, kb, vb))
        out = run(qb, kb, vb)
        if out.dtype != torch.bfloat16:
            raise AssertionError(f"{tag}: bf16 operands gave {out.dtype}")
        want = plain(q16, k16, v16)
        e16 = check_close(f"{tag} bf16", out, want, 1e-2, 0.05 * rms(want))
        if kern == "K2":
            opt = k2.flash_attention_nlhd(qb, kb, vb, pv_bf16=True,
                                          use_exp2=True)
            want = plain(q16, k16, v16, pv_bf16=True, use_exp2=True)
            e16 = max(e16, check_close(f"{tag} bf16 +pvbf16+exp2", opt, want,
                                       1e-2, 0.05 * rms(want)))
        torch.cuda.synchronize()
        errs[kern][0] = max(errs[kern][0], e32)
        errs[kern][1] = max(errs[kern][1], e16)

        mask = w[:, None].to(torch.bfloat16) if kern == "K1" else None
        ms = timer(lambda: run(qb, kb, vb))
        plain_ms = timer(lambda: plain(qb, kb, vb), reps=5)
        lib_ms = timer(lambda: sdpa(qb, kb, vb, mask))
        b_ms, t_bytes, t_ops = bound(BATCH, HEADS, l, s, d, torch.bfloat16,
                                     kern == "K1")
        rows[name].append({
            "L": l, "S": s, "D": d, "per_unet_call": n, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": 1e3 * t_bytes, "operations_ms": 1e3 * t_ops,
            "max_abs_err_fp32": e32, "max_abs_err_bf16": e16})
        log(f"kernels: {tag}: fp32 err {e32:.2e}, bf16 err {e16:.2e}; "
            f"bf16 {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
            f"ms, bound {b_ms:.4f} ms ({rows[name][-1]['bound_by']})")
        del q, k, v, qb, kb, vb, q16, k16, v16, w, out, want

    # K1's bias broadcasts over heads: identical q/k/v in every head give
    # identical outputs in every head.
    l, d = LEVELS[0][:2]
    q, k, v = (t.expand(-1, -1, HEADS, -1).contiguous().to(torch.bfloat16)
               for t in _qkv(g, BATCH, l, TEXT, 1, d, torch.float32, dev))
    w = torch.randn(BATCH, l, TEXT, generator=g, device=dev)
    out = k1.region_softmax_attention(q, k, v, w)
    for h in range(1, HEADS):
        if not torch.equal(out[:, :, h], out[:, :, 0]):
            raise AssertionError(f"K1 head broadcast: head {h} differs")
    log("kernels: K1 head broadcast: all heads identical")

    def summary(per_call_rows):
        """Sums over the launches of one UNet call."""
        tot = {key: sum(r[key] * r["per_unet_call"] for r in per_call_rows)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                           "bytes_ms", "operations_ms")}
        tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["operations_ms"]
                           else "operations")
        return tot

    ctx["kernels"] = {
        "K1": dict(summary(rows["K1"]), err=errs["K1"], shapes=rows["K1"]),
        "K2": dict(summary(rows["K2"]), err=errs["K2"],
                   shapes=rows["K2"] + rows["K2 cross"]),
    }


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _masks(h, w):
    m1 = np.zeros((h, w), np.float32)
    m1[:, : w // 2] = 1.0
    m2 = np.zeros((h, w), np.float32)
    m2[: h // 3, w // 2:] = 1.0
    return {"red cat": {"mask": m1, "weight": 0.8, "mask_outsides": 0.2},
            "blue bird": {"mask": m2, "weight": 0.7, "mask_outsides": 0.1}}


def _counts():
    from diffusionspatialcontrol_tpu_torch.ops.kernels import flash_attention as k2
    from diffusionspatialcontrol_tpu_torch.ops.kernels import region_attention as k1

    return (k1.region_softmax_attention.launches,
            k2.flash_attention_nlhd.launches)


def phase_tiny(ctx):
    """Tiny config, fp32, the same weights and latents on the card (kernels)
    and on the CPU (their plain versions). Tolerance: 2e-4 on fp32 pixels in
    [-1, 1] and +-1 on uint8. Both sides compute in fp32 (TF32 is off), but
    cuDNN and ATen's CPU convolutions and the kernels' online softmax sum in
    other orders, through 4 steps of ~40 layers: an H100 run differed by
    5e-6, and the port and the JAX package agree to 1e-4 on the CPU
    (tests/test_torch_pipeline.py)."""
    from diffusionspatialcontrol_tpu_torch import GenerationConfig, tiny_config
    from diffusionspatialcontrol_tpu_torch.models.factory import (
        init_pipeline_params,
    )
    from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
        StableDiffusionTorch,
    )
    from diffusionspatialcontrol_tpu_torch.text.tokenizer import HashTokenizer

    cfg = tiny_config()
    cpu = torch.device("cpu")
    params = init_pipeline_params(0, cfg, torch.float32, device=cpu)
    pipes = {dev.type: StableDiffusionTorch(cfg, _tree_to(params, dev),
                                            tokenizer=HashTokenizer(),
                                            device=dev)
             for dev in (cpu, ctx["device"])}
    gen = GenerationConfig(height=64, width=64, num_inference_steps=4,
                           dtype=torch.float32)
    lat = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 8, 8, 4)).astype(np.float32))
    for spatial in (True, False):
        out = {}
        for kind, pipe in pipes.items():
            c, ids = pipe.encode_prompt([PROMPT], [NEG])
            rb = (pipe.encode_region([_masks(64, 64)], ids, 64, 64)
                  if spatial else None)
            before = _counts()
            img = pipe.txt2img(c, gen, latents=lat, region_biases=rb)
            after = _counts()
            if kind == "cuda":
                d1, d2 = after[0] - before[0], after[1] - before[1]
                want = (4 * PER_UNET, 4 * PER_UNET) if spatial else \
                    (0, 8 * PER_UNET)
                if (d1, d2) != want:
                    raise AssertionError(
                        f"tiny: launches K1 {d1}, K2 {d2}, expected {want}")
            elif after != before:
                raise AssertionError("tiny: a CPU run counted launches")
            out[kind] = img.cpu()
        err = check_close(f"tiny spatial={spatial}", out["cuda"], out["cpu"],
                          0.0, 2e-4)
        u8 = [StableDiffusionTorch.to_uint8(out[k]).int()
              for k in ("cuda", "cpu")]
        u8_err = int((u8[0] - u8[1]).abs().max())
        if u8_err > 1:
            raise AssertionError(f"tiny: uint8 differs by {u8_err}")
        log(f"tiny: spatial={spatial}: card vs CPU max abs err {err:.2e} "
            f"(fp32), {u8_err} (uint8)")


def phase_main(ctx):
    from diffusionspatialcontrol_tpu_torch import GenerationConfig, sd15_config
    from diffusionspatialcontrol_tpu_torch.models.factory import (
        init_pipeline_params,
        param_count,
    )
    from diffusionspatialcontrol_tpu_torch.ops.kernels import flash_attention as k2
    from diffusionspatialcontrol_tpu_torch.ops.kernels import region_attention as k1
    from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
        StableDiffusionTorch,
    )
    from diffusionspatialcontrol_tpu_torch.text.tokenizer import load_tokenizer

    cfg = sd15_config()
    t0 = time.perf_counter()
    params = init_pipeline_params(0, cfg, torch.bfloat16)
    pipe = StableDiffusionTorch(cfg, params, tokenizer=load_tokenizer())
    torch.cuda.synchronize()
    log(f"main: SD1.5 {param_count(params) / 1e6:.1f} M parameters (bf16, "
        f"random from seed 0) on {pipe.device} in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = GenerationConfig(height=512, width=512, num_inference_steps=STEPS,
                           guidance_scale=7.5, sampler="dpmpp_2m",
                           schedule="karras")
    c1, ids1 = pipe.encode_prompt([PROMPT], [NEG], clip_skip=2)
    c2, ids2 = pipe.encode_prompt([PROMPT] * 2, [NEG] * 2, clip_skip=2)
    state = _masks(512, 512)
    rb1 = pipe.encode_region([state], ids1, height=512, width=512)
    rb2 = pipe.encode_region([state, state], ids2, height=512, width=512)

    per_request = {"spatial": (STEPS * PER_UNET, STEPS * PER_UNET),
                   "vanilla": (0, 2 * STEPS * PER_UNET)}
    requests = (  # (type, context, region biases, seeds: first is warm-up)
        ("spatial", c1, rb1, [0, 1, 2, 3, 4, 5]),
        ("vanilla", c1, None, [0, 1, 2, 3, 4, 5]),
        ("spatial_b2", c2, rb2, [[0, 1], [2, 3], [4, 5], [6, 7]]),
    )
    k1.region_softmax_attention.launches = 0
    k2.flash_attention_nlhd.launches = 0
    p50 = {}
    for kind, ctx_, rb, seeds in requests:
        per_image = []
        for i, seed in enumerate(seeds):
            batch = len(seed) if isinstance(seed, list) else 1
            before = _counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = pipe.txt2img(ctx_, gen, seed=seed, region_biases=rb)
            u8 = pipe.to_uint8(img).cpu()
            dt = time.perf_counter() - t0
            after = _counts()
            launches = (after[0] - before[0], after[1] - before[1])
            want = per_request["vanilla" if rb is None else "spatial"]
            if launches != want:
                raise AssertionError(f"main {kind} seed {seed}: launches "
                                     f"K1, K2 = {launches}, expected {want}")
            if tuple(img.shape) != (batch, 512, 512, 3) or \
                    img.dtype != torch.float32:
                raise AssertionError(f"main {kind}: image {tuple(img.shape)} "
                                     f"{img.dtype}")
            if not bool(torch.isfinite(img).all()):
                raise AssertionError(f"main {kind} seed {seed}: non-finite "
                                     f"image")
            if tuple(u8.shape) != (batch, 512, 512, 3) or \
                    u8.dtype != torch.uint8:
                raise AssertionError(f"main {kind}: uint8 {tuple(u8.shape)}")
            log(f"main: {kind} seed {seed}: {dt:.3f} s "
                f"({'warm-up' if i == 0 else f'{dt / batch:.3f} s/image'}), "
                f"launches K1 {launches[0]} K2 {launches[1]}, "
                f"image mean {float(img.mean()):+.4f} std "
                f"{float(img.std()):.4f}")
            if i:
                per_image.append(dt / batch)
        p50[kind] = float(np.median(per_image))
    ctx["launches"] = _counts()
    ctx["p50"] = p50
    log("main: p50 s/image after one warm-up: " + ", ".join(
        f"{k} {v:.4f}" for k, v in p50.items())
        + f"; launches K1 {ctx['launches'][0]}, K2 {ctx['launches'][1]} "
        f"(card: {card_line()})")
    if min(ctx["launches"]) == 0:
        raise AssertionError("main: a kernel of the path never launched")
    for kind, rb in (("spatial", rb1), ("vanilla", None)):
        profile_request(pipe, c1, gen, rb, kind, p50[kind])


KERNEL_GROUPS = (  # (group, test on the lower-cased kernel name)
    ("K1", lambda n: "attention_kernel" in n and "true>" in n),
    ("K2", lambda n: "attention_kernel" in n and "false>" in n),
    ("conv", lambda n: "conv" in n or "fprop" in n or "dgrad" in n),
    ("gemm", lambda n: "gemm" in n or "nvjet" in n or "cutlass" in n),
    ("norm", lambda n: "norm" in n),
    ("other", lambda n: True),
)


def profile_request(pipe, context, gen, region_biases, kind, p50_s):
    """One batch-1 request under torch.profiler: the device's busy time (sum
    of kernel times) against the request's unprofiled p50 wall time, kernel
    launches, and device time by kernel group and by kernel. The profiler's
    own cost on the host inflates the profiled wall time, so the busy share
    is taken against the p50."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        img = pipe.txt2img(context, gen, seed=99, region_biases=region_biases)
        pipe.to_uint8(img).cpu()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    count = sum(e.count for e in kernels)
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    for e in kernels:
        name = e.key.lower()
        group = next(g for g, test in KERNEL_GROUPS if test(name))
        groups[group] += e.self_device_time_total / 1e3
    log(f"profile: {kind}: device busy {busy_ms:.1f} ms = "
        f"{100 * busy_ms / (1e3 * p50_s):.1f}% of the p50 wall "
        f"({1e3 * p50_s:.1f} ms; {wall_ms:.1f} ms profiled), {count} kernel "
        f"launches; by group (ms): " + ", ".join(
            f"{g} {t:.1f}" for g, t in groups.items()))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log(f"profile: {kind}:   {e.self_device_time_total / 1e3:8.2f} ms "
            f"x{e.count:<5d} {e.key[:110]}")


def kernels_line(ctx):
    k = ctx["kernels"]
    out = []
    for name, src, rep, launches in (
            ("K1 region_attention", "region_attention.cu", K1_REPLACES,
             ctx["launches"][0]),
            ("K2 flash_attention", "flash_attention.cu", K2_REPLACES,
             ctx["launches"][1])):
        r = k[name[:2]]
        out.append({
            "name": name, "route": "cuda",
            "source": f"diffusionspatialcontrol_tpu_torch/csrc/{src}",
            "replaces": rep, "launches": launches,
            "max_abs_err": r["err"][1], "max_abs_err_fp32": r["err"][0],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "per": "the 16 launches of one SD1.5 512^2 UNet call on the "
                   "spatial path, bf16, cold L2; library = "
                   "scaled_dot_product_attention",
            "shapes": r["shapes"]})
    return json.dumps({"kernels": out})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on "
              "the card and has nothing to run here", file=sys.stderr)
        return 1
    import diffusionspatialcontrol_tpu_torch  # noqa: F401  (fails outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = {"device": torch.device("cuda")}
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    run = {"build": phase_build, "kernels": phase_kernels,
           "tiny": phase_tiny, "main": phase_main}
    t_all = time.perf_counter()
    for name in PHASES:
        if name not in phases:
            continue
        t0 = time.perf_counter()
        with torch.inference_mode():
            run[name](ctx)
        torch.cuda.synchronize()
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s "
            f"({time.perf_counter() - t_all:.1f} s since the start)")
    if phases != list(PHASES):
        log("chip_smoke: not every phase ran; no result line")
        return 0
    print(card_line())
    print(kernels_line(ctx))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
