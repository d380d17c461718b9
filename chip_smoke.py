"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. build: compile every CUDA source of the port with nvcc (one process per
   source, all started together) and the image codec with g++, and print
   the card's name and power limit;
2. kernels: K1 (region attention) and K2 (attention) against their plain
   PyTorch versions at every shape the SD1.5 512^2 main path gives them,
   and both at the S of longer prompts at every level: the context lengths
   of two to four prompt chunks (K1 at 154, 231 and 308, K2 at 154 and
   231) and the id counts of long-mode prompts of two and three chunks
   (152, 227);
   K1 and K2 at SD2.1's 512^2 shapes (D = 64 with 5, 10 and 20 heads);
   K2 at the two shapes where the JAX package streams (K3: the level-0
   self-attention at 1024^2, L = 16384, and at 1920x1088, L = 32640); K4
   and K5 (the fused GroupNorm+SiLU+conv3x3) at every resnet-conv shape of
   the UNet and the VAE decoder at 512^2 and 1024^2 and of the VAE encoder
   at 512^2 (img2img and inpaint); K2 at IP-Adapter's shapes (the
   decoupled cross-attention at S = 1, 4 and 16 image tokens at every
   level and at the hires pass's L = 16384, the ViT-H/14 tower's
   L = S = 257 at D = 80, the Resampler's L = 16, S = 273 at D = 64); K1
   and K2 at every level of bottleneck sampling's 32^2 latents (level 0:
   L = 1024 at D = 40),
   with the RMS-relative error beside the elementwise one and, where the C_in chunks are split
   over several blocks, two launches held bitwise equal. Each with its time
   beside the plain version's, the least time the card could take (bound;
   the log lines of attention also give the time of its exps alone, and
   K2's self-attentions the times of its three other option instances) and
   one library call as a yardstick (``library_ms``: SDPA for attention,
   cuDNN's conv for K4/K5; the port never calls them); the convs also
   beside the port's own unfused resnet conv (``unfused_ms``: GroupNorm,
   SiLU, library conv, adds, as ``conv_impl="xla"`` runs them);
3. tiny: the tiny config's txt2img (fp32, 64x64, 4 steps, with and without a
   two-phrase region map, the same weights and latents) on the card against
   the port on the CPU, where the kernels' plain versions run; the same
   with the fused resnet convs (``conv_impl="pallas"`` and ``"pallas2"``),
   a hires request (64^2 -> 128^2, 4 + 2 steps) and one with another
   sampler for the hires pass; every solver of the app's sampler table
   (the non-Karras schedules among them); prompts of two chunks in the
   "a1111" mode (with a map) and the "long" mode; a chunked run paused
   and resumed, bitwise equal on the card to the plain run; a txt2img
   request with ``conv_impl="xla_bf16"``; and the images-in requests:
   ``encode_image`` then ``img2img`` (plain convs, and K5 through the
   encoder), inpaint on the 4-channel UNet (strength 1.0 and 0.75), on a
   9-channel UNet and with an asymmetric VAE, and an SD2.1-style model
   (gelu CLIP, linear projections, v-prediction); and the units:
   ControlNets with random heads (one; two with keep windows and a
   T2I-Adapter; guess mode; Heun with a window; img2img at strength 0.75;
   hires with the units rebuilt at 128^2), each also required to move the
   image; and IP-Adapter: each of the six names of the app's table two
   units at once (one masked), embedded as the app embeds them (a tiny
   CLIP-vision tower; for FaceID the tiny SCRFD detector and a 512-wide
   tiny ArcFace), and a hires request reusing the tokens; and the speed
   modes (TGATE, DeepCache, cfg-tail, bottleneck sampling at 128^2),
   ``heatmaps_for_state`` and ``unet_apply`` with FreeU (cuFFT). The
   card's uint8 conversion must equal the JAX package's codec rounding
   bit for bit. Launches are exact: 16 of K1 and K2 per UNet
   call, and 14 of K2 per ControlNet call, the calls counted at the
   denoiser;
4. main: SD1.5 at full width (random bf16 weights from a seed), the request
   ``bench.py`` times: 512^2, 25 DPM++ 2M steps on Karras sigmas, CFG 7.5,
   a two-phrase region map, VAE decode to uint8. It serves spatial requests
   at batch 1, vanilla requests at batch 1 and spatial requests at batch 2,
   spatial requests with the fused resnet convs (K4, then K5), hires
   requests 512^2 -> 1024^2 (strength 0.6, the map re-encoded at 1024^2;
   plain convs, then K4), and two requests of the app's own modes: an
   "a1111" prompt of two chunks with the map and "DPM++ 2M SDE Karras"
   (K1 at S = 154), and the same prompt in "long" mode without a map on
   "Heun" (K2's cross-attention at S = 154, two UNet calls a step); then
   the images-in requests on a synthetic 512^2 image: img2img from pixels
   (strength 0.8) and inpaint of its right half (4-channel blend), the
   same inpaint on ``sd15_inpaint_config()`` (9-channel UNet) and on
   ``sd15_asym_inpaint_config()`` (that UNet with the asymmetric VAE),
   and txt2img on ``sd21_config()``, each model's weights kept for its
   profile; before those, the unit requests (``spatial_controlnet``: a
   ControlNet with random heads; ``spatial_t2i``: the full T2I-Adapter;
   ``hires_controlnet``: 512^2 -> 1024^2 with the ControlNet, K2 at
   L = 16384 in both models) and the IP-Adapter requests through a
   ``ModelManager``'s ViT-H/14 tower, SCRFD detector and ArcFace embedder
   (``spatial_ip``, ``spatial_ip_plus_masked``, ``faceid`` on a raw
   photo, ``hires_ip``); the unit requests' denoiser calls may not read
   from the card. It checks every image, the UNet calls and the kernels'
   exact launch counts, prints the p50 seconds per image of each request
   type after one warm-up, and profiles one request of most types by its
   kernels (the spatial request also with the host's ops) at the end of
   the run, after every phase's timed requests: a profile leaves the host
   slower at launching for the rest of the process;
5. modes: the opt-in speed modes and DAAM on SD1.5 at full width, main's
   spatial request otherwise: TGATE at gate 0.5 with and without the map,
   DeepCache at interval 3 with plain convs and with K5, bottleneck
   sampling at low_scale 0.5 (K1/K2 at L = 1024), cfg-tail at 0.3, each
   with exact UNet calls and launches, its denoiser calls free of host
   reads, its p50 after one warm-up and one profile at the end; and the
   DAAM heatmaps of a spatial request's trajectory (24 replayed UNet
   calls) with the time of the maps alone;
6. weights: SD1.5 at full width from disk: random weights drawn in fp32,
   written as a diffusers checkpoint in fp16 by the port's own safetensors
   writer and loaded in bf16 by ``ModelManager.get``, by ``cached_convert``
   (convert and snapshot, then restore) and by a server started with
   ``--model``; every loaded leaf equal to the drawn tree after fp32 ->
   fp16 -> bf16 bit for bit, the spatial request's PNG from the checkpoint
   equal to the drawn tree's (``inference()`` and the POST), the spatial
   request and a ``"pallas2"`` one timed on the loaded tree, a full-width
   rank-8 LoRA and a textual-inversion file merged by ``get_variant``
   (each merged leaf equal to the host numpy merge; the base tree
   unchanged) serving a request with the trigger word, an IP-Adapter Plus
   file with the published depth-4 Resampler (masked, through the
   manager's ViT-H/14 tower) and a ControlNet file, each with its exact
   launches; the seconds to write, read, convert and restore, the host's
   peak RSS and the card's peak allocation;
7. app: the app layer on SD1.5 at full width: ``ModelManager()`` behind the
   JSON HTTP server, in this process. The spatial request over HTTP (the
   PNGs decoded here and held bit for bit to a direct ``inference()`` call
   and to the pipeline; repeated POSTs byte-identical), a job polled to
   25/25 and one cancelled while queued, 2 x 2 grids, a hires request, a
   ControlNet unit (zero heads: the spatial PNG bit for bit), a
   T2I-Adapter unit, an IP-Adapter unit (``inference()``'s PNG bit for
   bit) and the same at scale 0 (the spatial PNG bit for bit), a
   DeepCache request (``inference()``'s PNG bit for bit), and
   ``/warmup``, with exact UNet calls and launches; the HTTP, direct and
   pipeline p50s side by side, and one HTTP request profiled by its
   kernels;
8. preprocess: the control preprocessors. Every detector network at the
   small config of the CPU tests, card against CPU (within 1e-4 of the
   output's largest value); every network at its published width (DPT-
   Large, ZoeDepth's BEiT-L, UperNet-ConvNeXt-T, NNET on EfficientNet-B5,
   the openpose body, hand and face nets, HED, PidiNet, both lineart nets,
   MLSD; random fp32 weights) timed on the card and held to its CPU run
   with cuDNN's TF32 off and on; every name of the app's table through
   ``ModelManager.get_preprocessor`` on a 512^2 photo; the slice's request
   ``spatial_controlnet_depth`` (the spatial request with a ControlNet
   unit whose ``preprocessor`` is "Depth", DPT-Large) through
   ``inference()`` and as a POST /generate, whose PNG must be
   ``inference()``'s bit for bit, with exact K1/K2 launches and one
   profile; and POST /preprocess of "Canny" and "Openpose" (with the
   hand net), each PNG the in-process detector's.

Then it prints the card's name and power limit, one ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": {...}}``.

``--phases`` runs a subset (for example ``--phases build,kernels``); the
result lines are printed only when every phase ran. ``--tree DIR`` runs
those phases of another checkout's chip_smoke.py (a parent commit unpacked
with ``git archive``) with this file's timer, so that two trees' kernel
times are taken alike. ``--no-profiles`` skips the profiles queued for the
end of the run: with ``--phases build,main`` it takes two trees' p50s in
one call. The queued profiles stop once the script has run
``PROFILE_DEADLINE_S`` (900 s), and the log names those left out, so the
whole run stays inside its 1200 s limit; the request types in
``UNPROFILED`` are timed but not profiled.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

PHASES = ("build", "kernels", "tiny", "main", "modes", "weights", "app",
          "preprocess")

PROMPT = "a red cat sitting on a wooden bench, a blue bird flying"
NEG = "bad quality, low quality, jpeg artifact, cropped"

# SD1.5 at 512^2: (L, D) of the attention at each UNet level, and the
# transformers at that level in one UNet call (2 down + 3 up, 1 in the mid
# block). Batch is the CFG pair, 8 heads, S = 77 text tokens.
LEVELS = ((4096, 40, 5), (1024, 80, 5), (256, 160, 5), (64, 160, 1))
BATCH, HEADS, TEXT = 2, 8, 77
STEPS = 25
PER_UNET = sum(n for _, _, n in LEVELS)  # 16 transformers
# Bottleneck sampling's middle phase at low_scale 0.5: the same UNet on a
# 32 x 32 latent, (L, D, transformers a UNet call) at each level.
LEVELS_LOW = tuple((l // 4, d, n) for l, d, n in LEVELS)
# SD2.1 (sd21_config) at 512^2: (L, heads, transformers a UNet call) at each
# level, all at D = 64 (channels / 64 heads), S = 77 on a 1024-wide context.
LEVELS_SD21 = ((4096, 5, 5), (1024, 10, 5), (256, 20, 5), (64, 20, 1))
D_SD21 = 64
L_SD21_768 = 9216  # level 0 of sd21_config(True) at its 768^2 (checks only)

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and the rate of
# the operand type (bf16 on the tensor cores, fp32 on the CUDA cores).
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Softmax exps: 16 special-function results a clock per SM (the
# FlashAttention-3 paper's figure) x 132 SMs x ~1.83 GHz. Attention at
# D = 40 takes longer in exps than in MMAs; the log lines give this time
# beside the bytes-or-operations bound of the result line.
PEAK_EXPS = 3.9e12
CHUNKED_TEXT = (154, 231, 308)  # context S of 2, 3 and 4 prompt chunks
LONG_IDS = (152, 227)  # ids of 2 and 3 long-mode chunks: 75 n + 2
CHUNKED = 154  # the context S of the two-chunk prompt below, either mode

# About 100 tokens with emphasis, a de-emphasis and one BREAK: two chunks in
# the "a1111" mode and in the "long" mode; the map's phrases are in it.
LONG_PROMPT = (
    "a (red cat:1.3) sitting on a [wooden] bench in a quiet sunlit garden, "
    "soft orange fur, green eyes, long white whiskers, a calm summer "
    "afternoon, warm golden light, red and yellow flowers in full bloom, "
    "tall green grass, an old stone wall covered in ivy, BREAK a blue bird "
    "flying high above the garden, wide open wings, bright blue feathers, "
    "a clear sky with small white clouds, distant green hills, "
    "(highly detailed:1.2), sharp focus, vivid colors, soft shadows, "
    "gentle breeze, peaceful mood, fine art photograph")

# Where the JAX package streams K/V (K3): the level-0 self-attention at
# 1024^2 (the hires pass) and at 1920x1088 (kernel check only); B, H, D as
# above.
K3_SHAPES = ((16384, 40), (32640, 40))
HIRES = 1024
# IP-Adapter's attentions on K2: the decoupled cross-attention at each
# level (B = 2, the CFG pair; H = 8) with S = 1 (Face), 4 (base, Light,
# FaceID) and 16 (Plus, Plus Face) image tokens, and at the hires pass's
# level 0 (L = 16384, D = 40) with the base adapter's 4; the ViT-H/14 image
# tower's self-attention, (B, L = S, H, D) = (1, 257, 16, 80), 32 layers
# (31 for the penultimate hidden states); the Resampler's, (1, 16, 12, 64)
# over S = 257 + 16 keys, 2 layers.
IP_TOKENS = (1, 4, 16)
IP_TOWER = (1, 257, 16, 80, 32)  # (B, L = S, H, D, layers)
IP_RESAMPLER = (1, 16, 273, 12, 64, 2)  # (B, L, S, H, D, layers)
ROUNDS = 4  # phase app: timed rounds of each path after one warm-up
# The queued profiles stop once the script has run this long (a profile
# takes 8-52 s), so that it stays inside its 1200 s limit.
PROFILE_DEADLINE_S = 900.0
# request types timed but no longer profiled: PERF.md section 5 holds their
# profiles, and the time goes to phase preprocess (the weights
# phase's init-strides request and inpaint_asym's profiles are dropped too)
UNPROFILED = ("tgate_vanilla", "deepcache_pallas2")
NEW_SEEDS = [0, 1, 2, 3, 4]  # the images-in and SD2.1 requests: a warm-up

_PALLAS = "diffusionspatialcontrol_tpu/ops/pallas/"
REPLACES = {
    "K1": _PALLAS + "region_attention.py:41",
    "K2": _PALLAS + "flash_attention.py:77",
    "K3": _PALLAS + "flash_attention.py:33",
    "K4": _PALLAS + "conv_fused.py:96 (K4a) and :138 (K4b)",
    "K5": _PALLAS + "conv_fused.py:440",
}


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
    the convolutions in between), timed with CUDA events. A spin kernel of
    about half a millisecond after the flush keeps the card busy while the
    host enqueues the call, so the events bracket the call's kernels and
    not the host's time to launch them (tens of microseconds of Python a
    call, which a small kernel would otherwise be charged with)."""

    HOLD_CYCLES = 1_000_000

    def __init__(self, device):
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, reps: int = 10, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(self.HOLD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def resnet_conv_shapes(cfg, height: int, width: int, batch: int = 1,
                       encoder: bool = False):
    """Every fused conv of one UNet call (the CFG pair: 2 * batch), one VAE
    decode (batch) and, with ``encoder``, one VAE encode of a height x
    width image (batch), in call order, as (where, B, H, W, C_in, C_out,
    temb, skip): conv1 of a resnet takes the time projection (UNet only),
    conv2 the shortcut. Derived from the configs alone, with the UNet's skip
    stack simulated; tests/test_torch_conv_fused.py holds it to the calls
    the port makes."""
    out = []

    def resnet(where, b, size, c_in, c_out):
        out.append((where, b, *size, c_in, c_out, where == "unet", False))
        out.append((where, b, *size, c_out, c_out, False, True))

    u = cfg.unet
    size = (height // 8, width // 8)
    sizes = []
    for _ in u.block_out_channels:
        sizes.append(size)
        size = (-(-size[0] // 2), -(-size[1] // 2))  # stride-2 SAME conv
    b0 = u.block_out_channels[0]
    stack, c = [b0], b0
    for lv, c_out in enumerate(u.block_out_channels):
        for _ in range(u.layers_per_block):
            resnet("unet", 2 * batch, sizes[lv], c, c_out)
            c = c_out
            stack.append(c)
        if lv < u.num_levels - 1:
            stack.append(c)  # the downsample's output
    resnet("unet", 2 * batch, sizes[-1], c, c)
    resnet("unet", 2 * batch, sizes[-1], c, c)
    for lv in reversed(range(u.num_levels)):
        c_out = u.block_out_channels[lv]
        for _ in range(u.layers_per_block + 1):
            resnet("unet", 2 * batch, sizes[lv], c + stack.pop(), c_out)
            c = c_out

    v = cfg.vae
    dchans = v.decoder_block_out_channels or v.block_out_channels
    d_layers = v.decoder_layers_per_block or v.layers_per_block
    size = (height // 8, width // 8)
    c = dchans[-1]
    resnet("vae", batch, size, c, c)
    resnet("vae", batch, size, c, c)
    for lv, c_out in enumerate(reversed(dchans)):
        for _ in range(d_layers + 1):
            resnet("vae", batch, size, c, c_out)
            c = c_out
        if lv < len(dchans) - 1:
            size = (2 * size[0], 2 * size[1])
    if encoder:
        size, c = (height, width), v.block_out_channels[0]
        for lv, c_out in enumerate(v.block_out_channels):
            for _ in range(v.layers_per_block):
                resnet("vae_enc", batch, size, c, c_out)
                c = c_out
            if lv < len(v.block_out_channels) - 1:
                # (0, 1)-padded, VALID stride-2 downsample
                size = ((size[0] - 2) // 2 + 1, (size[1] - 2) // 2 + 1)
        resnet("vae_enc", batch, size, c, c)
        resnet("vae_enc", batch, size, c, c)
    return out


def jax_sends_to_k4b(h: int, w: int) -> bool:
    """Whether the JAX package's tile search leaves the whole-map K4a for
    the row-tiled K4b at an H x W map: on this slice's shapes, exactly the
    maps of 128 x 128 and more (tests/test_torch_conv_fused.py re-derives
    it from the search itself)."""
    return h * w >= 128 * 128


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


def exp_ms(b, h, l, s):
    """ms of the B*H*L*S exps of a softmax at the card's exp rate."""
    return 1e3 * b * h * l * s / PEAK_EXPS


def log_option_times(tag, timer, q, k, v, reps: int = 10):
    """Times K2's other three instances (pv_bf16: P rounded to bf16, one
    P.V product; use_exp2: one ex2.approx an exp) on the same operands."""
    from diffusionspatialcontrol_tpu_torch.ops.kernels import flash_attention as k2

    times = []
    for label, opts in (("+pvbf16", {"pv_bf16": True}),
                        ("+exp2", {"use_exp2": True}),
                        ("+pvbf16+exp2", {"pv_bf16": True, "use_exp2": True})):
        ms = timer(lambda: k2.flash_attention_nlhd(q, k, v, **opts),
                   reps=reps)
        times.append(f"{label} {ms:.4f} ms")
    log(f"kernels: {tag} options: " + ", ".join(times))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build(ctx):
    from diffusionspatialcontrol_tpu_torch.ops.kernels import _build
    from diffusionspatialcontrol_tpu_torch.runtime import native

    seconds = _build.build()
    log(f"build: {len(_build.SOURCES)} CUDA sources in {seconds:.1f} s "
        f"({', '.join(str(_build.library_path(n).name) for n in _build.SOURCES)})")
    t0 = time.perf_counter()
    native.tensor_to_u8(np.zeros(1, np.float32))  # raises if it cannot build
    log(f"build: the image codec (native/src/imagecodec.cc) in "
        f"{time.perf_counter() - t0:.1f} s ({native.library_path().name})")
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
    rows = {"K1": [], "K1 chunked": [], "K2": [], "K2 cross": [],
            "K2 chunked": [], "K1 sd21": [], "K2 sd21": [], "K2 ip": [],
            "K2 ip tower": [], "K2 ip resampler": [], "K1 bottleneck": [],
            "K2 bottleneck": []}
    errs = {"K1": [0.0, 0.0], "K2": [0.0, 0.0]}  # [fp32, bf16]

    def sdpa(q, k, v, mask=None):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask)

    cases = []  # (name, L, S, D, launches a UNet call, heads, batch)
    for l, d, n in LEVELS:
        cases.append(("K2", l, l, d, n, HEADS, BATCH))     # self-attention
        cases.append(("K2 cross", l, TEXT, d, n, HEADS, BATCH))  # vanilla
        cases.append(("K1", l, TEXT, d, n, HEADS, BATCH))  # cross, spatial
    for l, d, _ in LEVELS:  # longer prompts: 0 launches a 77-token request
        cases += [("K1 chunked", l, s, d, 0, HEADS, BATCH)
                  for s in sorted(CHUNKED_TEXT + LONG_IDS)]
        cases += [("K2 chunked", l, s, d, 0, HEADS, BATCH)
                  for s in sorted(CHUNKED_TEXT[:2] + LONG_IDS)]
    for l, d, n in LEVELS_LOW:  # bottleneck's middle phase, at 32^2 latents
        cases.append(("K2 bottleneck", l, l, d, n, HEADS, BATCH))
        cases.append(("K1 bottleneck", l, TEXT, d, n, HEADS, BATCH))
    for l, heads, n in LEVELS_SD21 + ((L_SD21_768, 5, 0),):
        # sd21_spatial: self and spatial cross; the v model's 768^2 level 0
        cases.append(("K2 sd21", l, l, D_SD21, n, heads, BATCH))
        cases.append(("K1 sd21", l, TEXT, D_SD21, n, heads, BATCH))
    # IP-Adapter: the decoupled attention (launches a UNet call a adapter),
    # the image tower's and the Resampler's (launches a request)
    for s_ip in IP_TOKENS:
        cases += [("K2 ip", l, s_ip, d, n, HEADS, BATCH)
                  for l, d, n in LEVELS]
    cases.append(("K2 ip", K3_SHAPES[0][0], 4, K3_SHAPES[0][1],
                  LEVELS[0][2], HEADS, BATCH))
    b_t, l_t, h_t, d_t, n_t = IP_TOWER
    cases.append(("K2 ip tower", l_t, l_t, d_t, n_t, h_t, b_t))
    b_r, l_r, s_r, h_r, d_r, n_r = IP_RESAMPLER
    cases.append(("K2 ip resampler", l_r, s_r, d_r, n_r, h_r, b_r))
    for name, l, s, d, n, heads, batch in cases:
        kern = name[:2]
        tag = f"{name} B={batch} L={l} S={s} H={heads} D={d}"
        q, k, v = _qkv(g, batch, l, s, heads, d, torch.float32, dev)
        w = torch.randn(batch, l, s, generator=g, device=dev)
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
        b_ms, t_bytes, t_ops = bound(batch, heads, l, s, d, torch.bfloat16,
                                     kern == "K1")
        rows[name].append({
            "model": ("sd21" if "sd21" in name else "sd15 bottleneck, 32^2"
                      if "bottleneck" in name else "sd15"),
            "B": batch, "L": l, "S": s, "H": heads, "D": d,
            "per_unet_call": n, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": 1e3 * t_bytes, "operations_ms": 1e3 * t_ops,
            "max_abs_err_fp32": e32, "max_abs_err_bf16": e16})
        log(f"kernels: {tag}: fp32 err {e32:.2e}, bf16 err {e16:.2e}; "
            f"bf16 {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
            f"ms, bound {b_ms:.4f} ms ({rows[name][-1]['bound_by']}), exps "
            f"{exp_ms(batch, heads, l, s):.4f} ms")
        if name == "K2":
            log_option_times(tag, timer, qb, kb, vb)
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

    for kern in ("K1", "K2", "K1 sd21", "K2 sd21", "K1 bottleneck",
                 "K2 bottleneck"):
        tot = summary(rows[kern])
        exps = sum(exp_ms(r["B"], r["H"], r["L"], r["S"])
                   * r["per_unet_call"] for r in rows[kern])
        log(f"kernels: {kern}, the {PER_UNET} launches of one UNet call: "
            f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, sdpa "
            f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms, exps "
            f"{exps:.4f} ms")
    # The same sums at the S of longer prompts, K2 on the cross-attention
    per_call = {l: n for l, _, n in LEVELS}
    for name in ("K1 chunked", "K2 cross", "K2 chunked"):
        for s_len in sorted({r["S"] for r in rows[name]}):
            tot = summary([dict(r, per_unet_call=per_call[r["L"]])
                           for r in rows[name] if r["S"] == s_len])
            log(f"kernels: {name[:2]} at S={s_len}, the {PER_UNET} "
                f"cross-attentions of one UNet call: {tot['ms']:.4f} ms, "
                f"plain {tot['plain_ms']:.4f} ms, sdpa "
                f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms")
    # IP-Adapter: the decoupled attentions of one 512^2 UNet call a adapter
    # at each token count, and the tower's and the Resampler's a request
    for s_len in IP_TOKENS:
        tot = summary([r for r in rows["K2 ip"]
                       if r["S"] == s_len and r["L"] <= LEVELS[0][0]])
        log(f"kernels: K2 ip at S={s_len}, the {PER_UNET} decoupled "
            f"attentions of one 512^2 UNet call (one adapter): "
            f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, sdpa "
            f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
            f"({tot['bound_by']})")
    for name, what in (("K2 ip tower", "image-tower layers"),
                       ("K2 ip resampler", "Resampler layers")):
        tot = summary(rows[name])
        log(f"kernels: {name}, the {rows[name][0]['per_unet_call']} "
            f"{what} of one request: {tot['ms']:.4f} ms, plain "
            f"{tot['plain_ms']:.4f} ms, sdpa {tot['library_ms']:.4f} ms, "
            f"bound {tot['bound_ms']:.4f} ms ({tot['bound_by']})")
    ctx["kernels"] = {
        "K1": dict(summary(rows["K1"]), err=errs["K1"],
                   shapes=rows["K1"] + rows["K1 chunked"] + rows["K1 sd21"]
                   + rows["K1 bottleneck"]),
        "K2": dict(summary(rows["K2"]), err=errs["K2"],
                   shapes=rows["K2"] + rows["K2 cross"] + rows["K2 chunked"]
                   + rows["K2 sd21"] + rows["K2 ip"] + rows["K2 ip tower"]
                   + rows["K2 ip resampler"] + rows["K2 bottleneck"]),
        "K3": k3_checks(dev, g, timer, sdpa),
    }
    ctx["kernels"].update(conv_checks(dev, g, timer))


def k3_checks(dev, g, timer, sdpa):
    """K2 at the shapes where the JAX package leaves its single-pass kernel
    for the streaming K3, against the plain version run on 1024 query rows
    at a time (the whole fp32 logits would be 17 GB at L = 32640), with
    and without pv_bf16 and exp2. Tolerances as for K2."""
    from diffusionspatialcontrol_tpu_torch.ops.kernels import flash_attention as k2

    def plain(q, k, v, **opts):
        return torch.cat([k2.flash_attention_plain(q[:, i:i + 1024], k, v,
                                                   **opts)
                          for i in range(0, q.shape[1], 1024)], dim=1)

    rows, errs = [], [0.0, 0.0]
    for l, d in K3_SHAPES:
        tag = f"K3 L=S={l} D={d}"
        q, k, v = _qkv(g, BATCH, l, l, HEADS, d, torch.float32, dev)
        errs[0] = max(errs[0], check_close(
            f"{tag} fp32", k2.flash_attention_nlhd(q, k, v), plain(q, k, v),
            2e-4, 2e-5))
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        del q, k, v
        for opts in ({}, {"pv_bf16": True, "use_exp2": True}):
            out = k2.flash_attention_nlhd(qb, kb, vb, **opts)
            want = plain(*(t.float() for t in (qb, kb, vb)), **opts)
            errs[1] = max(errs[1], check_close(
                f"{tag} bf16" + (" +pvbf16+exp2" if opts else ""), out, want,
                1e-2, 0.05 * rms(want)))
            del out, want
        ms = timer(lambda: k2.flash_attention_nlhd(qb, kb, vb), reps=3)
        plain_ms = timer(lambda: plain(qb, kb, vb), reps=1, warmup=1)
        lib_ms = timer(lambda: sdpa(qb, kb, vb), reps=3)
        b_ms, t_bytes, t_ops = bound(BATCH, HEADS, l, l, d, torch.bfloat16,
                                     False)
        rows.append({"L": l, "S": l, "D": d, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": b_ms,
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"})
        log(f"kernels: {tag}: fp32 err {errs[0]:.2e}, bf16 err {errs[1]:.2e}"
            f"; bf16 {ms:.3f} ms, plain {plain_ms:.3f} ms, sdpa {lib_ms:.3f} "
            f"ms, bound {b_ms:.4f} ms ({rows[-1]['bound_by']}), exps "
            f"{exp_ms(BATCH, HEADS, l, l):.4f} ms")
        log_option_times(tag, timer, qb, kb, vb, reps=3)
        del qb, kb, vb
    first = rows[0]  # the hires path's shape: the row's numbers
    return dict(first, err=errs, shapes=rows)


def conv_bound(b, h, w, c_in, c_out, temb, skip):
    """(ms, bytes ms, operations ms) of one fused conv in bf16: x, the
    weights, the skip and the output moved once (and the fp32 per-channel
    vectors), against 2 * pixels * 9 * C_in * C_out operations."""
    px = b * h * w
    nbytes = 2 * (px * c_in + 9 * c_in * c_out + px * c_out * (1 + skip))
    nbytes += 4 * (2 * b * c_in + c_out + (b * c_out if temb else 0))
    t_bytes = nbytes / PEAK_BYTES
    t_ops = 2 * px * 9 * c_in * c_out / PEAK_OPS[torch.bfloat16]
    return 1e3 * max(t_bytes, t_ops), 1e3 * t_bytes, 1e3 * t_ops


def conv_checks(dev, g, timer):
    """K4 and K5 through their wrappers against ``gn_silu_conv3x3_plain`` at
    every distinct resnet-conv shape of SD1.5's UNet (CFG pair) and VAE
    decoder at 512^2 and 1024^2 and of its VAE encoder at 512^2 (img2img
    and inpaint), with the GroupNorm folded from random statistics as the
    resnets fold it.

    Tolerances: fp32 5e-5 absolute (tests/test_conv_fused.py; sums of up to
    9 * 2560 terms in another order). bf16: rtol 1e-2 and atol 5% of the
    reference's RMS, as for K1/K2, and ||out - plain|| / ||plain|| <= 4e-3:
    both sides round the same activations to bf16 (the bf16 bodies' fast
    SiLU can move one by a bf16 step near a rounding boundary) and sum exact
    products in fp32, so they differ by the order of the sum and the final
    rounding (at most 2^-8 relative, about 1e-3 RMS); a dropped chunk or tap
    gives tens of percent. Where the plan splits the C_in chunks, a second
    launch must be bitwise equal to the first (the partials are summed in
    split order). The yardstick (``library_ms``) is cuDNN's bf16 conv with
    bias on the pre-activated input, without the GroupNorm, SiLU, channel
    bias and skip; ``unfused_ms`` is the port's ``"xla"`` resnet conv
    (models/layers.py: fp32 GroupNorm, SiLU, cuDNN conv, the channel bias
    and the skip added in bf16), which computes the same conv with other
    roundings."""
    import torch.nn.functional as F

    from diffusionspatialcontrol_tpu_torch.models import layers
    from diffusionspatialcontrol_tpu_torch.ops.kernels import conv_fused as kc

    from diffusionspatialcontrol_tpu_torch import sd15_config

    cfg = sd15_config()
    per_call = {}  # shape -> launches in one 512^2 UNet call / one decode
    shapes = []  # / one encode
    for size in (512, HIRES):
        for sh in resnet_conv_shapes(cfg, size, size, encoder=size == 512):
            if size == 512:
                per_call[sh] = per_call.get(sh, 0) + 1
            if sh not in shapes:
                shapes.append(sh)
    kernels = {"K4": kc.gn_silu_conv3x3, "K5": kc.gn_silu_conv3x3_v2}
    rows = {name: [] for name in kernels}
    errs = {name: [0.0, 0.0] for name in kernels}
    repeats = 0
    for sh in shapes:
        where, b, h, w, c_in, c_out, temb, skip = sh
        tag = f"{where} {b}x{h}x{w} {c_in}->{c_out}" + (
            " +temb" if temb else "") + (" +skip" if skip else "")
        x = torch.randn(b, h, w, c_in, generator=g, device=dev)
        gn = {"scale": 1 + 0.1 * torch.randn(c_in, generator=g, device=dev),
              "bias": 0.1 * torch.randn(c_in, generator=g, device=dev)}
        scale, bias = kc.fold_group_norm(gn, x, 32)
        kern = (torch.rand(c_out, c_in, 3, 3, generator=g, device=dev) * 2
                - 1) / (9 * c_in) ** 0.5
        kern = kern.contiguous(memory_format=torch.channels_last)
        cb = 0.1 * torch.randn(c_out, generator=g, device=dev)
        xb = (torch.randn(b, c_out, generator=g, device=dev) if temb
              else None)
        sk = (torch.randn(b, h, w, c_out, generator=g, device=dev) if skip
              else None)
        want32 = kc.gn_silu_conv3x3_plain(x, scale, bias, kern, cb, xb, sk)
        xb16, kb16 = x.to(torch.bfloat16), kern.to(torch.bfloat16)
        sk16 = None if sk is None else sk.to(torch.bfloat16)
        want16 = kc.gn_silu_conv3x3_plain(xb16, scale, bias, kb16, cb, xb,
                                          sk16)
        act16 = F.silu(xb16.float() * scale[:, None, None]
                       + bias[:, None, None]).to(torch.bfloat16)
        act16 = act16.permute(0, 3, 1, 2)
        cb16 = cb.to(torch.bfloat16)
        lib_ms = timer(lambda: F.conv2d(act16, kb16, cb16, padding=1))
        plain_ms = timer(lambda: kc.gn_silu_conv3x3_plain(
            xb16, scale, bias, kb16, cb, xb, sk16), reps=3)
        conv_p = {"kernel": kb16, "bias": cb16}
        xb_16 = None if xb is None else xb.to(torch.bfloat16)

        def unfused():
            h = layers.conv2d(conv_p, layers.silu(layers.group_norm(
                gn, xb16, 32)))
            if xb_16 is not None:
                h = h + xb_16[:, None, None, :]
            return h if sk16 is None else sk16 + h

        unfused_ms = timer(unfused)
        b_ms, bytes_ms, ops_ms = conv_bound(b, h, w, c_in, c_out, temb, skip)
        line = []
        for name, fn in kernels.items():
            e32 = check_close(f"{name} {tag} fp32",
                              fn(x, scale, bias, kern, cb, xb, sk), want32,
                              0.0, 5e-5)
            out = fn(xb16, scale, bias, kb16, cb, xb, sk16)
            if out.dtype != torch.bfloat16:
                raise AssertionError(f"{name} {tag}: bf16 gave {out.dtype}")
            e16 = check_close(f"{name} {tag} bf16", out, want16, 1e-2,
                              0.05 * rms(want16))
            rel = float((out.float() - want16.float()).norm()
                        / want16.float().norm())
            if not rel <= 4e-3:
                raise AssertionError(f"{name} {tag} bf16: RMS-relative error "
                                     f"{rel:.3e} exceeds 4e-3")
            plan = kc.conv_plan(name, b, h, w, c_in, c_out)
            if plan.splits > 1:
                if not torch.equal(out, fn(xb16, scale, bias, kb16, cb, xb,
                                           sk16)):
                    raise AssertionError(f"{name} {tag} bf16: two launches "
                                         f"with {plan.splits} splits differ")
                repeats += 1
            ms = timer(lambda: fn(xb16, scale, bias, kb16, cb, xb, sk16))
            errs[name] = [max(errs[name][0], e32), max(errs[name][1], e16)]
            rows[name].append({
                "where": where, "B": b, "H": h, "W": w, "C_in": c_in,
                "C_out": c_out, "temb": temb, "skip": skip,
                "per_call_512": per_call.get(sh, 0),
                "jax_body": "K4b" if jax_sends_to_k4b(h, w) else "K4a",
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "unfused_ms": unfused_ms, "bound_ms": b_ms,
                "bytes_ms": bytes_ms,
                "operations_ms": ops_ms,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "max_abs_err_fp32": e32, "max_abs_err_bf16": e16})
            line.append(f"{name} {ms:.4f} ms (errs {e32:.1e}, {e16:.1e}, "
                        f"rms-rel {rel:.1e}, {plan.splits} splits)")
        torch.cuda.synchronize()
        log(f"kernels: conv {tag}: " + ", ".join(line) + f"; plain "
            f"{plain_ms:.4f} ms, cudnn {lib_ms:.4f} ms, unfused "
            f"{unfused_ms:.4f} ms, bound {b_ms:.4f} ms")
        del x, kern, xb, sk, want32, want16, xb16, kb16, sk16, act16, xb_16
    log(f"kernels: conv: {repeats} split-K launches repeated bitwise")

    # Sums over the launches of one UNet call and one decode at each size,
    # split by the Pallas body the JAX package would run there (K4a/K4b).
    for size in (512, HIRES):
        groups = {}
        for sh in resnet_conv_shapes(cfg, size, size, encoder=size == 512):
            key = (sh[0], "K4b" if jax_sends_to_k4b(sh[2], sh[3]) else "K4a")
            groups.setdefault(key, []).append(shapes.index(sh))
        for (where, body), idx in groups.items():
            tot = {f: [sum(rows[n][i][f] for i in idx) for n in kernels]
                   for f in ("ms", "plain_ms", "library_ms", "unfused_ms",
                             "bound_ms")}
            log(f"kernels: conv sums, {where} at {size}^2, {len(idx)} "
                f"launches at {body} shapes: K4 {tot['ms'][0]:.4f} ms, K5 "
                f"{tot['ms'][1]:.4f} ms, plain {tot['plain_ms'][0]:.4f} ms, "
                f"cudnn {tot['library_ms'][0]:.4f} ms, unfused "
                f"{tot['unfused_ms'][0]:.4f} ms, bound "
                f"{tot['bound_ms'][0]:.4f} ms")

    # Sums by map size over the launches of one 512^2 UNet call and one
    # 512^2 decode (PERF.md's per-map table).
    by_map = {}
    for sh in resnet_conv_shapes(cfg, 512, 512, encoder=True):
        by_map.setdefault((sh[0], sh[2], sh[3]), []).append(shapes.index(sh))
    for (where, h, w), idx in by_map.items():
        tot = {f: [sum(rows[n][i][f] for i in idx) for n in kernels]
               for f in ("ms", "library_ms", "unfused_ms", "bound_ms")}
        log(f"kernels: conv sums, {where} {h}x{w} at 512^2, {len(idx)} "
            f"launches: K4 {tot['ms'][0]:.4f} ms, K5 {tot['ms'][1]:.4f} ms, "
            f"cudnn {tot['library_ms'][0]:.4f} ms, unfused "
            f"{tot['unfused_ms'][0]:.4f} ms, bound "
            f"{tot['bound_ms'][0]:.4f} ms")

    def summary(name):
        """Sums over the 44 launches of one 512^2 UNet call."""
        tot = {key: sum(r[key] * r["per_call_512"] for r in rows[name]
                        if r["where"] == "unet")
               for key in ("ms", "plain_ms", "library_ms", "unfused_ms",
                           "bound_ms", "bytes_ms", "operations_ms")}
        tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["operations_ms"]
                           else "operations")
        log(f"kernels: {name}, the 44 launches of one 512^2 UNet call: "
            f"{tot['ms']:.4f} ms = {tot['ms'] / tot['library_ms']:.2f}x "
            f"cudnn ({tot['library_ms']:.4f} ms), unfused "
            f"{tot['unfused_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms")
        return dict(tot, err=errs[name], shapes=rows[name])

    return {name: summary(name) for name in kernels}


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return None if tree is None else tree.to(device)


def unit_controlnet(unet_cfg, seed: int, device, dtype, rms: float):
    """A ControlNet from the port's init (generator ``seed`` on ``device``)
    with its zero heads (the cond embedding's conv_out, the zero convs, the
    mid zero conv) drawn at ``rms``: a fresh ControlNet's residuals are
    exactly zero, so only random heads show its effect."""
    from diffusionspatialcontrol_tpu_torch.models.controlnet import (
        controlnet_init,
    )

    g = torch.Generator(device=device).manual_seed(seed)
    p = controlnet_init(g, unet_cfg, dtype=dtype, device=device)
    heads = ([p["cond_embedding"]["conv_out"]] + p["zero_convs"]
             + [p["mid_zero_conv"]])
    for conv in heads:
        for k in ("kernel", "bias"):
            t = torch.randn(conv[k].shape, generator=g, device=device)
            conv[k] = (rms * t).to(dtype).contiguous(
                memory_format=torch.channels_last if t.dim() == 4
                else torch.contiguous_format)
    return p


def cn_attentions(cfg) -> tuple:
    """(attentions of one ControlNet call, of them at level 0): two a
    transformer (self and cross) in its down blocks and its mid block."""
    u = cfg.unet
    per_level = u.layers_per_block * u.transformer_layers_per_block
    n = per_level * sum(u.attn_levels) + u.transformer_layers_per_block
    return 2 * n, per_level if u.attn_levels[0] else 0


def _with_text_bias(params, seed: int):
    """The random init with a random final LayerNorm bias in CLIP. The
    init's zero bias leaves every text embedding row with a mean of 0 up to
    rounding, and the "a1111" and "long" modes divide by such means (their
    weighting restores the embedding's mean); trained weights have a
    nonzero bias."""
    norm = params["clip"]["final_layer_norm"]
    g = torch.Generator().manual_seed(seed)
    bias = 0.5 * torch.randn(norm["bias"].shape, generator=g)
    norm["bias"] = bias.to(norm["bias"].dtype).to(norm["bias"].device)
    return params


class UNetCalls:
    """Counts the denoiser's calls (one UNet call each) while it is
    entered, by wrapping the pipeline's ``_make_denoiser``, the body of
    ``make_denoise_fn`` and of DeepCache's denoiser."""

    _MAKERS = ("_make_denoiser",)

    def __enter__(self):
        from diffusionspatialcontrol_tpu_torch.pipeline import pipeline

        self.n, self._mod = 0, pipeline
        self._orig = {name: getattr(pipeline, name) for name in self._MAKERS}
        for name, make in self._orig.items():
            setattr(pipeline, name, self._wrap(make))
        return self

    def _wrap(self, make):
        def counted_make(*args, **kwargs):
            denoise = make(*args, **kwargs)

            def counted(*a):
                self.n += 1
                return self._call(denoise, *a)
            return counted
        return counted_make

    @staticmethod
    def _call(denoise, *args):
        return denoise(*args)

    def __exit__(self, *exc):
        for name, make in self._orig.items():
            setattr(self._mod, name, make)


class NoHostReads(UNetCalls):
    """``UNetCalls`` that also runs every denoiser call under
    ``torch.cuda.set_sync_debug_mode("error")``: a host read of a device
    value inside the denoiser (an ``.item()``, a 0-d tensor index, a copy
    to the host) raises instead of stalling the host until the card
    catches up."""

    @staticmethod
    def _call(denoise, *args):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return denoise(*args)
        finally:
            torch.cuda.set_sync_debug_mode(mode)


def _masks(h, w):
    m1 = np.zeros((h, w), np.float32)
    m1[:, : w // 2] = 1.0
    m2 = np.zeros((h, w), np.float32)
    m2[: h // 3, w // 2:] = 1.0
    return {"red cat": {"mask": m1, "weight": 0.8, "mask_outsides": 0.2},
            "blue bird": {"mask": m2, "weight": 0.7, "mask_outsides": 0.1}}


def _wrappers():
    from diffusionspatialcontrol_tpu_torch.ops.kernels import conv_fused as kc
    from diffusionspatialcontrol_tpu_torch.ops.kernels import flash_attention as k2
    from diffusionspatialcontrol_tpu_torch.ops.kernels import region_attention as k1

    return {"K1": k1.region_softmax_attention, "K2": k2.flash_attention_nlhd,
            "K4": kc.gn_silu_conv3x3, "K5": kc.gn_silu_conv3x3_v2}


def _counts():
    """Launches so far of K1, K2, K4 and K5; "K3": K2's launches at the
    shape where the JAX package streams (L = S = 16384, D = 40); "K4b": K4's
    launches at the shapes the JAX package sends to its row-tiled body;
    "K1 S=154" and "K2 S=154": launches on a context of two prompt chunks."""
    w = _wrappers()
    c = {name: fn.launches for name, fn in w.items()}
    c["K3"] = w["K2"].shapes[(K3_SHAPES[0][0], K3_SHAPES[0][0],
                              K3_SHAPES[0][1])]
    c["K4b"] = sum(n for (_, h, ww, _, _), n in w["K4"].shapes.items()
                   if jax_sends_to_k4b(h, ww))
    for name in ("K1", "K2"):
        c[f"{name} S={CHUNKED}"] = sum(
            n for (_, s, _), n in w[name].shapes.items() if s == CHUNKED)
    return c


def _reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0
        fn.shapes.clear()


def want_launches(cfg, size, calls, spatial, conv_impl, hires_calls=0,
                  text_s=TEXT, encodes=0, controlnets=0, ip_adapters=0,
                  ip_once=0):
    """The exact launches of one request: ``encodes`` VAE encodes of a
    ``size`` image, ``calls`` UNet calls at ``size``, then ``hires_calls``
    at twice the size, one decode at the last size, on a context of
    ``text_s`` positions; each UNet call with ``controlnets`` ControlNet
    calls, all of whose attentions (self and cross, no map) are K2's, and
    one decoupled attention (K2) a cross-attention for each of
    ``ip_adapters`` IP-Adapters; ``ip_once``: the K2 launches of the
    image tower and the Resampler, once a request (``ip_tower_launches``)."""
    runs = [(size, calls)] + ([(2 * size, hires_calls)] if hires_calls
                              else [])
    n = calls + hires_calls
    level0 = (2 * size // 8) ** 2
    cn_attn, cn_level0 = cn_attentions(cfg)
    want = {"K1": PER_UNET * n if spatial else 0,
            "K2": PER_UNET * n * (1 if spatial else 2)
            + cn_attn * controlnets * n + PER_UNET * ip_adapters * n
            + ip_once,
            "K3": (LEVELS[0][2] + cn_level0 * controlnets) * hires_calls
            if level0 == K3_SHAPES[0][0] else 0,
            "K4": 0, "K5": 0, "K4b": 0,
            f"K1 S={CHUNKED}": 0, f"K2 S={CHUNKED}": 0}
    if text_s == CHUNKED:
        want[f"K{1 if spatial else 2} S={CHUNKED}"] = PER_UNET * n
        want[f"K2 S={CHUNKED}"] += cn_attn // 2 * controlnets * n
    if conv_impl in ("pallas", "pallas2"):
        fused = [sh for sz, k in runs
                 for sh in resnet_conv_shapes(cfg, sz, sz) * k
                 if sh[0] == "unet"]
        last = runs[-1][0]
        fused += [sh for sh in resnet_conv_shapes(cfg, last, last)
                  if sh[0] == "vae"]
        fused += [sh for sh in resnet_conv_shapes(cfg, size, size,
                                                  encoder=True) * encodes
                  if sh[0] == "vae_enc"]
        want["K4" if conv_impl == "pallas" else "K5"] = len(fused)
        if conv_impl == "pallas":
            want["K4b"] = sum(jax_sends_to_k4b(sh[2], sh[3]) for sh in fused)
    return want


def ip_tower_launches(variant, tower_layers, resampler_layers=2,
                      cfg_pair=True):
    """K2 launches of one IP unit's embeds from an image, once a request:
    the tower's layers for the projected embeds (base, Light, Face), twice
    all but the last for the Resampler's penultimate hidden states (the
    image and the zero-pixel uncond, as the app always takes both), then
    the Resampler's layers on the image's and, with CFG, the uncond's;
    none for FaceID (convolutions only)."""
    if variant == "faceid":
        return 0
    if variant != "resampler":
        return tower_layers
    return 2 * (tower_layers - 1) + (2 if cfg_pair else 1) * resampler_layers


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def synthetic_image(side: int, seed: int) -> np.ndarray:
    """A deterministic (1, side, side, 3) fp32 image in [-1, 1] made with
    numpy from ``seed``: smooth colour waves under a few flat discs."""
    rng = np.random.default_rng(seed)
    y, x = (np.mgrid[0:side, 0:side] + 0.5) / side
    img = np.stack([0.6 * np.sin(2 * np.pi * (rng.uniform(0.5, 2.0) * x
                                              + rng.uniform(0.5, 2.0) * y
                                              + rng.uniform()))
                    for _ in range(3)], axis=-1)
    for _ in range(4):
        cx, cy = rng.uniform(0.2, 0.8, 2)
        img[(x - cx) ** 2 + (y - cy) ** 2 < rng.uniform(0.05, 0.2) ** 2] = \
            rng.uniform(-1.0, 1.0, 3)
    return img[None].astype(np.float32)


def right_half_mask(side: int, extra: bool = False) -> np.ndarray:
    """(1, side, side) fp32, 1 (regenerate) on the right half; ``extra``
    adds a rectangle that does not sit on the 8-pixel latent grid."""
    m = np.zeros((1, side, side), np.float32)
    m[:, :, side // 2:] = 1.0
    if extra:
        m[:, side // 12: side // 4 + 1, side // 20: side // 5 + 1] = 1.0
    return m


def u8_reference(x: np.ndarray) -> np.ndarray:
    """The JAX package's uint8 conversion (``runtime/native.py``'s fallback,
    the native codec's formula): clamp(x 0.5 + 0.5, 0, 1) 255 + 0.5 in
    fp32, truncated; tests/test_torch_inpaint.py holds the port's
    ``to_uint8`` to the codec itself on the CPU."""
    f = np.float32
    v = np.clip(np.asarray(x, f) * f(0.5) + f(0.5), f(0), f(1)) * f(255)
    return (v + f(0.5)).astype(np.uint8)


def u8_boundary_inputs() -> np.ndarray:
    """The two inputs that showed ties rounding the other way, then every
    fp32 value within 64 ulp of the 255 boundaries between the buckets."""
    b = (((np.arange(255) + 0.5) / 255.0) * 2.0 - 1.0).astype(np.float32)
    up, down, cols = b, b, [b]
    for _ in range(64):
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(-np.inf))
        cols += [up, down]
    return np.concatenate([np.float32([-0.49411765, -0.99607843])] + cols)


def _gen_for(name, **kw):
    """A GenerationConfig for a name of the app's sampler table."""
    from diffusionspatialcontrol_tpu_torch import GenerationConfig
    from diffusionspatialcontrol_tpu_torch.registry import SAMPLERS

    spec = SAMPLERS[name]
    return GenerationConfig(sampler=spec.solver, schedule=spec.schedule,
                            **kw)


def _tiny_cases():
    """(label, conv_impl, spatial, hires, sampler name, prompt mode,
    chunked): the requests of the tiny phase."""
    base = [("spatial", "xla", True, None, "DPM++ 2M Karras", "short", False),
            ("vanilla", "xla", False, None, "DPM++ 2M Karras", "short",
             False),
            ("spatial pallas", "pallas", True, None, "DPM++ 2M Karras",
             "short", False),
            ("spatial pallas2", "pallas2", True, None, "DPM++ 2M Karras",
             "short", False),
            ("spatial xla_bf16", "xla_bf16", True, None, "DPM++ 2M Karras",
             "short", False),
            ("hires", "xla", True, {}, "DPM++ 2M Karras", "short", False),
            ("hires, Euler a Exponential pass", "xla", True,
             {"sampler": "euler_ancestral", "schedule": "exponential"},
             "DPM++ 2M Karras", "short", False),
            ("a1111, 2 chunks", "xla", True, None, "DPM++ 2M SDE Karras",
             "a1111", False),
            ("long, 2 chunks", "xla", False, None, "Heun", "long", False),
            ("chunked, paused and resumed", "xla", True, None,
             "DPM++ 2M SDE Karras", "short", True)]
    # every solver of the table, the four schedules in turn (the two
    # img-to-img solvers exist on the default schedule only)
    from diffusionspatialcontrol_tpu_torch.registry import SAMPLERS

    suffixes = ("", " Karras", " Exponential", " Polyexponential")
    first = {}  # solver -> its name on the default schedule
    for name, spec in SAMPLERS.items():
        first.setdefault(spec.solver, name)
    for i, plain in enumerate(first.values()):
        name = plain + suffixes[i % 4]
        name = name if name in SAMPLERS else plain
        base.append((f"sampler {name}", "xla", True, None, name, "short",
                     False))
    return base


def phase_tiny(ctx):
    """Tiny config, fp32, the same weights and latents on the card (kernels)
    and on the CPU (their plain versions): spatial and vanilla requests with
    plain convs, spatial ones with the fused resnet convs (K4, K5), hires
    requests (64^2 -> 128^2, 4 + 2 steps, the map re-encoded; one with
    Euler a on exponential sigmas for the hires pass), every solver of the
    app's table, two-chunk prompts in the "a1111" mode (with the map) and
    the "long" mode (its ids, 75 n + 2, do not match its 77 n context, so
    it takes no map: both devices must refuse one, as the JAX package
    fails on one), and a chunked run (2 steps a chunk) paused after its
    first chunk and resumed, which must equal the plain run bit for bit on
    the card. Launches: 16 of K1 and K2 per UNet call (CFG pair), the calls
    counted at the denoiser, and the same calls on both devices.
    Tolerance: 2e-4 on fp32 pixels in [-1, 1] and +-1 on uint8. Both sides
    compute in fp32 (TF32 is off), but cuDNN and ATen's CPU convolutions,
    the kernels' online softmax and the conv kernels sum in other orders,
    through 4 steps of ~40 layers: an H100 run differed by 5e-6, and the
    port and the JAX package agree to 1e-4 on the CPU
    (tests/test_torch_pipeline.py)."""
    from diffusionspatialcontrol_tpu_torch import tiny_config
    from diffusionspatialcontrol_tpu_torch.models.factory import (
        init_pipeline_params,
    )
    from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
        ChunkedPause,
        StableDiffusionTorch,
    )
    from diffusionspatialcontrol_tpu_torch.text.tokenizer import HashTokenizer

    cfg = tiny_config()
    cpu = torch.device("cpu")
    params = _with_text_bias(init_pipeline_params(0, cfg, torch.float32,
                                                  device=cpu), 0)
    on = {cpu.type: params, "cuda": _tree_to(params, ctx["device"])}
    lat = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 8, 8, 4)).astype(np.float32))
    for label, conv_impl, spatial, hires, sampler, mode, chunked in \
            _tiny_cases():
        gen = _gen_for(sampler, height=64, width=64, num_inference_steps=4,
                       dtype=torch.float32)
        prompt = PROMPT if mode == "short" else LONG_PROMPT
        out, calls = {}, {}
        for kind in ("cpu", "cuda"):
            pipe = StableDiffusionTorch(cfg, on[kind],
                                        tokenizer=HashTokenizer(),
                                        conv_impl=conv_impl, device=kind)
            c, ids = pipe.encode_prompt([prompt], [NEG], mode=mode)
            rb = (pipe.encode_region([_masks(64, 64)], ids, 64, 64)
                  if spatial else None)
            if mode == "long":
                try:
                    pipe.txt2img(c, gen, latents=lat, region_biases=pipe.
                                 encode_region([_masks(64, 64)], ids, 64,
                                               64))
                except ValueError:
                    pass
                else:
                    raise AssertionError(f"tiny {label} on {kind}: a map "
                                         f"from long-mode ids was taken")
            opts = None
            if hires is not None:
                opts = dict(hires, scale=2.0, strength=0.6,
                            region_state=([_masks(64, 64)], ids, 1))
            before = _counts()
            with UNetCalls() as n:
                img = pipe.txt2img(c, gen, latents=lat, region_biases=rb,
                                   hires=opts)
                if chunked:
                    pause = pipe.sample_chunked(
                        c, gen, latents=lat, region_biases=rb,
                        chunk_steps=2, on_chunk=lambda done, total: False)
                    if not isinstance(pause, ChunkedPause):
                        raise AssertionError(f"tiny {label}: no pause")
                    resumed = pipe.sample_chunked(
                        c, gen, latents=lat, region_biases=rb,
                        chunk_steps=2, resume=pause)
                    if not torch.equal(resumed, img):
                        raise AssertionError(
                            f"tiny {label} on {kind}: the paused and resumed"
                            f" run differs from the plain run by "
                            f"{float((resumed - img).abs().max()):.3e}")
            got = _delta(_counts(), before)
            calls[kind] = n.n
            want = (want_launches(cfg, 64, n.n, spatial, conv_impl,
                                  text_s=c.shape[1]) if kind == "cuda"
                    else dict.fromkeys(got, 0))
            if got != want:
                raise AssertionError(f"tiny {label} on {kind}: launches "
                                     f"{got}, expected {want}")
            out[kind] = img.cpu()
        if calls["cpu"] != calls["cuda"]:
            log(f"tiny: {label}: {calls['cuda']} UNet calls on the card, "
                f"{calls['cpu']} on the CPU")
        side = 128 if hires is not None else 64
        if out["cuda"].shape != (1, side, side, 3):
            raise AssertionError(f"tiny {label}: image {out['cuda'].shape}")
        err = check_close(f"tiny {label}", out["cuda"], out["cpu"], 0.0, 2e-4)
        u8 = [StableDiffusionTorch.to_uint8(out[k]).int()
              for k in ("cuda", "cpu")]
        u8_err = int((u8[0] - u8[1]).abs().max())
        if u8_err > 1:
            raise AssertionError(f"tiny {label}: uint8 differs by {u8_err}")
        log(f"tiny: {label} ({gen.sampler}, {gen.schedule}, {mode}, S = "
            f"{c.shape[1]}): card vs CPU max abs err {err:.2e} (fp32), "
            f"{u8_err} (uint8); {calls['cuda']} UNet calls, launches "
            f"{ {k: v for k, v in want.items() if v} }")
    tiny_images_in(ctx, cfg, on)
    tiny_units(ctx, cfg, on)
    tiny_ip(ctx, cfg, on)
    tiny_modes(ctx, cfg, on)


def tiny_modes(ctx, cfg, on):
    """The speed modes and the DAAM taps at tiny size, fp32, card against
    CPU with the same weights and seeds (every draw is made on the CPU),
    DPM++ 2M Karras, 4 steps, the two-phrase map: TGATE (gate 2: 2 CFG
    steps, the collect forward, 2 cond-only steps), DeepCache at interval 3
    (steps 0 and 3 in full; a reuse call runs the 5 level-0 transformers),
    cfg-tail 0.5 (2 steps with CFG, 2 without), bottleneck sampling at
    128^2 (latent 16, the middle at 8: 1 + 1 + 2 + 1 + 1 UNet calls, the
    map re-encoded at each size); then ``heatmaps_for_state`` on one state
    and ``unet_apply`` with FreeU (cuFFT on the card). Tolerances as the
    phase's: 2e-4 on fp32 pixels (and on the heatmaps, whose rows sum to
    32), +-1 on uint8; exact launches."""
    from diffusionspatialcontrol_tpu_torch.introspect.daam import (
        heatmaps_for_state,
    )
    from diffusionspatialcontrol_tpu_torch.models.unet import (
        FreeUParams,
        UNetCond,
        unet_apply,
    )
    from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
        StableDiffusionTorch,
    )
    from diffusionspatialcontrol_tpu_torch.text.tokenizer import HashTokenizer

    per_call = {"K1": 16, "K2": 16}
    reuse = 5  # level-0 transformers: 2 in down block 0, 3 in the last up
    cases = (  # (label, side, method, kwargs, K1, K2 launches)
        ("tgate 0.5", 64, "txt2img_tgate", {"gate_frac": 0.5},
         3 * 16, 5 * 16),
        ("deepcache 3", 64, "txt2img_deepcache", {"cache_interval": 3},
         2 * 16 + 2 * reuse, 2 * 16 + 2 * reuse),
        ("cfg-tail 0.5", 64, "txt2img_cfg_tail", {"tail_frac": 0.5},
         4 * 16, 4 * 16),
        ("bottleneck 0.5", 128, "txt2img_bottleneck", {"low_scale": 0.5},
         6 * 16, 6 * 16))
    for label, side, method, kw, k1, k2 in cases:
        gen = _gen_for("DPM++ 2M Karras", height=side, width=side,
                       num_inference_steps=4, dtype=torch.float32)
        out = {}
        for kind in ("cpu", "cuda"):
            pipe = StableDiffusionTorch(cfg, on[kind],
                                        tokenizer=HashTokenizer(), device=kind)
            c, ids = pipe.encode_prompt([PROMPT], [NEG])
            if method == "txt2img_bottleneck":
                kw = dict(kw, region_state=([_masks(side, side)], ids, 1))
            else:
                kw = dict(kw, region_biases=pipe.encode_region(
                    [_masks(side, side)], ids, side, side))
            before = _counts()
            img = getattr(pipe, method)(c, gen, seed=3, **kw)
            got = _delta(_counts(), before)
            want = dict.fromkeys(got, 0)
            if kind == "cuda":
                want.update(K1=k1, K2=k2)
            if got != want:
                raise AssertionError(f"tiny {label} on {kind}: launches "
                                     f"{got}, expected {want}")
            out[kind] = img.cpu()
        if out["cuda"].shape != (1, side, side, 3):
            raise AssertionError(f"tiny {label}: image {out['cuda'].shape}")
        err = check_close(f"tiny {label}", out["cuda"], out["cpu"], 0.0, 2e-4)
        u8 = [StableDiffusionTorch.to_uint8(out[k]).int()
              for k in ("cuda", "cpu")]
        u8_err = int((u8[0] - u8[1]).abs().max())
        if u8_err > 1:
            raise AssertionError(f"tiny {label}: uint8 differs by {u8_err}")
        log(f"tiny: {label}: card vs CPU max abs err {err:.2e} (fp32), "
            f"{u8_err} (uint8); launches K1 {k1}, K2 {k2}")

    rng = np.random.default_rng(8)
    x = torch.from_numpy((rng.standard_normal((1, 8, 8, 4)) * 3).astype(
        np.float32))
    maps, outs = {}, {}
    for kind in ("cpu", "cuda"):
        pipe = StableDiffusionTorch(cfg, on[kind], tokenizer=HashTokenizer(),
                                    device=kind)
        c, ids = pipe.encode_prompt([PROMPT], [NEG])
        rb = tuple(b[1:] for b in pipe.encode_region([_masks(64, 64)], ids,
                                                     64, 64))
        before = _counts()
        maps[kind] = heatmaps_for_state(on[kind], cfg, x.to(kind), 2.5,
                                        c[1:], rb).cpu()
        got = _delta(_counts(), before)
        if kind == "cuda" and (got["K1"], got["K2"]) != (16, 16):
            raise AssertionError(f"tiny heatmaps: launches {got}")
        t = torch.full((2,), 400.0, device=kind)
        outs[kind] = unet_apply(on[kind]["unet"], cfg.unet,
                                x.to(kind).repeat(2, 1, 1, 1), t,
                                UNetCond(context=c), freeu=FreeUParams()
                                ).cpu()
    if maps["cuda"].shape != (1, 8, 8, 77):
        raise AssertionError(f"tiny heatmaps: {tuple(maps['cuda'].shape)}")
    err = check_close("tiny heatmaps_for_state", maps["cuda"], maps["cpu"],
                      0.0, 2e-4)
    err_f = check_close("tiny unet_apply(freeu)", outs["cuda"], outs["cpu"],
                        0.0, 2e-4)
    log(f"tiny: heatmaps_for_state card vs CPU max abs err {err:.2e} (rows "
        f"sum to {float(maps['cuda'].sum(-1).mean()):.4f}); unet_apply with "
        f"FreeU {err_f:.2e}")


def _tiny_variants(cfg):
    """The tiny config's 9-channel inpaint UNet, that UNet with an
    asymmetric VAE (decoder 1.5x as wide, three resnets a block, as
    ``sd15_asym_inpaint_config(1.5)``), and an SD2.1-style model (gelu
    CLIP, linear projections, a constant head width, v-prediction)."""
    import dataclasses

    nine = dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, in_channels=9))
    v = nine.vae
    asym = dataclasses.replace(nine, vae=dataclasses.replace(
        v, asymmetric=True,
        decoder_block_out_channels=tuple(int(c * 1.5)
                                         for c in v.block_out_channels),
        decoder_layers_per_block=v.layers_per_block + 1))
    sd21 = dataclasses.replace(
        cfg, clip=dataclasses.replace(cfg.clip, hidden_act="gelu"),
        unet=dataclasses.replace(cfg.unet, num_attention_heads=(1, 2, 4, 4),
                                 use_linear_projection=True),
        prediction_type="v_prediction")
    return nine, asym, sd21


def tiny_images_in(ctx, cfg, on):
    """The images-in requests at tiny size, fp32, card against CPU with the
    same weights, image, mask and seeds (so the same draws: every sample's
    generator draws on the CPU): ``encode_image`` then ``img2img`` at
    strength 0.75, with plain convs and with K5 (its fp32 body) through the
    encoder's resnets; inpaint on the 4-channel UNet at strength 1.0 and
    0.75, on the 9-channel UNet and with the asymmetric VAE; the
    SD2.1-style model's txt2img with ``guidance_rescale`` 0.7; one under
    ``conv_impl="xla_bf16"``. All with the two-phrase map, 4 steps. The
    card's uint8 of each image must equal ``u8_reference`` of its fp32
    pixels bit for bit, as must the card's uint8 of the rounding boundary
    set. Tolerances as in ``phase_tiny``."""
    from diffusionspatialcontrol_tpu_torch import GenerationConfig
    from diffusionspatialcontrol_tpu_torch.models.factory import (
        init_pipeline_params,
    )
    from diffusionspatialcontrol_tpu_torch.models.vae import vae_init
    from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
        StableDiffusionTorch,
        to_uint8,
    )
    from diffusionspatialcontrol_tpu_torch.text.tokenizer import HashTokenizer

    dev = ctx["device"]
    x = u8_boundary_inputs()
    got = to_uint8(torch.from_numpy(x).to(dev)).cpu().numpy()
    if not np.array_equal(got, u8_reference(x)) or got[:2].tolist() != [65,
                                                                       1]:
        raise AssertionError("tiny: uint8 on the card differs from the "
                             "codec's rounding on the boundary set")
    log(f"tiny: uint8 on the card equals the codec's rounding on "
        f"{x.size} boundary inputs")

    nine, asym, sd21 = _tiny_variants(cfg)
    cpu = torch.device("cpu")
    p9 = init_pipeline_params(1, nine, torch.float32, device=cpu)
    pa = dict(p9, vae=vae_init(torch.Generator().manual_seed(2), asym.vae,
                               torch.float32, cpu))
    pv = init_pipeline_params(3, sd21, torch.float32, device=cpu)
    weights = {"four": (cfg, on)}
    for name, c_, p in (("nine", nine, p9), ("asym", asym, pa),
                        ("sd21", sd21, pv)):
        weights[name] = (c_, {"cpu": p, "cuda": _tree_to(p, dev)})
    img = torch.from_numpy(synthetic_image(64, 0))
    mask = torch.from_numpy(right_half_mask(64, extra=True))
    cases = (  # (label, weights, conv_impl, request, strength)
        ("img2img from pixels", "four", "xla", "img2img", 0.75),
        ("img2img from pixels, pallas2", "four", "pallas2", "img2img", 0.75),
        ("inpaint 4-channel", "four", "xla", "inpaint", 1.0),
        ("inpaint 4-channel", "four", "xla", "inpaint", 0.75),
        ("inpaint 4-channel, xla_bf16", "four", "xla_bf16", "inpaint", 0.75),
        ("inpaint 9-channel", "nine", "xla", "inpaint", 1.0),
        ("inpaint asymmetric VAE", "asym", "xla", "inpaint", 1.0),
        ("SD2.1-style v-prediction", "sd21", "xla", "txt2img", 1.0))
    for label, which, conv_impl, request, strength in cases:
        cfg_, params = weights[which]
        gen = GenerationConfig(height=64, width=64, num_inference_steps=4,
                               guidance_rescale=0.7 if which == "sd21"
                               else 0.0, dtype=torch.float32)
        out, calls = {}, {}
        for kind in ("cpu", "cuda"):
            pipe = StableDiffusionTorch(cfg_, params[kind],
                                        tokenizer=HashTokenizer(),
                                        conv_impl=conv_impl, device=kind)
            c, ids = pipe.encode_prompt([PROMPT], [NEG])
            rb = pipe.encode_region([_masks(64, 64)], ids, 64, 64)
            before = _counts()
            with UNetCalls() as n:
                if request == "img2img":
                    lat = pipe.encode_image(img, seed=3)
                    res = pipe.img2img(c, lat, gen, strength=strength,
                                       seed=3, region_biases=rb)
                elif request == "inpaint":
                    res = pipe.inpaint(c, img, mask, gen, strength=strength,
                                       seed=3, region_biases=rb)
                else:
                    res = pipe.txt2img(c, gen, seed=3, region_biases=rb)
            got = _delta(_counts(), before)
            calls[kind] = n.n
            want = (want_launches(cfg_, 64, n.n, True, conv_impl,
                                  encodes=int(request != "txt2img"))
                    if kind == "cuda" else dict.fromkeys(got, 0))
            if got != want:
                raise AssertionError(f"tiny {label} on {kind}: launches "
                                     f"{got}, expected {want}")
            out[kind] = res
        if calls["cpu"] != calls["cuda"] or calls["cuda"] != int(
                4 * strength):
            raise AssertionError(f"tiny {label}: UNet calls {calls}")
        if out["cuda"].shape != (1, 64, 64, 3):
            raise AssertionError(f"tiny {label}: image {out['cuda'].shape}")
        err = check_close(f"tiny {label}", out["cuda"].cpu(), out["cpu"],
                          0.0, 2e-4)
        u8 = to_uint8(out["cuda"]).cpu()
        if not np.array_equal(u8.numpy(), u8_reference(out["cuda"].cpu())):
            raise AssertionError(f"tiny {label}: the card's uint8 differs "
                                 f"from the codec's rounding")
        u8_err = int((u8.int() - to_uint8(out["cpu"]).int()).abs().max())
        if u8_err > 1:
            raise AssertionError(f"tiny {label}: uint8 differs by {u8_err}")
        log(f"tiny: {label} ({conv_impl}, strength {strength}): card vs CPU "
            f"max abs err {err:.2e} (fp32), {u8_err} (uint8); "
            f"{calls['cuda']} UNet calls, launches "
            f"{ {k: v for k, v in want.items() if v} }")


TINY_HEAD_RMS = 0.05  # tiny fp32 ControlNets' random heads (residuals ~1)
HEAD_RMS = 0.02  # SD1.5's: residuals that move the image, far from bf16's
# overflow (their RMS is printed)


def unit_extras(pipe, gen, spec, controlnets, adapter, image):
    """A request's unit extras from ``spec``: {"cn": the ControlNets used,
    "scales", "starts", "ends", "guess"; "t2i": the adapter's
    conditioning factor}, every unit on ``image`` (B, H, W, 3) in [0, 1]."""
    ex = None
    n = spec.get("cn", 0)
    if n:
        ex = pipe.build_controlnet_extras(
            gen, controlnets[:n], [image] * n,
            scales=spec.get("scales", [1.0, 0.7])[:n],
            starts=spec.get("starts"), ends=spec.get("ends"),
            guess_mode=spec.get("guess", False))
    if spec.get("t2i") is not None:
        ex = pipe.build_t2i_extras(gen, [adapter], [image], scales=[1.0],
                                   conditioning_factor=spec["t2i"], base=ex)
    return ex


def tiny_units(ctx, cfg, on):
    """ControlNet and T2I-Adapter units at tiny size, fp32, card against
    CPU with the same weights (ControlNets with random heads at
    ``TINY_HEAD_RMS``; a random adapter), control image, latents and seeds,
    all with the two-phrase map: one ControlNet; two ControlNets with keep
    windows [0, 0.5) and [0.25, 1] and a T2I-Adapter active on the first
    half of the steps; guess mode; Heun (its intermediate sigmas take the
    nearest step's scale) with a window; img2img at strength 0.75 with a
    ControlNet (the cut schedule reads the first columns of the per-step
    tables); hires 64^2 -> 128^2 with a ControlNet and the adapter rebuilt
    at 128^2 (``rebuild_extras``). Launches exact: K1 16 and K2 16 + 14 a
    ControlNet per UNet call. Each image must also differ from the same
    request without units on the card (the units are not idle).
    Tolerances as in ``phase_tiny``."""
    from diffusionspatialcontrol_tpu_torch import T2IAdapterConfig
    from diffusionspatialcontrol_tpu_torch.models.t2i_adapter import (
        t2i_adapter_init,
    )
    from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
        StableDiffusionTorch,
    )
    from diffusionspatialcontrol_tpu_torch.text.tokenizer import HashTokenizer

    cpu, dev = torch.device("cpu"), ctx["device"]
    cns = [unit_controlnet(cfg.unet, seed, cpu, torch.float32,
                           TINY_HEAD_RMS) for seed in (1, 2)]
    ad = t2i_adapter_init(torch.Generator().manual_seed(3), T2IAdapterConfig(
        channels=cfg.unet.block_out_channels), torch.float32, cpu)
    units = {"cpu": (cns, ad),
             "cuda": ([_tree_to(c, dev) for c in cns], _tree_to(ad, dev))}
    image = {side: torch.from_numpy(synthetic_image(side, 5) * 0.5 + 0.5)
             for side in (64, 128)}
    init = torch.from_numpy(synthetic_image(64, 0))
    lat = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 8, 8, 4)).astype(np.float32))
    cases = (  # (label, sampler name, request, unit spec)
        ("controlnet", "DPM++ 2M Karras", "txt2img", {"cn": 1}),
        ("two controlnets [0, 0.5) and [0.25, 1], T2I factor 0.5",
         "DPM++ 2M Karras", "txt2img",
         {"cn": 2, "starts": [0.0, 0.25], "ends": [0.5, 1.0], "t2i": 0.5}),
        ("controlnet guess mode", "DPM++ 2M Karras", "txt2img",
         {"cn": 1, "guess": True}),
        ("Heun, controlnet [0.25, 1]", "Heun", "txt2img",
         {"cn": 1, "starts": [0.25], "ends": [1.0]}),
        ("img2img 0.75, controlnet [0, 0.5)", "DPM++ 2M Karras", "img2img",
         {"cn": 1, "ends": [0.5]}),
        ("hires 64^2 -> 128^2, controlnet and T2I rebuilt",
         "DPM++ 2M Karras", "hires", {"cn": 1, "t2i": 1.0}))
    for label, sampler, request, spec in cases:
        gen = _gen_for(sampler, height=64, width=64, num_inference_steps=4,
                       dtype=torch.float32)
        out, calls, wants = {}, {}, {}
        for kind in ("cpu", "cuda", "cuda without units"):
            device = kind.split()[0]
            pipe = StableDiffusionTorch(cfg, on[device],
                                        tokenizer=HashTokenizer(),
                                        device=device)
            cn_k, ad_k = units[device]
            c, ids = pipe.encode_prompt([PROMPT], [NEG])
            rb = pipe.encode_region([_masks(64, 64)], ids, 64, 64)
            ex = (None if kind == "cuda without units" else unit_extras(
                pipe, gen, spec, cn_k, ad_k, image[64]))
            before = _counts()
            with UNetCalls() as n:
                if request == "img2img":
                    res = pipe.img2img(c, pipe.encode_image(init, seed=3),
                                       gen, strength=0.75, seed=3,
                                       region_biases=rb, extras=ex)
                else:
                    hires = None
                    if request == "hires":
                        hires = {"scale": 2.0, "strength": 0.6,
                                 "region_state": ([_masks(64, 64)], ids, 1)}
                        if ex is not None:
                            hires["rebuild_extras"] = (
                                lambda g, p=pipe, cn_k=cn_k, ad_k=ad_k:
                                unit_extras(p, g, spec, cn_k, ad_k,
                                            image[128]))
                    res = pipe.txt2img(c, gen, latents=lat, region_biases=rb,
                                       extras=ex, hires=hires)
            got = _delta(_counts(), before)
            calls[kind] = n.n
            want = (want_launches(cfg, 64, n.n, True, "xla",
                                  controlnets=0 if ex is None
                                  else spec.get("cn", 0))
                    if device == "cuda" else dict.fromkeys(got, 0))
            if got != want:
                raise AssertionError(f"tiny {label} on {kind}: launches "
                                     f"{got}, expected {want}")
            out[kind], wants[kind] = res.cpu(), want
        if len(set(calls.values())) != 1:
            raise AssertionError(f"tiny {label}: UNet calls {calls}")
        side = 128 if request == "hires" else 64
        if out["cuda"].shape != (1, side, side, 3):
            raise AssertionError(f"tiny {label}: image {out['cuda'].shape}")
        err = check_close(f"tiny {label}", out["cuda"], out["cpu"], 0.0, 2e-4)
        u8 = [StableDiffusionTorch.to_uint8(out[k]).int()
              for k in ("cuda", "cpu")]
        u8_err = int((u8[0] - u8[1]).abs().max())
        if u8_err > 1:
            raise AssertionError(f"tiny {label}: uint8 differs by {u8_err}")
        moved = float((out["cuda"] - out["cuda without units"]).abs().max())
        if moved < 1e-3:
            raise AssertionError(f"tiny {label}: the units moved the image "
                                 f"by {moved:.2e} only")
        log(f"tiny: {label} ({gen.sampler}, {request}): card vs CPU max abs "
            f"err {err:.2e} (fp32), {u8_err} (uint8); the units move the "
            f"image by {moved:.3f}; {calls['cuda']} UNet calls, launches "
            f"{ {k: v for k, v in wants['cuda'].items() if v} }")


# A tiny CLIP-vision tower (D = 16 a head, an instance of K2's)
TINY_VISION = dict(image_size=28, patch_size=14, hidden_size=32,
                   intermediate_size=64, num_layers=2, num_heads=2,
                   projection_dim=16)


def face_photo(side: int, seed: int) -> np.ndarray:
    """A raw (side, side, 3) uint8 photo made with numpy from ``seed``."""
    return np.round((synthetic_image(side, seed)[0] * 0.5 + 0.5) * 255.0
                    ).astype(np.uint8)


def ip_pipeline(manager, pipe_params, cfg, units, device, dtype):
    """The first half of what ``inference()`` does for ``units``
    (IP-Adapter units): each adapter's state by name, installed into a
    copy of the UNet tree's containers. Returns (a pipeline on the copy,
    the adapters' projections)."""
    from diffusionspatialcontrol_tpu_torch.models import ip_adapter as ipa
    from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
        StableDiffusionTorch,
    )
    from diffusionspatialcontrol_tpu_torch.text.tokenizer import (
        HashTokenizer,
        load_tokenizer,
    )

    states = [manager.get_ip_adapter_state(u.model, cfg.unet) for u in units]
    unet = ipa.copy_tree_containers(pipe_params["unet"])
    ads = ipa.load_ip_adapter(unet, cfg.unet, states, dtype, device)
    pipe = StableDiffusionTorch(
        cfg, {**pipe_params, "unet": unet}, device=device,
        tokenizer=HashTokenizer() if cfg.name == "tiny" else load_tokenizer())
    return pipe, ads


def ip_extras(manager, pipe, units, ads):
    """The second half, once a request: the embeds by the app's own
    ``_ip_unit_embeds`` (the manager's image tower, face detector and
    embedder) and ``build_ip_extras`` with CFG (batch 1)."""
    from diffusionspatialcontrol_tpu_torch.app import api

    embeds = [api._ip_unit_embeds(manager, u, ad)
              for u, ad in zip(units, ads)]
    masks = [None if u.mask is None else
             torch.from_numpy(np.asarray(u.mask, np.float32)[None])
             for u in units]
    return pipe.build_ip_extras(
        ads, [e for e, _ in embeds], scales=[u.scale for u in units],
        masks=masks if any(m is not None for m in masks) else None,
        uncond_image_embeds=[u for _, u in embeds])


def tiny_ip(ctx, cfg, on):
    """IP-Adapter units at tiny size, fp32, card against CPU with the same
    weights (the adapters by name from ``random_state_dict``, a tiny image
    tower, the tiny SCRFD detector with its top-1 fallback and a 512-wide
    tiny ArcFace, copied from the CPU), photo, latents and seeds, all with
    the two-phrase map: for each of the six names of the app's table two
    units at once (that name's adapter on the right-half mask at 0.8, the
    base adapter at 0.5), embedded as the app embeds them; then hires
    64^2 -> 128^2 with the Plus adapter masked and the base adapter (the
    tokens and masks reused at 128^2). Launches exact: K2 16 + 16 a
    adapter per UNet call, plus the tower's and the Resampler's once a
    request; K1 16 per UNet call. Each image must also differ from the
    same request without units on the card. Tolerances as in
    ``phase_tiny``."""
    from diffusionspatialcontrol_tpu_torch.app import api
    from diffusionspatialcontrol_tpu_torch.models import arcface as af
    from diffusionspatialcontrol_tpu_torch.models import clip_vision as cv
    from diffusionspatialcontrol_tpu_torch.models import face_detect as fd
    from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
        StableDiffusionTorch,
    )
    from diffusionspatialcontrol_tpu_torch.text.tokenizer import HashTokenizer

    cpu, dev = torch.device("cpu"), ctx["device"]
    vcfg = cv.CLIPVisionConfig(**TINY_VISION)
    acfg = dataclasses.replace(af.ARCFACE_TINY, embed_dim=512)
    tower = cv.clip_vision_init(torch.Generator().manual_seed(4), vcfg,
                                torch.float32, cpu)
    det = fd.scrfd_init(torch.Generator().manual_seed(5), fd.FACEDETECT_TINY,
                        torch.float32, cpu)
    arc = af.arcface_init(torch.Generator().manual_seed(6), acfg,
                          torch.float32, cpu)
    managers, devices = {}, {"cpu": cpu, "cuda": dev}
    for kind, move in (("cpu", lambda t: t),
                       ("cuda", lambda t: _tree_to(t, dev))):
        m = api.ModelManager(dtype=torch.float32, device=devices[kind])
        m._adapters["image_encoder"] = (vcfg, move(tower))
        m._adapters["face_aligner"] = fd.make_face_aligner(
            move(det), fd.FACEDETECT_TINY, top1_fallback=True)
        m._adapters["face_embedder"] = af.make_arcface_embedder(move(arc),
                                                                acfg)
        managers[kind] = m
    photo = face_photo(96, 11)
    mask = right_half_mask(64)[0]
    lat = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 8, 8, 4)).astype(np.float32))
    cases = [(name, [name, "IP-Adapter"], False)
             for name in api.ModelManager._IP_VARIANTS]
    cases.append(("hires 64^2 -> 128^2", ["IP-Adapter Plus", "IP-Adapter"],
                  True))
    gen = _gen_for("DPM++ 2M Karras", height=64, width=64,
                   num_inference_steps=4, dtype=torch.float32)
    for label, names, hires in cases:
        units = [api.IPAdapterUnit(names[0], photo, mask=mask, scale=0.8),
                 api.IPAdapterUnit(names[1], photo, scale=0.5)]
        once = sum(ip_tower_launches(api.ModelManager._IP_VARIANTS[n],
                                     vcfg.num_layers) for n in names)
        out, calls, wants = {}, {}, {}
        for kind in ("cpu", "cuda", "cuda without units"):
            key = kind.split()[0]
            device = devices[key]
            before = _counts()
            if kind == "cuda without units":
                pipe, ex = StableDiffusionTorch(
                    cfg, on[key], tokenizer=HashTokenizer(),
                    device=device), None
            else:
                pipe, ads = ip_pipeline(managers[key], on[key], cfg, units,
                                        device, torch.float32)
                ex = ip_extras(managers[key], pipe, units, ads)
            c, ids = pipe.encode_prompt([PROMPT], [NEG])
            rb = pipe.encode_region([_masks(64, 64)], ids, 64, 64)
            opts = None
            if hires:
                opts = {"scale": 2.0, "strength": 0.6,
                        "region_state": ([_masks(64, 64)], ids, 1)}
            with UNetCalls() as n:
                res = pipe.txt2img(c, gen, latents=lat, region_biases=rb,
                                   extras=ex, hires=opts)
            got = _delta(_counts(), before)
            calls[kind] = n.n
            want = (want_launches(cfg, 64, n.n, True, "xla",
                                  ip_adapters=0 if ex is None else 2,
                                  ip_once=0 if ex is None else once)
                    if device.type == "cuda" else dict.fromkeys(got, 0))
            if got != want:
                raise AssertionError(f"tiny IP {label} on {kind}: launches "
                                     f"{got}, expected {want}")
            out[kind], wants[kind] = res.cpu(), want
        if len(set(calls.values())) != 1:
            raise AssertionError(f"tiny IP {label}: UNet calls {calls}")
        side = 128 if hires else 64
        if out["cuda"].shape != (1, side, side, 3):
            raise AssertionError(f"tiny IP {label}: image "
                                 f"{out['cuda'].shape}")
        err = check_close(f"tiny IP {label}", out["cuda"], out["cpu"], 0.0,
                          2e-4)
        u8 = [StableDiffusionTorch.to_uint8(out[k]).int()
              for k in ("cuda", "cpu")]
        u8_err = int((u8[0] - u8[1]).abs().max())
        if u8_err > 1:
            raise AssertionError(f"tiny IP {label}: uint8 differs by "
                                 f"{u8_err}")
        moved = float((out["cuda"] - out["cuda without units"]).abs().max())
        if moved < 1e-3:
            raise AssertionError(f"tiny IP {label}: the units moved the "
                                 f"image by {moved:.2e} only")
        log(f"tiny: IP {label} ({' + '.join(names)}): card vs CPU max abs "
            f"err {err:.2e} (fp32), {u8_err} (uint8); the units move the "
            f"image by {moved:.3f}; {calls['cuda']} UNet calls, launches "
            f"{ {k: v for k, v in wants['cuda'].items() if v} }")


def phase_main(ctx):
    from diffusionspatialcontrol_tpu_torch import GenerationConfig, sd15_config
    from diffusionspatialcontrol_tpu_torch.models.factory import (
        init_pipeline_params,
        param_count,
    )
    from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
        StableDiffusionTorch,
    )
    from diffusionspatialcontrol_tpu_torch.text.tokenizer import load_tokenizer

    cfg = sd15_config()
    t0 = time.perf_counter()
    params = _with_text_bias(init_pipeline_params(0, cfg, torch.bfloat16), 0)
    pipes = {ci: StableDiffusionTorch(cfg, params, tokenizer=load_tokenizer(),
                                      conv_impl=ci)
             for ci in ("xla", "pallas", "pallas2")}
    pipe = pipes["xla"]
    ctx["sd15_params"] = params  # phase modes serves the same weights
    torch.cuda.synchronize()
    log(f"main: SD1.5 {param_count(params) / 1e6:.1f} M parameters (bf16, "
        f"random from seed 0) on {pipe.device} in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = GenerationConfig(height=512, width=512, num_inference_steps=STEPS,
                           guidance_scale=7.5, sampler="dpmpp_2m",
                           schedule="karras")
    gen_sde = _gen_for("DPM++ 2M SDE Karras", height=512, width=512,
                       num_inference_steps=STEPS, guidance_scale=7.5,
                       eta=1.0)
    gen_heun = _gen_for("Heun", height=512, width=512,
                        num_inference_steps=STEPS, guidance_scale=7.5)
    c1, ids1 = pipe.encode_prompt([PROMPT], [NEG], clip_skip=2)
    c2, ids2 = pipe.encode_prompt([PROMPT] * 2, [NEG] * 2, clip_skip=2)
    ca, idsa = pipe.encode_prompt([LONG_PROMPT], [NEG], clip_skip=2,
                                  mode="a1111")
    cl, _ = pipe.encode_prompt([LONG_PROMPT], [NEG], clip_skip=2,
                               mode="long")
    if ca.shape[1] != CHUNKED or cl.shape[1] != CHUNKED:
        raise AssertionError(f"main: two-chunk contexts of {ca.shape[1]} "
                             f"and {cl.shape[1]} positions")
    state = _masks(512, 512)
    rb1 = pipe.encode_region([state], ids1, height=512, width=512)
    rb2 = pipe.encode_region([state, state], ids2, height=512, width=512)
    rba = pipe.encode_region([state], idsa, height=512, width=512)
    hires = {"scale": HIRES / 512, "strength": 0.6,
             "region_state": ([state], ids1, 1)}
    hires_steps = int(STEPS * hires["strength"])  # what img2img keeps
    heun_calls = 2 * STEPS - 1  # no correction on the step to sigma = 0

    requests = (  # (type, conv_impl, gen, context, biases, hires, UNet
        #           calls, hires calls, seeds: the first is a warm-up)
        ("spatial", "xla", gen, c1, rb1, None, STEPS, 0, [0, 1, 2, 3, 4, 5]),
        ("vanilla", "xla", gen, c1, None, None, STEPS, 0, [0, 1, 2, 3, 4, 5]),
        ("spatial_b2", "xla", gen, c2, rb2, None, STEPS, 0,
         [[0, 1], [2, 3], [4, 5], [6, 7]]),
        ("spatial_pallas", "pallas", gen, c1, rb1, None, STEPS, 0,
         [0, 1, 2, 3]),
        ("spatial_pallas2", "pallas2", gen, c1, rb1, None, STEPS, 0,
         [0, 1, 2, 3]),
        ("hires", "xla", gen, c1, rb1, hires, STEPS, hires_steps, [0, 1, 2]),
        ("hires_pallas", "pallas", gen, c1, rb1, hires, STEPS, hires_steps,
         [0, 1]),
        ("spatial_a1111", "xla", gen_sde, ca, rba, None, STEPS, 0,
         [0, 1, 2, 3]),
        ("vanilla_long_heun", "xla", gen_heun, cl, None, None, heun_calls, 0,
         [0, 1, 2, 3]),
    )
    ctx.update(launches={}, p50={}, seconds={})
    for (kind, conv_impl, gen_, ctx_, rb, opts, calls, hr_calls,
         seeds) in requests:
        def run(seed, p=pipes[conv_impl], gen_=gen_, ctx_=ctx_, rb=rb,
                opts=opts):
            return p.txt2img(ctx_, gen_, seed=seed, region_biases=rb,
                             hires=opts)

        serve(ctx, kind, run, seeds, calls + hr_calls,
              want_launches(cfg, 512, calls, rb is not None, conv_impl,
                            hr_calls, text_s=ctx_.shape[1]),
              HIRES if opts else 512)
    # img2img from pixels and inpaint on SD1.5 (4-channel UNet): a
    # synthetic init image, app defaults (img2img strength 0.8)
    init = torch.from_numpy(synthetic_image(512, 0)).to(pipe.device)
    mask = torch.from_numpy(right_half_mask(512)).to(pipe.device)
    i2i_calls = int(STEPS * 0.8)
    serve(ctx, "img2img_spatial",
          lambda seed: pipe.img2img(c1, pipe.encode_image(init, seed=seed),
                                    gen, strength=0.8, seed=seed,
                                    region_biases=rb1),
          NEW_SEEDS, i2i_calls,
          want_launches(cfg, 512, i2i_calls, True, "xla", encodes=1), 512)
    serve(ctx, "inpaint_spatial",
          lambda seed: pipe.inpaint(c1, init, mask, gen, strength=1.0,
                                    seed=seed, region_biases=rb1),
          NEW_SEEDS, STEPS,
          want_launches(cfg, 512, STEPS, True, "xla", encodes=1), 512)
    for kind, conv_impl, gen_, ctx_, rb, opts in (
            ("spatial", "xla", gen, c1, rb1, None),
            ("vanilla", "xla", gen, c1, None, None),
            ("spatial_pallas", "pallas", gen, c1, rb1, None),
            ("spatial_pallas2", "pallas2", gen, c1, rb1, None),
            ("hires", "xla", gen, c1, rb1, hires),
            ("spatial_a1111", "xla", gen_sde, ca, rba, None),
            ("vanilla_long_heun", "xla", gen_heun, cl, None, None)):
        for host_ops in (True, False) if kind == "spatial" else (False,):
            defer_profile(
                ctx, lambda p=pipes[conv_impl], gen_=gen_, ctx_=ctx_, rb=rb,
                opts=opts: p.txt2img(ctx_, gen_, seed=99, region_biases=rb,
                                     hires=opts),
                kind, host_ops=host_ops)
    defer_profile(
        ctx, lambda: pipe.img2img(c1, pipe.encode_image(init, seed=99), gen,
                                  strength=0.8, seed=99, region_biases=rb1),
        "img2img_spatial")
    defer_profile(
        ctx, lambda: pipe.inpaint(c1, init, mask, gen, strength=1.0,
                                  seed=99, region_biases=rb1),
        "inpaint_spatial")
    main_units(ctx, pipe, cfg, gen, c1, rb1, ids1, state)
    main_ip(ctx, pipe, cfg, gen, c1, rb1, ids1, state)
    main_other_models(ctx, gen, state, init, mask)

    log("main: p50 s/image after one warm-up: " + ", ".join(
        f"{k} {v:.4f}" for k, v in ctx["p50"].items())
        + f"; launches {ctx['launches']} (card: {card_line()})")
    log("main: seconds by request type: " + ", ".join(
        f"{k} {v:.1f}" for k, v in ctx["seconds"].items()))
    if min(ctx["launches"].values()) == 0:
        raise AssertionError("main: a kernel of the path never launched")


MODE_SEEDS = [0, 1, 2, 3, 4, 5]  # phase modes: a warm-up, then 5 timed


def mode_launches(cfg, calls, mapped, vanilla=0, conv_impl="xla",
                  reuse_calls=0):
    """The exact launches of one speed-mode request at 512^2: ``calls``
    UNet calls that run every transformer's self-attention (K2), of which
    ``mapped`` run their cross-attentions on K1 and ``vanilla`` on K2
    (TGATE's tail runs none); ``reuse_calls`` DeepCache reuse calls, which
    run the 5 level-0 transformers (with the map) and, with a fused
    ``conv_impl``, the 10 convs of down block 0 and the last up block;
    then one VAE decode."""
    want = want_launches(cfg, 512, 0, False, "xla")
    reuse = LEVELS[0][2]
    want["K1"] = PER_UNET * mapped + reuse * reuse_calls
    want["K2"] = PER_UNET * (calls + vanilla) + reuse * reuse_calls
    if conv_impl in ("pallas", "pallas2"):
        shapes = resnet_conv_shapes(cfg, 512, 512)
        unet = [sh for sh in shapes if sh[0] == "unet"]
        level0 = [sh for sh in unet if sh[2] == 512 // 8]
        want["K4" if conv_impl == "pallas" else "K5"] = (
            len(unet) * calls + len(level0) * reuse_calls
            + len([sh for sh in shapes if sh[0] == "vae"]))
    return want


def deepcache_split_check(params, cfg, c1, rb1):
    """A full DeepCache call at 512^2 on the CFG pair (bf16) against
    ``unet_apply``: the port runs the same operations in the same order,
    so they must be equal bit for bit; its cache has the shape of
    ``deepcache_shape``. The JAX package's DeepCache computes each resnet's
    time projection on its own where ``unet_apply`` fuses them into one
    GEMM: the log gives how far the two orders lie apart in bf16 here."""
    from diffusionspatialcontrol_tpu_torch.models import unet as tunet
    from diffusionspatialcontrol_tpu_torch.models.layers import linear, silu

    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(2, 64, 64, 4, generator=g, device="cuda").to(
        torch.bfloat16)
    t = torch.tensor([500.0, 500.0], device="cuda")
    cond = tunet.UNetCond(context=c1.to(torch.bfloat16), region=(
        tunet.RegionState(rb1, torch.tensor(3.0, device="cuda"))))
    shape = tunet.deepcache_shape(cfg.unet, 2, 64, 64)
    out, cache = tunet.unet_apply_deepcache(
        params["unet"], cfg.unet, x, t, cond,
        torch.zeros(shape, dtype=torch.bfloat16, device="cuda"), 0)
    plain = tunet.unet_apply(params["unet"], cfg.unet, x, t, cond)
    if not torch.equal(out, plain) or tuple(cache.shape) != shape:
        raise AssertionError(
            f"modes: a full DeepCache call differs from unet_apply by "
            f"{float((out.float() - plain.float()).abs().max()):.3e} "
            f"(cache {tuple(cache.shape)})")
    temb = tunet._time_embedding(params["unet"], cfg.unet, x, t)
    resnets = tunet._all_resnets(params["unet"])
    fused = tunet._temb_projections(resnets, temb)
    apart = max(float((a.float() - linear(r["time_emb_proj"], silu(temb))
                       .float()).abs().max())
                for a, r in zip(fused, resnets))
    scale = max(float(a.float().abs().max()) for a in fused)
    log(f"modes: a full DeepCache call equals unet_apply bit for bit at "
        f"512^2 (bf16); the {len(resnets)} time projections fused into "
        f"one GEMM against one GEMM a resnet: max abs {apart:.3e} (of "
        f"values up to {scale:.3f})")


def phase_modes(ctx):
    """The opt-in speed modes and DAAM on SD1.5 at full width, main's
    spatial request otherwise (512^2, 25 DPM++ 2M Karras steps, CFG 7.5,
    the two-phrase map, random bf16 weights from seed 0):

    * ``tgate_spatial`` / ``tgate_vanilla``: TGATE at gate_frac 0.5 (12 CFG
      steps, the collect forward, 13 cond-only steps without any
      cross-attention);
    * ``deepcache_spatial`` and ``deepcache_pallas2`` (its resnets on K5):
      DeepCache at interval 3 (9 full calls, 16 reuse calls of the 5
      level-0 transformers and 10 convs);
    * ``bottleneck_spatial``: low_scale 0.5, mid_frac (0.2, 0.8): 5 + 1
      calls at 64^2 latents, 15 + 1 at 32^2 (L = 1024 at level 0), 5 at
      64^2, the map re-encoded at each size;
    * ``cfg_tail_spatial``: tail_frac 0.3 (17 CFG steps, 8 cond-only);
    * ``daam_replay``: ``heatmaps_for_trajectory`` over a spatial
      request's history (24 UNet calls on the cond half with the maps'
      ``attention_probs``), and those maps alone at each level.

    Each request type one warm-up then 5 timed (p50 before any profile),
    its denoiser calls under ``NoHostReads`` (the modes' host-side
    schedules read nothing from the card), its UNet calls and launches
    exact; one request of each type profiled at the end of the run."""
    from diffusionspatialcontrol_tpu_torch import GenerationConfig, sd15_config
    from diffusionspatialcontrol_tpu_torch.introspect import daam
    from diffusionspatialcontrol_tpu_torch.models.factory import (
        init_pipeline_params,
    )
    from diffusionspatialcontrol_tpu_torch.ops.attention import (
        attention_probs,
    )
    from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
        StableDiffusionTorch,
    )
    from diffusionspatialcontrol_tpu_torch.text.tokenizer import load_tokenizer

    cfg = sd15_config()
    params = ctx.get("sd15_params")
    if params is None:
        params = _with_text_bias(init_pipeline_params(0, cfg, torch.bfloat16),
                                 0)
    pipes = {ci: StableDiffusionTorch(cfg, params, tokenizer=load_tokenizer(),
                                      conv_impl=ci)
             for ci in ("xla", "pallas2")}
    pipe = pipes["xla"]
    gen = GenerationConfig(height=512, width=512, num_inference_steps=STEPS,
                           guidance_scale=7.5, sampler="dpmpp_2m",
                           schedule="karras")
    c1, ids1 = pipe.encode_prompt([PROMPT], [NEG], clip_skip=2)
    state = _masks(512, 512)
    rb1 = pipe.encode_region([state], ids1, height=512, width=512)
    ctx.setdefault("launches", {})
    ctx.setdefault("p50", {})
    ctx.setdefault("seconds", {})
    deepcache_split_check(params, cfg, c1, rb1)
    gate = round(STEPS * 0.5)  # 12
    n_tail = round(STEPS * 0.3)  # 8
    full = len(range(0, STEPS, 3))  # 9
    i1, i2 = round(STEPS * 0.2), round(STEPS * 0.8)  # 5, 20
    low = i2 - i1 + 1  # the middle phase's calls and its boundary's
    requests = (  # (type, run(seed), UNet calls, want)
        ("tgate_spatial",
         lambda seed: pipe.txt2img_tgate(c1, gen, 0.5, seed=seed,
                                         region_biases=rb1),
         STEPS + 1, mode_launches(cfg, STEPS + 1, gate + 1)),
        ("tgate_vanilla",
         lambda seed: pipe.txt2img_tgate(c1, gen, 0.5, seed=seed),
         STEPS + 1, mode_launches(cfg, STEPS + 1, 0, vanilla=gate + 1)),
        ("deepcache_spatial",
         lambda seed: pipe.txt2img_deepcache(c1, gen, 3, seed=seed,
                                             region_biases=rb1),
         STEPS, mode_launches(cfg, full, full, reuse_calls=STEPS - full)),
        ("deepcache_pallas2",
         lambda seed: pipes["pallas2"].txt2img_deepcache(
             c1, gen, 3, seed=seed, region_biases=rb1),
         STEPS, mode_launches(cfg, full, full, conv_impl="pallas2",
                              reuse_calls=STEPS - full)),
        ("bottleneck_spatial",
         lambda seed: pipe.txt2img_bottleneck(
             c1, gen, 0.5, seed=seed, region_state=([state], ids1, 1)),
         STEPS + 2, mode_launches(cfg, STEPS + 2, STEPS + 2)),
        ("cfg_tail_spatial",
         lambda seed: pipe.txt2img_cfg_tail(c1, gen, 0.3, seed=seed,
                                            region_biases=rb1),
         STEPS, mode_launches(cfg, STEPS, STEPS)),
    )
    if (STEPS - n_tail, gate, full, i1, i2) != (17, 12, 9, 5, 20):
        raise AssertionError("modes: the schedules moved")
    l_low, d0 = LEVELS_LOW[0][0], LEVELS[0][1]
    for kind, run, calls, want in requests:
        serve(ctx, kind, run, MODE_SEEDS, calls, want, 512, strict=True,
              phase="modes")
        if kind not in UNPROFILED:
            defer_profile(ctx, lambda run=run: run(99), kind)
        if kind == "bottleneck_spatial":
            # the middle phase's level 0: L = 1024 on K1 and K2
            w = _wrappers()
            at = (w["K1"].shapes[(l_low, TEXT, d0)],
                  w["K2"].shapes[(l_low, l_low, d0)])
            if at != (len(MODE_SEEDS) * LEVELS[0][2] * low,) * 2:
                raise AssertionError(f"modes: bottleneck launches at "
                                     f"L = {l_low}: {at}")
            log(f"modes: bottleneck_spatial: {low} UNet calls a request at "
                f"32^2 latents; K1, K2 launches at L = {l_low} over the "
                f"{len(MODE_SEEDS)} requests: {at}")

    # DAAM: a spatial request's history replayed on the cond half
    _, hist = pipe.txt2img(c1, gen, seed=0, region_biases=rb1, decode=False,
                           return_history=True)
    sigmas, _ = pipe._schedule(gen)
    cond_rb = tuple(b[1:] for b in rb1)

    def replay(_seed):
        return daam.heatmaps_for_trajectory(params, cfg, hist, sigmas,
                                            c1[1:], cond_rb)

    replays = STEPS - 1
    _reset_counts()
    seconds = []
    for i, seed in enumerate(MODE_SEEDS):
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps = replay(seed)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = _delta(_counts(), before)
        if got != mode_launches(cfg, replays, replays, conv_impl="xla") or \
                got["K1"] != PER_UNET * replays:
            raise AssertionError(f"modes: daam_replay launches {got}")
        if tuple(maps.shape) != (1, 64, 64, TEXT) or \
                not bool(torch.isfinite(maps).all()) or \
                abs(float(maps.max()) - 1.0) > 1e-6:
            raise AssertionError(f"modes: daam_replay maps "
                                 f"{tuple(maps.shape)}")
        if i:
            seconds.append(dt)
    for k, v in _counts().items():
        ctx["launches"][k] = ctx["launches"].get(k, 0) + v
    ctx["p50"]["daam_replay"] = float(np.median(seconds))
    defer_profile(ctx, lambda: replay(99)[..., :3], "daam_replay")
    mask_in = maps[0, :, :32].sum() / maps[0].sum()
    timer = ColdTimer(ctx["device"])
    g = torch.Generator(device=ctx["device"]).manual_seed(0)
    probs_ms = 0.0
    for l, d, n_l in LEVELS:
        q, k, _ = _qkv(g, 1, l, TEXT, HEADS, d, torch.bfloat16,
                       ctx["device"])
        w = torch.randn(1, l, TEXT, generator=g, device=ctx["device"])
        ms = timer(lambda: attention_probs(q.transpose(1, 2),
                                           k.transpose(1, 2), w,
                                           torch.tensor(2.0)).sum(dim=1))
        probs_ms += ms * n_l
        log(f"modes: attention_probs + head sum at L={l} S={TEXT} D={d} "
            f"(B=1, H={HEADS}, with the map): {ms:.4f} ms")
    log(f"modes: daam_replay p50 {ctx['p50']['daam_replay']:.4f} s for "
        f"{replays} replayed states (launches "
        f"{ {k: v for k, v in got.items() if v} }); the maps of one UNet "
        f"call {probs_ms:.4f} ms; attention share of all tokens in the "
        f"left half {float(mask_in):.3f}")
    log("modes: p50 s/image after one warm-up: " + ", ".join(
        f"{k} {ctx['p50'][k]:.4f}" for k, _, _, _ in requests)
        + f", daam_replay {ctx['p50']['daam_replay']:.4f} s a trajectory; "
        f"main's spatial {ctx['p50'].get('spatial', float('nan')):.4f} "
        f"(card: {card_line()})")


def main_units(ctx, pipe, cfg, gen, c1, rb1, ids1, state):
    """ControlNet and T2I-Adapter requests on SD1.5 at full width, the
    spatial request's settings: ``spatial_controlnet`` (one ControlNet with
    random heads at ``HEAD_RMS``, scale 1.0), ``spatial_t2i`` (the full
    adapter, 320/640/1280/1280, scale 1.0, its weights bf16 and run in fp32
    on the fp32 image, as in the JAX package) and ``hires_controlnet``
    (512^2 -> 1024^2, strength 0.6, the control image refitted to 1024^2 for
    the hires pass as the app does: K2 at L = 16384 in the UNet and in the
    ControlNet), on a synthetic 512^2 control image made with numpy from a
    seed. Exact launches (the ControlNet's 14 attentions a call are all
    K2's), finite images that differ from the spatial request's, and the
    residuals' RMS on a first step's input; each profiled once by its
    kernels (at the end of the run). Their denoiser calls run under
    ``NoHostReads``: the per-step scales are gathered on the card."""
    from diffusionspatialcontrol_tpu_torch import T2IAdapterConfig
    from diffusionspatialcontrol_tpu_torch.app.api import _fit_unit_image
    from diffusionspatialcontrol_tpu_torch.models.controlnet import (
        controlnet_apply,
        controlnet_cond_embedding,
    )
    from diffusionspatialcontrol_tpu_torch.models.factory import param_count
    from diffusionspatialcontrol_tpu_torch.models.t2i_adapter import (
        t2i_adapter_init,
    )
    from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import to_uint8

    dev = pipe.device
    t0 = time.perf_counter()
    cn = unit_controlnet(cfg.unet, 1, dev, torch.bfloat16, HEAD_RMS)
    ad = t2i_adapter_init(torch.Generator(device=dev).manual_seed(2),
                          T2IAdapterConfig(
                              channels=cfg.unet.block_out_channels),
                          torch.bfloat16, dev)
    size = gen.height  # 512
    image = synthetic_image(size, 7) * 0.5 + 0.5
    image_hr = _fit_unit_image(image[0], HIRES, HIRES)[None]
    torch.cuda.synchronize()
    log(f"main: a ControlNet ({param_count(cn) / 1e6:.1f} M parameters, "
        f"heads at RMS {HEAD_RMS}) and a T2I-Adapter "
        f"({param_count(ad) / 1e6:.1f} M), bf16, random from seeds 1 and 2, "
        f"in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(2, size // 8, size // 8, 4, generator=g,
                    device=dev).bfloat16()
    emb = controlnet_cond_embedding(
        cn, torch.from_numpy(image).to(dev).repeat(2, 1, 1, 1),
        torch.bfloat16)
    down, mid = controlnet_apply(
        cn, cfg.unet, x, torch.full((2,), 999.0, device=dev),
        c1.bfloat16(), emb)
    res_rms = [rms(r) for r in down + (mid,)]
    if not all(np.isfinite(res_rms)) or max(res_rms) > 1e3:
        raise AssertionError(f"main: ControlNet residual RMS {res_rms}")
    log(f"main: ControlNet residuals on a first step's input: RMS "
        f"{min(res_rms):.3f} to {max(res_rms):.3f} (12 down and the mid)")

    def cn_extras(g_, side=size):
        return pipe.build_controlnet_extras(
            g_, [cn], [image if side == size else image_hr], scales=[1.0])

    def t2i_extras(g_):
        return pipe.build_t2i_extras(g_, [ad], [image], scales=[1.0])

    hires = {"scale": HIRES / size, "strength": 0.6,
             "region_state": ([state], ids1, 1),
             "rebuild_extras": lambda g_: cn_extras(g_, HIRES)}
    hires_steps = int(STEPS * hires["strength"])
    runs = {
        "spatial_controlnet": lambda seed: pipe.txt2img(
            c1, gen, seed=seed, region_biases=rb1, extras=cn_extras(gen)),
        "spatial_t2i": lambda seed: pipe.txt2img(
            c1, gen, seed=seed, region_biases=rb1, extras=t2i_extras(gen)),
        "hires_controlnet": lambda seed: pipe.txt2img(
            c1, gen, seed=seed, region_biases=rb1, extras=cn_extras(gen),
            hires=hires),
    }
    for kind, seeds, hr, n_cn in (
            ("spatial_controlnet", [0, 1, 2, 3, 4], 0, 1),
            ("spatial_t2i", [0, 1, 2, 3, 4], 0, 0),
            ("hires_controlnet", [0, 1, 2], hires_steps, 1)):
        serve(ctx, kind, runs[kind], seeds, STEPS + hr,
              want_launches(cfg, size, STEPS, True, "xla", hr,
                            controlnets=n_cn), HIRES if hr else size,
              strict=True)
    plain = to_uint8(pipe.txt2img(c1, gen, seed=0, region_biases=rb1)).cpu()
    for kind in ("spatial_controlnet", "spatial_t2i"):
        moved = int((to_uint8(runs[kind](0)).cpu().int() - plain.int()).abs()
                    .max())
        if moved == 0:
            raise AssertionError(f"main: {kind} gave the spatial image")
        log(f"main: {kind} seed 0 against spatial seed 0: max abs {moved} "
            f"on uint8")
    for kind in runs:
        defer_profile(ctx, lambda k=kind: runs[k](99), kind)


def main_ip(ctx, pipe, cfg, gen, c1, rb1, ids1, state):
    """IP-Adapter requests on SD1.5 at full width, the spatial request's
    settings, through a ``ModelManager``'s image tower (OpenCLIP ViT-H/14,
    random bf16 weights), face detector (SCRFD at 640^2, fp32, with the
    top-1 fallback: random weights detect nothing) and face embedder
    (ArcFace iResNet-50 at 112^2, fp32), and the adapters' weights by name
    (``random_state_dict``) installed into a copy of the UNet tree once:
    ``spatial_ip`` ("IP-Adapter": 4 tokens from the tower's projected
    embeds, uncond zeros), ``spatial_ip_plus_masked`` ("IP-Adapter Plus":
    the Resampler's 16 tokens from the tower's penultimate hidden states,
    uncond those of zero pixels, on the right-half mask), ``faceid`` ("IP-
    Adapter FaceID" on a raw 512^2 photo: detect, align, embed) and
    ``hires_ip`` (512^2 -> 1024^2, strength 0.6, the base unit on the mask:
    the gate downsampled at L = 16384 and K2 at S = 4 there). Each request
    embeds its image and builds its tokens anew; exact UNet calls and
    launches (the tower's and the Resampler's once a request), images
    that differ from the spatial request's, denoiser calls under
    ``NoHostReads`` (the gates are downsampled on the card, once a request
    and length); ``spatial_ip_plus_masked`` and ``hires_ip`` profiled once
    by their kernels at the end of the run, then the launches the gate
    cache saves (``ip_gate_cache_launches``)."""
    from diffusionspatialcontrol_tpu_torch.app import api
    from diffusionspatialcontrol_tpu_torch.models.factory import param_count
    from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import to_uint8

    dev = pipe.device
    t0 = time.perf_counter()
    manager = api.ModelManager()
    manager.register_face_detector(top1_fallback=True)
    manager.register_face_embedder()
    enc_cfg, enc = manager.get_image_encoder()
    det = manager.get_face_aligner()
    emb = manager.get_face_embedder()
    torch.cuda.synchronize()
    log(f"main: image tower ViT-H/14 {param_count(enc) / 1e6:.1f} M "
        f"parameters (bf16), SCRFD at {640}^2 and ArcFace iResNet-50 (fp32), "
        f"random from the manager's seed 0, in "
        f"{time.perf_counter() - t0:.1f} s")
    size = gen.height  # 512
    ref = synthetic_image(size, 7)[0] * 0.5 + 0.5
    photo = face_photo(size, 9)
    mask = right_half_mask(size)[0]
    crop = det(photo)
    if crop is None or crop.shape != (112, 112, 3) or \
            emb(crop).shape != (512,):
        raise AssertionError("main: the face detector and embedder gave no "
                             "512-d embedding")
    units = {
        "spatial_ip": [api.IPAdapterUnit("IP-Adapter", ref)],
        "spatial_ip_plus_masked": [api.IPAdapterUnit("IP-Adapter Plus", ref,
                                                     mask=mask)],
        "faceid": [api.IPAdapterUnit("IP-Adapter FaceID", photo)],
        "hires_ip": [api.IPAdapterUnit("IP-Adapter", ref, mask=mask)],
    }
    hires = {"scale": HIRES / size, "strength": 0.6,
             "region_state": ([state], ids1, 1)}
    hires_steps = int(STEPS * hires["strength"])
    params = {k: v for k, v in pipe.params.items()}
    pipes, runs = {}, {}
    for kind, us in units.items():
        t0 = time.perf_counter()
        ip_pipe, ads = ip_pipeline(manager, params, cfg, us, dev,
                                   torch.bfloat16)
        torch.cuda.synchronize()
        log(f"main: {kind}: {us[0].model} ({ads[0].variant}, "
            f"{ads[0].num_tokens} tokens) installed into a copy of the UNet "
            f"tree in {time.perf_counter() - t0:.3f} s")
        pipes[kind] = ip_pipe
        runs[kind] = (lambda seed, p=ip_pipe, us=us, ads=ads,
                      hr=hires if kind == "hires_ip" else None:
                      p.txt2img(c1, gen, seed=seed, region_biases=rb1,
                                extras=ip_extras(manager, p, us, ads),
                                hires=hr))
    seeds = [0, 1, 2]
    for kind in runs:
        variant = api.ModelManager._IP_VARIANTS[units[kind][0].model]
        hr = hires_steps if kind == "hires_ip" else 0
        serve(ctx, kind, runs[kind], seeds, STEPS + hr,
              want_launches(cfg, size, STEPS, True, "xla", hr,
                            ip_adapters=1,
                            ip_once=ip_tower_launches(variant,
                                                      enc_cfg.num_layers)),
              HIRES if hr else size, strict=True)
        # serve counted from 0: the K2 launches of this request type's runs
        # at IP-Adapter's shapes, by (L, S, D)
        ip_shapes = {k: v for k, v in sorted(_wrappers()["K2"].shapes.items())
                     if k[1] in IP_TOKENS + (IP_TOWER[1], IP_RESAMPLER[2])}
        log(f"main: {kind}: K2 launches at IP-Adapter's (L, S, D) over its "
            f"{len(seeds)} requests: {ip_shapes}")
    plain = to_uint8(pipe.txt2img(c1, gen, seed=0, region_biases=rb1)).cpu()
    for kind in ("spatial_ip", "spatial_ip_plus_masked", "faceid"):
        got = to_uint8(runs[kind](0)).cpu().int()
        moved = int((got - plain.int()).abs().max())
        if moved == 0:
            raise AssertionError(f"main: {kind} gave the spatial image")
        halves = [float((got - plain.int())[:, :, sl].abs().float().mean())
                  for sl in (slice(0, size // 2), slice(size // 2, size))]
        log(f"main: {kind} seed 0 against spatial seed 0: max abs {moved} "
            f"on uint8, mean {halves[0]:.2f} on the left half and "
            f"{halves[1]:.2f} on the right (the mask's) half")
    for kind in ("spatial_ip_plus_masked", "hires_ip"):
        defer_profile(ctx, lambda k=kind: runs[k](99), kind)
    unet_p = pipes["spatial_ip_plus_masked"].params["unet"]
    ctx.setdefault("deferred", []).append(
        lambda: ip_gate_cache_launches(unet_p, cfg, mask, size))


def ip_gate_cache_launches(unet_p, cfg, mask, size):
    """The kernel launches the gate cache saves: one UNet call at the
    ``spatial_ip_plus_masked`` shapes (CFG batch 2, 16 tokens, the mask)
    counted by the profiler with a cache that keeps nothing (every
    cross-attention downsamples the mask, as it would without the cache),
    with an empty one (the request's first call) and with the one that call
    filled (every later call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diffusionspatialcontrol_tpu_torch.models.unet import (
        UNetCond,
        unet_apply,
    )

    class KeepsNothing(dict):
        def __setitem__(self, key, value):
            pass

    g = torch.Generator("cuda").manual_seed(0)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    lat = size // 8

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf16)

    x = randn(2, lat, lat, cfg.unet.in_channels)
    t = torch.full((2,), 500.0, device=dev)
    gate = torch.from_numpy(np.asarray(mask, np.float32)[None]).to(dev)
    cond = UNetCond(context=randn(2, 77, cfg.unet.cross_attention_dim),
                    ip_tokens=(randn(2, 16, cfg.unet.cross_attention_dim),),
                    ip_scales=(1.0,), ip_masks=(gate.expand(2, -1, -1),))

    def launches(c):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            unet_apply(unet_p, cfg.unet, x, t, c)
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)

    uncached = launches(dataclasses.replace(cond,
                                            ip_mask_cache=KeepsNothing()))
    first = launches(cond)
    later = launches(cond)
    keys = sorted(cond.ip_mask_cache)
    if not uncached > first > later or keys != [
            (0, (lat >> i) ** 2) for i in (3, 2, 1, 0)]:
        raise AssertionError(f"main: ip gate cache: launches {uncached} "
                             f"uncached, {first} first, {later} later; "
                             f"keys {keys}")
    saved = STEPS * (uncached - later) - (first - later)
    log(f"main: ip gate cache: one spatial_ip_plus_masked UNet call "
        f"launches {uncached} kernels without the cache, {first} as a "
        f"request's first call, {later} as a later one: the cache saves "
        f"{saved} launches a {STEPS}-call request")


def serve(ctx, kind, run, seeds, calls, want, side, strict=False,
          phase="main"):
    """Serve ``run(seed)`` (fp32 images) once a seed, the first request a
    warm-up, each followed by the uint8 copy to the host. Checks each
    request's UNet calls, exact launches and images; records the p50
    seconds per image of the timed ones. ``strict``: the denoiser's calls
    may not read from the card (``NoHostReads``). The launch counts are set
    to 0 before the first request and read after the last:
    ``ctx["launches"]`` sums them over the request types, the main path's
    launches. ``phase`` names the phase in the log lines."""
    from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import to_uint8

    _reset_counts()
    t_kind = time.perf_counter()
    per_image = []
    for i, seed in enumerate(seeds):
        batch = len(seed) if isinstance(seed, list) else 1
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (NoHostReads() if strict else UNetCalls()) as n:
            img = run(seed)
            u8 = to_uint8(img).cpu()
        dt = time.perf_counter() - t0
        launches = _delta(_counts(), before)
        if n.n != calls:
            raise AssertionError(f"{phase} {kind} seed {seed}: {n.n} UNet "
                                 f"calls, expected {calls}")
        if launches != want:
            raise AssertionError(f"{phase} {kind} seed {seed}: launches "
                                 f"{launches}, expected {want}")
        if tuple(img.shape) != (batch, side, side, 3) or \
                img.dtype != torch.float32:
            raise AssertionError(f"{phase} {kind}: image {tuple(img.shape)} "
                                 f"{img.dtype}")
        if not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{phase} {kind} seed {seed}: non-finite "
                                 f"image")
        if tuple(u8.shape) != (batch, side, side, 3) or \
                u8.dtype != torch.uint8:
            raise AssertionError(f"{phase} {kind}: uint8 {tuple(u8.shape)}")
        if not np.array_equal(u8.numpy(), u8_reference(img.cpu())):
            raise AssertionError(f"{phase} {kind} seed {seed}: uint8 differs "
                                 f"from the codec's rounding")
        log(f"{phase}: {kind} seed {seed}: {dt:.3f} s "
            f"({'warm-up' if i == 0 else f'{dt / batch:.3f} s/image'}), "
            f"{n.n} UNet calls, launches "
            f"{ {k: v for k, v in launches.items() if v} }, image mean "
            f"{float(img.mean()):+.4f} std {float(img.std()):.4f}")
        if i:
            per_image.append(dt / batch)
    for k, v in _counts().items():
        ctx["launches"][k] = ctx["launches"].get(k, 0) + v
    ctx["p50"][kind] = float(np.median(per_image))
    ctx["seconds"][kind] = time.perf_counter() - t_kind


def main_other_models(ctx, gen, state, init, mask):
    """The requests of the other presets at full width, each model's random
    bf16 weights (seed 0) kept for the profiles at the end of the run:
    ``sd15_inpaint_config()`` (9-channel UNet) inpainting the SD1.5
    requests' init image and mask; the same UNet with the asymmetric VAE
    of ``sd15_asym_inpaint_config()``; and ``sd21_config()`` (the app's
    SD2.1 zoo model: OpenCLIP-width gelu text encoder, linear projections,
    K1/K2 at D = 64 with 5/10/20 heads) serving txt2img with the map. Each
    profiled once by its kernels, at the end of the run. Every one at
    512^2, 25 DPM++ 2M Karras steps, CFG 7.5, the two-phrase map."""
    from diffusionspatialcontrol_tpu_torch import (
        sd15_asym_inpaint_config,
        sd15_inpaint_config,
        sd21_config,
    )
    from diffusionspatialcontrol_tpu_torch.models.factory import (
        init_pipeline_params,
        param_count,
    )
    from diffusionspatialcontrol_tpu_torch.models.vae import vae_init
    from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
        StableDiffusionTorch,
    )
    from diffusionspatialcontrol_tpu_torch.text.tokenizer import load_tokenizer

    def load(cfg, params, what):
        t0 = time.perf_counter()
        pipe = StableDiffusionTorch(cfg, params, tokenizer=load_tokenizer())
        c, ids = pipe.encode_prompt([PROMPT], [NEG], clip_skip=2)
        rb = pipe.encode_region([state], ids, height=512, width=512)
        torch.cuda.synchronize()
        log(f"main: {what}: {param_count(params) / 1e6:.1f} M parameters "
            f"(bf16, random from seed 0) in {time.perf_counter() - t0:.1f} s")
        return pipe, c, rb

    def inpaint(pipe, c, rb):
        return lambda seed: pipe.inpaint(c, init, mask, gen, strength=1.0,
                                         seed=seed, region_biases=rb)

    cfg9 = sd15_inpaint_config()
    want = want_launches(cfg9, 512, STEPS, True, "xla", encodes=1)
    params = init_pipeline_params(0, cfg9, torch.bfloat16)
    pipe, c, rb = load(cfg9, params, "sd15_inpaint_config")
    serve(ctx, "inpaint9_spatial", inpaint(pipe, c, rb), NEW_SEEDS, STEPS,
          want, 512)
    # the defaults bind this model: pipe, c and rb are rebound below
    defer_profile(ctx, lambda p=pipe, c=c, rb=rb: inpaint(p, c, rb)(99),
                  "inpaint9_spatial")
    cfga = sd15_asym_inpaint_config()
    dev = pipe.device
    params = dict(params, vae=vae_init(  # the 9-channel UNet, a new VAE
        torch.Generator(device=dev).manual_seed(0), cfga.vae, torch.bfloat16,
        dev))
    pipe, c, rb = load(cfga, params, "sd15_asym_inpaint_config (the "
                                     "9-channel UNet, an asymmetric VAE)")
    serve(ctx, "inpaint_asym", inpaint(pipe, c, rb), NEW_SEEDS, STEPS, want,
          512)
    cfg21 = sd21_config()
    params = init_pipeline_params(0, cfg21, torch.bfloat16)
    pipe, c, rb = load(cfg21, params, "sd21_config")
    serve(ctx, "sd21_spatial",
          lambda seed: pipe.txt2img(c, gen, seed=seed, region_biases=rb),
          NEW_SEEDS, STEPS, want_launches(cfg21, 512, STEPS, True, "xla"),
          512)
    defer_profile(ctx, lambda p=pipe, c=c, rb=rb: p.txt2img(
        c, gen, seed=99, region_biases=rb), "sd21_spatial")


# diffusers names of the port's trees (the JAX package has no exporter, so
# the inverse of convert/hf.py's naming lives here, for phase weights and
# the CPU tests that write checkpoints)
_DIFFUSERS_RENAMES = {
    "blocks": "transformer_blocks", "to_out": "to_out.0",
    "downsample": "downsamplers.0.conv", "upsample": "upsamplers.0.conv",
    "resnet1": "resnets.0", "resnet2": "resnets.1",
    "attention": "attentions.0", "mid": "mid_block",
    "cond_embedding": "controlnet_cond_embedding",
    "zero_convs": "controlnet_down_blocks",
    "mid_zero_conv": "controlnet_mid_block",
}
_DIFFUSERS_FF = {"proj_in": "net.0.proj", "proj_out": "net.2"}
_CLIP_NAMES = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
               "v_proj": "self_attn.v_proj", "out_proj": "self_attn.out_proj",
               "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def diffusers_state_dict(tree, prefix: str = "") -> dict:
    """name -> tensor of a UNet, VAE or ControlNet tree under the diffusers
    names: a conv's or linear's kernel (OIHW, (out, in): torch's own
    layouts) and a norm's scale are ``.weight``, biases ``.bias``; the VAE's
    quant convs sit outside its encoder and decoder."""
    out = {}

    def walk(node, name):
        if node is None:
            return
        if isinstance(node, torch.Tensor):
            out[name] = node
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{name}.{i}")
        elif "kernel" in node or "scale" in node:
            out[f"{name}.weight"] = node.get("kernel", node.get("scale"))
            if "bias" in node:
                out[f"{name}.bias"] = node["bias"]
        else:
            for k, v in node.items():
                if name.endswith(".ff") and k in _DIFFUSERS_FF:
                    seg = _DIFFUSERS_FF[k]
                elif k == "blocks" and name.endswith("cond_embedding"):
                    seg = k
                else:
                    seg = _DIFFUSERS_RENAMES.get(k, k)
                walk(v, f"{name}.{seg}" if name else seg)

    walk(tree, prefix)
    return {k.replace("encoder.quant_conv.", "quant_conv.").replace(
        "decoder.post_quant_conv.", "post_quant_conv."): v
        for k, v in out.items()}


def clip_state_dict(tree) -> dict:
    """name -> tensor of a CLIP text tree under the transformers names."""
    out = {"text_model.embeddings.token_embedding.weight":
           tree["token_embedding"],
           "text_model.embeddings.position_embedding.weight":
           tree["position_embedding"]}
    for i, layer in enumerate(tree["layers"]):
        for k, v in layer.items():
            name = f"text_model.encoder.layers.{i}.{_CLIP_NAMES.get(k, k)}"
            out[f"{name}.weight"] = v.get("kernel", v.get("scale"))
            out[f"{name}.bias"] = v["bias"]
    norm = tree["final_layer_norm"]
    out["text_model.final_layer_norm.weight"] = norm["scale"]
    out["text_model.final_layer_norm.bias"] = norm["bias"]
    return out


def write_diffusers_checkpoint(params, root: str, dtype=torch.float16
                               ) -> dict:
    """A diffusers-layout checkpoint directory of ``params`` at ``root``:
    unet/, vae/ and text_encoder/ safetensors files of ``dtype`` tensors,
    written by the port's own writer; no tokenizer/. Returns the seconds
    each file took to write."""
    from diffusionspatialcontrol_tpu_torch.convert.safetensors import (
        save_file,
    )

    seconds = {}
    for sub, fname, sd in (
            ("unet", "diffusion_pytorch_model.safetensors",
             diffusers_state_dict(params["unet"])),
            ("vae", "diffusion_pytorch_model.safetensors",
             diffusers_state_dict(params["vae"])),
            ("text_encoder", "model.safetensors",
             clip_state_dict(params["clip"]))):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        t0 = time.perf_counter()
        save_file({k: v.to(dtype) for k, v in sd.items()},
                  os.path.join(root, sub, fname))
        seconds[sub] = time.perf_counter() - t0
    return seconds


def decode_png(data: bytes) -> np.ndarray:
    """A short PNG decoder on Python's zlib for what the codec writes: 8-bit
    RGB, not interlaced, every scanline unfiltered (filter type 0). Checks
    the signature and every chunk's CRC."""
    import struct
    import zlib

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("png: bad signature")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise AssertionError(f"png: bad CRC in {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, colour, _, _, interlace = hdr
    if (depth, colour, interlace) != (8, 2, 0):
        raise AssertionError(f"png: header {hdr} is not 8-bit RGB")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError("png: a filtered scanline")
    return rows[:, 1:].reshape(h, w, 3)


def _http(port: int, path: str, payload=None):
    """(status, JSON body, seconds) of one request to the local server."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as f:
            status, body = f.status, f.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    return status, json.loads(body), time.perf_counter() - t0


def _pngs(out) -> np.ndarray:
    import base64

    return np.stack([decode_png(base64.b64decode(s)) for s in out["images"]])


def _json_state(state):
    return {k: {**v, "mask": v["mask"].astype(int).tolist()}
            for k, v in state.items()}


def phase_app(ctx):
    """The app layer on the card: a ``ModelManager()`` (CUDA by default)
    with SD1.5 at full width (random bf16 weights from seed 0) behind the
    JSON HTTP server (``serve(..., port=0, block=False)``, in this process),
    sent with images and masks as nested lists:

    1. the spatial request of phase main (512^2, "DPM++ 2M Karras", 25
       steps, CFG 7.5, the two-phrase map, short prompt mode) over HTTP, by
       a direct ``inference()`` call and by ``StableDiffusionTorch.txt2img``
       in turns, ``ROUNDS`` timed rounds after one warm-up: every POST must
       return the same bytes, and its image must equal the other two paths'
       bit for bit;
    2. the same request as a job (``/jobs``, ``cancel_check_steps=5``),
       polled to done (progress 25/25; its image equal to request 1's, since
       the chunked path is bitwise the plain one), and a second job
       cancelled while it waits in the queue;
    3. 2-prompt x 2-seed grids at 512^2 with and without the map; each
       sample of the unmapped grid is held to its single request within
       the CPU tests' bound (rtol/atol 1e-3) on the sampler's fp32 output
       (see the comment there for why not on bf16 uint8);
    4. a hires request, 512^2 -> 1024^2, strength 0.6, in the app's default
       "a1111" prompt mode (K2 at K3's shapes);
    5. the spatial request with a ControlNet unit ("Canny": zero heads, so
       its PNG must equal request 1's bit for bit; K2 + 350) and with a
       T2I-Adapter unit (random: finite and another image), each on a
       256^2 uint8 control image sent as a nested list; then with an
       IP-Adapter unit ("IP-Adapter", a 224^2 reference image as a nested
       list; K2 + 400 + 32), and with the same unit at scale 0, whose PNG
       must equal request 1's bit for bit; then with DeepCache at interval
       3 (a speed mode);
    6. ``/warmup`` with the two 512^2 batch-1 configs of
       ``default_warmup_configs("sd15")`` (with and without a map).

    Each generating response's PNGs are decoded here and held to a direct
    ``inference()`` call with the same arguments, bit for bit; the UNet
    calls and K1/K2 launches of every request are exact, and ``timings``
    holds the card's memory. Prints the HTTP p50 s/image beside the direct
    ``inference()`` p50 and the pipeline's, the server's ``timings``
    phases, and a profile of one HTTP request by its kernels."""
    from diffusionspatialcontrol_tpu_torch import sd15_config
    from diffusionspatialcontrol_tpu_torch.app import api
    from diffusionspatialcontrol_tpu_torch.app.server import (
        _inference_kwargs,
    )
    from diffusionspatialcontrol_tpu_torch.app.server import serve as http
    from diffusionspatialcontrol_tpu_torch.parallel.batched import (
        generate_grid,
    )
    from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import to_uint8
    from diffusionspatialcontrol_tpu_torch.runtime import native

    if not native.available():
        raise AssertionError("app: the native image codec did not build")
    cfg = sd15_config()
    t0 = time.perf_counter()
    manager = api.ModelManager()
    manager.register_random("sd15", cfg, seed=0)
    _with_text_bias(manager._cache["sd15"], 0)
    server = http(manager, port=0, block=False)
    port = server.server_address[1]
    log(f"app: ModelManager on {manager.device} with SD1.5 (bf16, random "
        f"from seed 0) and the server on port {port} in "
        f"{time.perf_counter() - t0:.1f} s")
    state = _masks(512, 512)
    base = {"prompt": PROMPT, "neg_prompt": NEG, "model": "sd15",
            "sampler": "DPM++ 2M Karras", "steps": STEPS, "cfg_scale": 7.5,
            "width": 512, "height": 512, "seed": 0, "encoding_mode": "short",
            "region_state": _json_state(state)}
    spatial = want_launches(cfg, 512, STEPS, True, "xla")
    t_phase = time.perf_counter()
    # launches of the HTTP requests alone, for the kernels line: the direct
    # calls they are checked against run between them and are not served
    served = {}

    def count(launches):
        for k, v in launches.items():
            served[k] = served.get(k, 0) + v

    def post(what, path, payload, calls, want, n_images, side=512):
        """One generating POST: status 200, exact UNet calls and launches,
        n_images finite-looking PNGs of side^2; returns (uint8, body, s)."""
        before = _counts()
        torch.cuda.synchronize()
        with UNetCalls() as n:
            status, out, dt = _http(port, path, payload)
        if status != 200:
            raise AssertionError(f"app: {what}: HTTP {status} {out}")
        launches = _delta(_counts(), before)
        count(launches)
        if n.n != calls or launches != want:
            raise AssertionError(f"app: {what}: {n.n} UNet calls, launches "
                                 f"{launches}; expected {calls}, {want}")
        img = _pngs(out)
        if img.shape != (n_images, side, side, 3):
            raise AssertionError(f"app: {what}: images {img.shape}")
        timings = json.loads(out["timings"])
        if "hbm_in_use_mb" not in timings:
            raise AssertionError(f"app: {what}: timings {timings}")
        log(f"app: {what}: HTTP {dt:.3f} s, {n.n} UNet calls, launches "
            f"{ {k: v for k, v in launches.items() if v} }, timings "
            f"{timings}")
        return img, out, dt

    def direct(payload, what):
        """``inference()`` on the server's parse of ``payload``; uint8."""
        t = time.perf_counter()
        images = api.inference(manager, **_inference_kwargs(payload))[
            "images"]
        dt = time.perf_counter() - t
        if images.dtype != np.uint8:
            raise AssertionError(f"app: {what}: direct images {images.dtype}")
        return images, dt

    def same(what, got, want):
        if not np.array_equal(got, want):
            raise AssertionError(
                f"app: {what}: HTTP images differ from a direct inference() "
                f"call (max abs {np.abs(got.astype(int) - want).max()})")

    # 1. the spatial request over HTTP, by a direct inference() call and by
    # the pipeline, in turns; the first round is each path's warm-up
    pipe = api.StableDiffusionTorch(cfg, manager._cache["sd15"],
                                    tokenizer=manager._tokenizers["sd15"])
    c1, ids1 = pipe.encode_prompt([PROMPT], [NEG], clip_skip=2)
    rb1 = pipe.encode_region([state], ids1, height=512, width=512)
    gen = _gen_for("DPM++ 2M Karras", num_inference_steps=STEPS)
    http_s, direct_s, pipe_s, raw = [], [], [], []
    for i in range(ROUNDS + 1):
        img, out, dt = post(f"spatial POST {i}", "/generate", base, STEPS,
                            spatial, 1)
        raw.append(out["images"][0])
        want_img, dt_direct = direct(base, "spatial")
        torch.cuda.synchronize()
        t = time.perf_counter()
        u8 = to_uint8(pipe.txt2img(c1, gen, seed=0, region_biases=rb1)
                      ).cpu().numpy()
        dt_pipe = time.perf_counter() - t
        same("spatial", img, want_img)
        same("StableDiffusionTorch.txt2img", img, u8)
        if i:
            http_s.append(dt)
            direct_s.append(dt_direct)
            pipe_s.append(dt_pipe)
    if len(set(raw[1:])) != 1:
        raise AssertionError("app: identical POSTs returned other bytes")
    p50 = {k: float(np.median(v)) for k, v in (
        ("HTTP", http_s), ("inference()", direct_s), ("txt2img", pipe_s))}
    log("app: spatial p50 s/image: " + ", ".join(
        f"{k} {v:.4f}" for k, v in p50.items())
        + f" (HTTP over inference(): {p50['HTTP'] - p50['inference()']:+.4f}"
        f" s; inference() over txt2img: "
        f"{p50['inference()'] - p50['txt2img']:+.4f} s; card: "
        f"{card_line()})")

    # 2. a job with progress, and a job cancelled while queued
    before = _counts()
    status, job, _ = _http(port, "/jobs", {**base, "cancel_check_steps": 5})
    status2, job2, _ = _http(port, "/jobs", base)
    _, cancelled, _ = _http(port, f"/jobs/{job2['job_id']}/cancel", {})
    if (status, status2) != (202, 202) or cancelled["status"] != "cancelled":
        raise AssertionError(f"app: jobs {status} {status2} {cancelled}")
    seen = set()
    while True:
        _, res, _ = _http(port, f"/jobs/{job['job_id']}")
        seen.add(res["progress"]["done"])
        if res["status"] in ("done", "error", "cancelled"):
            break
        time.sleep(0.05)
    _, res2, _ = _http(port, f"/jobs/{job2['job_id']}")
    if res["status"] != "done" or res["progress"] != {"done": STEPS,
                                                       "total": STEPS}:
        raise AssertionError(f"app: job ended {res['status']} "
                             f"{res.get('error')} {res['progress']}")
    if res2["status"] != "cancelled":
        raise AssertionError(f"app: the cancelled job is {res2['status']}")
    launches = _delta(_counts(), before)
    count(launches)
    if launches != spatial:
        raise AssertionError(f"app: jobs launched {launches}, expected one "
                             f"request's {spatial}")
    same("job", _pngs(res), want_img)
    log(f"app: job {job['job_id']} done, progress seen "
        f"{sorted(seen)}; job {job2['job_id']} cancelled while queued")

    # 3. 2-prompt x 2-seed grids over HTTP, with and without the map, each
    # equal to a direct inference() call. The per-sample contract (a
    # sample's draws are its single request's, so it differs from it only
    # by rounding) is held with the CPU tests' bound, rtol/atol 1e-3, on
    # the sampler's fp32 output (TF32 off) without a map: with the map a
    # sample's bias strength takes its std over the whole batch, as the
    # reference's qk.std() does, and the random decoder turns batch-size
    # rounding into a few uint8 steps (ROADMAP section 3)
    prompts = [PROMPT, "a blue bird flying over a red cat, a wooden bench"]
    grid = {**base, "prompt": prompts, "seed": [0, 1]}
    gimg, _, gdt = post("grid 2x2", "/generate", grid, STEPS, spatial, 4)
    same("grid", gimg, direct(grid, "grid")[0])
    coupled = int(np.abs(gimg[0].astype(int) - img[0]).max())
    vanilla = want_launches(cfg, 512, STEPS, False, "xla")
    vgrid = {**grid, "region_state": None}
    vimg, _, vdt = post("grid 2x2 without a map", "/generate", vgrid, STEPS,
                        vanilla, 4)
    same("grid without a map", vimg, direct(vgrid, "grid")[0])
    t = time.perf_counter()
    gen32 = dataclasses.replace(gen, dtype=torch.float32)
    lat4 = generate_grid(pipe, prompts, [0, 1], gen32, negative_prompt=NEG,
                         decode=False)
    err = 0.0
    for p, prompt in enumerate(prompts):
        ctx_p, _ = pipe.encode_prompt([prompt], [NEG], clip_skip=2)
        for s, seed in enumerate((0, 1)):
            lat1 = pipe.txt2img(ctx_p, gen32, seed=seed, decode=False)
            err = max(err, check_close(
                f"app: fp32 grid sample ({p}, {s})",
                lat4[2 * p + s:2 * p + s + 1], lat1, rtol=1e-3, atol=1e-3))
    log(f"app: grid 2x2 with the map {gdt:.3f} s ({gdt / 4:.3f} s/image; "
        f"sample (0, 0) against its single request: max abs {coupled} on "
        f"uint8), without {vdt:.3f} s; fp32 samples without the map within "
        f"{err:.3g} of their single requests (bound 1e-3; checks in "
        f"{time.perf_counter() - t:.1f} s)")

    # 4. hires 512^2 -> 1024^2 in the app's default prompt mode
    hires = {**base, "hires_scale": HIRES / 512, "hires_strength": 0.6}
    del hires["encoding_mode"]
    hires_steps = int(STEPS * 0.6)
    himg, _, hdt = post("hires", "/generate", hires, STEPS + hires_steps,
                        want_launches(cfg, 512, STEPS, True, "xla",
                                      hires_steps), 1, side=HIRES)
    same("hires", himg, direct(hires, "hires")[0])

    # 5. units: a ControlNet by name (zero heads: the spatial request's
    # image bit for bit, with its 14 attentions a step on K2) and a
    # T2I-Adapter by name (random weights: another image), each with a
    # 256^2 uint8 control image that the app fits to 512^2
    unit_img = (synthetic_image(256, 7)[0] * 127.5 + 127.5).astype(
        np.uint8).tolist()
    cn_post = {**base, "controlnet_units": [{"model": "Canny",
                                             "image": unit_img}]}
    cimg, _, cdt = post("ControlNet unit (zero heads)", "/generate", cn_post,
                        STEPS, want_launches(cfg, 512, STEPS, True, "xla",
                                             controlnets=1), 1)
    if not np.array_equal(cimg, want_img):
        raise AssertionError(
            f"app: a zero-head ControlNet changed the spatial image (max abs "
            f"{np.abs(cimg.astype(int) - want_img).max()})")
    t2i_post = {**base, "t2i_units": [{"model": "Sketch", "image": unit_img}]}
    timg, _, tdt = post("T2I-Adapter unit", "/generate", t2i_post, STEPS,
                        spatial, 1)
    if np.array_equal(timg, want_img):
        raise AssertionError("app: the T2I-Adapter unit left the spatial "
                             "image as it was")
    log(f"app: ControlNet unit {cdt:.3f} s, its PNG the spatial request's "
        f"bit for bit; T2I-Adapter unit {tdt:.3f} s, max abs "
        f"{np.abs(timg.astype(int) - want_img).max()} from the spatial "
        f"image on uint8")

    # 5b. an IP-Adapter unit by name (its weights random_state_dict's, the
    # manager's ViT-H/14 tower built at first use) with a 224^2 reference
    # image in [0, 1] as a nested list: inference()'s PNG bit for bit; the
    # same unit at scale 0 gives the spatial request's PNG bit for bit
    # (the decoupled attention is added as out + 0 * ip_out)
    ip_unit = {"model": "IP-Adapter", "image": (
        synthetic_image(224, 7)[0] * 0.5 + 0.5).round(4).tolist()}
    ip_post = {**base, "ip_adapter_units": [ip_unit]}
    ip_want = want_launches(cfg, 512, STEPS, True, "xla", ip_adapters=1,
                            ip_once=ip_tower_launches("linear", 32))
    iimg, _, idt = post("IP-Adapter unit", "/generate", ip_post, STEPS,
                        ip_want, 1)
    same("IP-Adapter unit", iimg, direct(ip_post, "IP-Adapter unit")[0])
    if np.array_equal(iimg, want_img):
        raise AssertionError("app: the IP-Adapter unit left the spatial "
                             "image as it was")
    zimg, _, zdt = post("IP-Adapter unit at scale 0", "/generate", {
        **base, "ip_adapter_units": [{**ip_unit, "scale": 0.0}]}, STEPS,
        ip_want, 1)
    if not np.array_equal(zimg, want_img):
        raise AssertionError(
            f"app: an IP-Adapter unit at scale 0 changed the spatial image "
            f"(max abs {np.abs(zimg.astype(int) - want_img).max()})")
    log(f"app: IP-Adapter unit {idt:.3f} s (the first builds the image "
        f"tower), max abs {np.abs(iimg.astype(int) - want_img).max()} from "
        f"the spatial image on uint8; at scale 0 {zdt:.3f} s, its PNG the "
        f"spatial request's bit for bit")

    # 5c. a speed mode: DeepCache at interval 3 (9 full UNet calls, 16
    # reuse calls), inference()'s PNG bit for bit, another image
    dc_post = {**base, "deepcache_interval": 3}
    full = len(range(0, STEPS, 3))
    dimg, _, ddt = post("DeepCache (interval 3)", "/generate", dc_post,
                        STEPS, mode_launches(cfg, full, full,
                                             reuse_calls=STEPS - full), 1)
    same("DeepCache", dimg, direct(dc_post, "DeepCache")[0])
    if np.array_equal(dimg, want_img):
        raise AssertionError("app: DeepCache left the spatial image as it "
                             "was")
    log(f"app: DeepCache (interval 3) {ddt:.3f} s, max abs "
        f"{np.abs(dimg.astype(int) - want_img).max()} from the spatial "
        f"image on uint8")

    # 6. /warmup with the 512^2 batch-1 buckets
    configs = [dict(c) for c in api.default_warmup_configs("sd15")
               if c["width"] == 512 and c["num_images_per_prompt"] == 1]
    for c in configs:
        if "region_state" in c:
            c["region_state"] = _json_state(c["region_state"])
    before = _counts()
    with UNetCalls() as n:
        status, out, wdt = _http(port, "/warmup", {"configs": configs})
    launches = _delta(_counts(), before)
    count(launches)
    want = {k: v + vanilla[k] for k, v in spatial.items()}
    if status != 200 or len(out["results"]) != 2 or n.n != 2 * STEPS \
            or launches != want:
        raise AssertionError(f"app: /warmup {status} {out}, {n.n} UNet "
                             f"calls, launches {launches} (expected {want})")
    log(f"app: /warmup of {len(configs)} configs in {wdt:.3f} s: "
        f"{out['results']}")

    for k, v in served.items():
        ctx.setdefault("launches", {})[k] = ctx["launches"].get(k, 0) + v
    log(f"app: launches of the HTTP requests "
        f"{ {k: v for k, v in served.items() if v} }; requests served and checked in "
        f"{time.perf_counter() - t_phase:.1f} s")
    profile_request(lambda: torch.from_numpy(
        _pngs(_http(port, "/generate", base)[1])), "app_http_spatial",
        p50["HTTP"], host_ops=False)
    server.shutdown()
    server.server_close()
    del pipe, manager
    torch.cuda.empty_cache()


DETECT_SIDE = 512  # phase preprocess: the photo, and the request's size


def _detector_nets():
    """(name, draw() -> state dict, convert(sd, device), apply(params, x),
    input shape) of each detector network at its published width, its
    random weights those that ``get_preprocessor`` draws."""
    from diffusionspatialcontrol_tpu_torch.models import (
        dpt, hed, lineart, lineart_anime, mlsd, normalbae, openpose,
        pidinet, upernet, zoedepth)

    d, z, u, n = (dpt.DPTConfig(), zoedepth.ZoeDepthConfig(),
                  upernet.UperNetConfig(), normalbae.NormalBaeConfig())
    return (
        ("Depth", lambda: dpt.random_state_dict(d, 0),
         lambda sd, dev: dpt.convert_dpt(sd, d, dev),
         lambda p, x: dpt.dpt_apply(p, d, x), (1, 384, 384, 3)),
        ("Zoedepth", lambda: zoedepth.random_state_dict(z, 0),
         lambda sd, dev: zoedepth.convert_zoedepth(sd, z, dev),
         lambda p, x: zoedepth.zoedepth_apply(p, z, x)[0],
         (1, 384, 512, 3)),
        ("Semantic Segmentation", lambda: upernet.random_state_dict(u, 0),
         lambda sd, dev: upernet.convert_upernet(sd, u, dev),
         lambda p, x: upernet.upernet_apply(p, u, x), (1, 512, 512, 3)),
        ("Normal Map", lambda: normalbae.random_state_dict(n, 0),
         lambda sd, dev: normalbae.convert_nnet(sd, n, dev),
         lambda p, x: normalbae.nnet_apply(p, n, x), (1, 512, 512, 3)),
        ("Openpose", lambda: openpose.random_state_dict(seed=0),
         openpose.convert_openpose_body,
         lambda p, x: torch.cat(openpose.openpose_body_apply(p, x), -1),
         (1, 368, 368, 3)),
        ("Openpose (hand)", lambda: openpose.random_hand_state_dict(seed=0),
         openpose.convert_openpose_hand, openpose.openpose_hand_apply,
         (1, 368, 368, 3)),
        ("Openpose (face)", lambda: openpose.random_face_state_dict(seed=0),
         openpose.convert_openpose_face, openpose.openpose_face_apply,
         (1, 368, 368, 3)),
        ("Soft Edge", lambda: pidinet.random_state_dict(seed=0),
         pidinet.convert_pidinet, pidinet.pidinet_apply, (1, 512, 512, 3)),
        ("Soft Edge (HED)", lambda: hed.random_state_dict(seed=0),
         hed.convert_hed, lambda p, x: hed.hed_apply(p, x)[0],
         (1, 512, 512, 3)),
        ("Lineart", lambda: lineart.random_state_dict(seed=0),
         lineart.convert_lineart, lineart.lineart_apply, (1, 512, 512, 3)),
        ("Lineart (anime)", lambda: lineart_anime.random_state_dict(seed=0),
         lineart_anime.convert_lineart_anime,
         lineart_anime.lineart_anime_apply, (1, 512, 512, 3)),
        ("MLSD", lambda: mlsd.random_state_dict(seed=0), mlsd.convert_mlsd,
         mlsd.mlsd_apply, (1, 512, 512, 4)),
    )


def _tiny_nets():
    """The same networks at the small configs of the CPU tests."""
    from diffusionspatialcontrol_tpu_torch.models import (
        dpt, hed, lineart, lineart_anime, mlsd, normalbae, openpose,
        pidinet, upernet, zoedepth)

    d, n, z = dpt.DPT_FALLBACK, normalbae.NNET_TINY, zoedepth.ZOE_TINY
    u = upernet.UperNetConfig(hidden_sizes=(8, 12, 16, 24),
                              depths=(1, 1, 2, 1), head_channels=16,
                              num_labels=10)
    op = openpose.OpenposeConfig(8)
    return (
        ("Depth", dpt.random_state_dict(d, 1),
         lambda sd, dev: dpt.convert_dpt(sd, d, dev),
         lambda p, x: dpt.dpt_apply(p, d, x), (1, 64, 96, 3)),
        ("Zoedepth", zoedepth.random_state_dict(z, 1),
         lambda sd, dev: zoedepth.convert_zoedepth(sd, z, dev),
         lambda p, x: zoedepth.zoedepth_apply(p, z, x)[0], (1, 64, 96, 3)),
        ("Semantic Segmentation", upernet.random_state_dict(u, 1),
         lambda sd, dev: upernet.convert_upernet(sd, u, dev),
         lambda p, x: upernet.upernet_apply(p, u, x), (1, 64, 96, 3)),
        ("Normal Map", normalbae.random_state_dict(n, 1),
         lambda sd, dev: normalbae.convert_nnet(sd, n, dev),
         lambda p, x: normalbae.nnet_apply(p, n, x), (1, 64, 64, 3)),
        ("Openpose", openpose.random_state_dict(op, 1),
         openpose.convert_openpose_body,
         lambda p, x: torch.cat(openpose.openpose_body_apply(p, x), -1),
         (1, 64, 48, 3)),
        ("Openpose (hand)", openpose.random_hand_state_dict(op, 1),
         openpose.convert_openpose_hand, openpose.openpose_hand_apply,
         (1, 64, 48, 3)),
        ("Openpose (face)", openpose.random_face_state_dict(op, 1),
         openpose.convert_openpose_face, openpose.openpose_face_apply,
         (1, 64, 48, 3)),
        ("Soft Edge", pidinet.random_state_dict(seed=1),
         pidinet.convert_pidinet, pidinet.pidinet_apply, (1, 64, 64, 3)),
        ("Soft Edge (HED)", hed.random_state_dict(
            hed.HEDConfig((8, 12, 16, 16, 24)), 1), hed.convert_hed,
         lambda p, x: hed.hed_apply(p, x)[0], (1, 48, 64, 3)),
        ("Lineart", lineart.random_state_dict(lineart.LineartConfig(8), 1),
         lineart.convert_lineart, lineart.lineart_apply, (1, 32, 48, 3)),
        ("Lineart (anime)", lineart_anime.random_state_dict(
            lineart_anime.LineartAnimeConfig(4), 1),
         lineart_anime.convert_lineart_anime,
         lineart_anime.lineart_anime_apply, (1, 256, 256, 3)),
        ("MLSD", mlsd.random_state_dict(mlsd.MLSDConfig(
            stem=8, stage_widths=(4, 6, 8, 8, 12), decoder=8), 1),
         mlsd.convert_mlsd, mlsd.mlsd_apply, (1, 64, 64, 4)),
    )


def _rel_err(card: torch.Tensor, host: torch.Tensor, name: str):
    """max |card - host| over max |host|; for NNET ("Normal Map") the
    largest such error outside the pixels whose refinement the two runs
    selected differently (a top-k over uncertainties that differ by
    rounding), and that share of the pixels."""
    card = card.float().cpu()
    diff = (card - host).abs() / host.abs().max().clamp_min(1e-12)
    if name != "Normal Map":
        return float(diff.max()), 0.0
    flipped = diff.amax(-1) > 1e-2
    return float(diff[~flipped].max()), float(flipped.float().mean())


def _event_ms(fn, reps: int = 3) -> float:
    """Median milliseconds of ``fn()`` between two CUDA events, after one
    warm-up call (the card's time from the first launch to the last
    kernel's end, the host's launch gaps included)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


TINY_DETECTOR_TOL = 1e-4  # card against CPU, of the output's max abs
SERVED_DETECTOR_TOL = 1e-4  # the same at published width, as served
CPU_BUDGET_S = 10.0  # the published widths' CPU runs held to the card


def phase_preprocess(ctx):
    """The control preprocessors on the card:

    1. every network at its small config of the CPU tests (fp32, TF32 off):
       the card against the port on the CPU, within
       ``TINY_DETECTOR_TOL`` of the output's largest value;
    2. every network at its published width (random weights from
       ``random_state_dict(cfg, seed=0)``, fp32) on its detector's input:
       the device ms (CUDA events, median of 3 after a warm-up), and the
       card against the CPU (a note where the CPU run takes over
       ``CPU_BUDGET_S``), as served (under ``strict_fp32``, within
       ``SERVED_DETECTOR_TOL`` of the output's largest value) and with
       PyTorch's default cuDNN TF32 (read, not bound); from here on the
       process-wide setting is PyTorch's default, TF32 on, as in a server;
    3. every name of the app's table through a ``ModelManager``'s
       ``get_preprocessor`` (the model-based ones at published width, the
       same random weights) on a 512^2 photo: the seconds to build, the
       wall ms a call, the output's shape and range, and the same output
       bit for bit with the process-wide TF32 off (the detector decides its
       precision);
    4. the slice's request, ``spatial_controlnet_depth``: SD1.5 at full
       width, the spatial request (512^2, the two-phrase map, 25 steps) with
       one ControlNet unit (random heads at ``HEAD_RMS``) whose
       ``preprocessor`` is "Depth" (DPT-Large), on the photo as a uint8
       nested list: ``inference()`` (one warm-up, then timed; exact UNet
       calls and K1/K2 launches, K2 as ``spatial_controlnet``), a POST
       /generate of the same payload whose PNG must equal ``inference()``'s
       bit for bit, and one profile by its kernels;
       The Depth detector alone is timed and profiled by its kernels;
    5. POST /preprocess of "Canny" and of "Openpose" with ``include_hand``,
       each PNG equal to the in-process detector's."""
    import base64

    from diffusionspatialcontrol_tpu_torch import sd15_config
    from diffusionspatialcontrol_tpu_torch.app import api
    from diffusionspatialcontrol_tpu_torch.app.server import (
        _inference_kwargs,
    )
    from diffusionspatialcontrol_tpu_torch.app.server import serve as http
    from diffusionspatialcontrol_tpu_torch.models._nets import strict_fp32
    from diffusionspatialcontrol_tpu_torch.ops import preprocess as pp
    from diffusionspatialcontrol_tpu_torch.runtime import native

    dev = ctx["device"]
    cudnn = torch.backends.cudnn
    # 1. the small configs, card against CPU
    t0 = time.perf_counter()
    worst = 0.0
    for name, sd, convert, apply, shape in _tiny_nets():
        x = torch.from_numpy(np.random.default_rng(0).uniform(
            -1, 1, shape).astype(np.float32))
        host = apply(convert(sd, "cpu"), x)
        card = apply(convert(sd, dev), x.to(dev))
        err, flipped = _rel_err(card, host, name)
        worst = max(worst, err)
        if not (err <= TINY_DETECTOR_TOL and flipped <= 1e-3):
            raise AssertionError(f"preprocess: {name} (small) on the card "
                                 f"{err:.3g} of max abs from the CPU "
                                 f"({flipped:.3g} of the pixels refined "
                                 f"otherwise)")
    log(f"preprocess: the 12 networks at their small configs on the card "
        f"within {worst:.3g} of their CPU runs (bound {TINY_DETECTOR_TOL}; "
        f"{time.perf_counter() - t0:.1f} s)")

    # 2. published widths: device ms, card against CPU; from here on the
    # process-wide flags are PyTorch's defaults (cuDNN's TF32 on), as in a
    # server, and a served detector turns TF32 off itself
    cudnn.allow_tf32 = True
    served = {"served": strict_fp32, "tf32": contextlib.nullcontext}
    t0 = time.perf_counter()
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    for name, draw, convert, apply, shape in _detector_nets():
        t_draw = time.perf_counter()
        sd = draw()
        n_params = sum(v.size for v in sd.values())
        p = convert(sd, dev)
        draw_s = time.perf_counter() - t_draw
        x = torch.from_numpy(np.random.default_rng(1).uniform(
            -1, 1, shape).astype(np.float32)).to(dev)
        out, ms = {}, {}
        for mode, precision in served.items():
            with precision():
                out[mode] = apply(p, x)
                ms[mode] = _event_ms(lambda: apply(p, x))
        if not all(bool(torch.isfinite(o).all()) for o in out.values()):
            raise AssertionError(f"preprocess: {name}: non-finite output")
        t_cpu = time.perf_counter()
        host = apply(convert(sd, "cpu"), x.cpu())
        cpu_s = time.perf_counter() - t_cpu
        errs = {mode: _rel_err(o, host, name) for mode, o in out.items()}
        if cpu_s > CPU_BUDGET_S:
            log(f"preprocess: {name}: the CPU run took {cpu_s:.1f} s (over "
                f"{CPU_BUDGET_S} s)")
        if not (errs["served"][0] <= SERVED_DETECTOR_TOL
                and errs["served"][1] <= 1e-3):
            raise AssertionError(f"preprocess: {name} on the card as served "
                                 f"{errs['served']} of max abs from the CPU "
                                 f"(bound {SERVED_DETECTOR_TOL})")
        log(f"preprocess: {name}: {n_params / 1e6:.1f} M parameters (drawn "
            f"and moved in {draw_s:.1f} s), input {shape}: "
            f"{ms['served']:.3f} ms on the card as served (TF32 off), "
            f"{ms['tf32']:.3f} ms with cuDNN's TF32; card against CPU (CPU "
            f"{cpu_s:.1f} s): {errs['served'][0]:.3g} as served (bound "
            f"{SERVED_DETECTOR_TOL}), {errs['tf32'][0]:.3g} with TF32 of max "
            f"abs {float(host.abs().max()):.3g}"
            + (f" (pixels refined otherwise: {errs['served'][1]:.3g}, "
               f"{errs['tf32'][1]:.3g})" if name == "Normal Map" else "")
            + f"; output {tuple(out['served'].shape)}")
        del p, out, host
    torch.set_num_threads(threads)
    torch.cuda.empty_cache()
    log(f"preprocess: the networks at published width in "
        f"{time.perf_counter() - t0:.1f} s (card: {card_line()})")

    # 3. the app's table through the manager, on a 512^2 photo
    t0 = time.perf_counter()
    photo = (synthetic_image(DETECT_SIDE, 11)[0] * 127.5 + 127.5).astype(
        np.uint8)
    manager = api.ModelManager()
    from diffusionspatialcontrol_tpu_torch.models import (
        dpt, normalbae, upernet, zoedepth)

    for name, cfg in (("Depth", dpt.DPTConfig()),
                      ("Zoedepth", zoedepth.ZoeDepthConfig()),
                      ("Semantic Segmentation", upernet.UperNetConfig()),
                      ("Normal Map", normalbae.NormalBaeConfig())):
        manager.register_preprocessor(name, cfg=cfg)
    outs = {}
    for name in list(pp.NATIVE_PREPROCESSORS) + list(
            pp.NATIVE_MODEL_PREPROCESSORS):
        tb = time.perf_counter()
        fn = manager.get_preprocessor(name)
        opts = {"include_hand": True, "include_face": True} \
            if name == "Openpose" else {}
        out = fn(photo, **opts)  # the first call: warm-up
        build_s = time.perf_counter() - tb
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            tw = time.perf_counter()
            out = fn(photo, **opts)
            walls.append(1e3 * (time.perf_counter() - tw))
        outs[name] = out
        cudnn.allow_tf32 = False
        same = np.array_equal(fn(photo, **opts), out)
        cudnn.allow_tf32 = True
        if not same:
            raise AssertionError(f"preprocess: {name}: the output changes "
                                 f"with the process-wide TF32 setting")
        if out.shape != (DETECT_SIDE, DETECT_SIDE, 3) or \
                out.dtype != np.float32 or not np.isfinite(out).all() or \
                out.min() < 0.0 or out.max() > 1.0:
            raise AssertionError(f"preprocess: {name}: output {out.shape} "
                                 f"{out.dtype} [{out.min()}, {out.max()}]")
        log(f"preprocess: {name!r}{' (hand and face)' if opts else ''}: "
            f"built and first call {build_s:.2f} s, then "
            f"{np.median(walls):.1f} ms a call (wall), output "
            f"{out.shape} in [{out.min():.3f}, {out.max():.3f}], mean "
            f"{out.mean():.3f}, the same with TF32 off process-wide")
    log(f"preprocess: {len(outs)} detectors through the manager in "
        f"{time.perf_counter() - t0:.1f} s")

    # 4. the slice's request
    cfg = sd15_config()
    t0 = time.perf_counter()
    manager.register_random("sd15", cfg, seed=0)
    _with_text_bias(manager._cache["sd15"], 0)
    manager._controlnets["Depth"] = unit_controlnet(
        cfg.unet, 1, dev, torch.bfloat16, HEAD_RMS)
    server = http(manager, port=0, block=False)
    port = server.server_address[1]
    side = DETECT_SIDE  # the request's size, the photo's
    state = _masks(side, side)
    base = {"prompt": PROMPT, "neg_prompt": NEG, "model": "sd15",
            "sampler": "DPM++ 2M Karras", "steps": STEPS, "cfg_scale": 7.5,
            "width": side, "height": side, "seed": 0, "encoding_mode": "short",
            "region_state": _json_state(state)}
    payload = {**base, "controlnet_units": [{
        "model": "Depth", "image": photo.tolist(), "preprocessor": "Depth"}]}
    kwargs = _inference_kwargs(payload)
    want = want_launches(cfg, side, STEPS, True, "xla", controlnets=1)
    log(f"preprocess: SD1.5 and a ControlNet with random heads on the "
        f"manager, the server on port {port}, in "
        f"{time.perf_counter() - t0:.1f} s")
    _reset_counts()
    seconds, images = [], None
    for i, seed in enumerate((0, 1, 2, 3)):
        before = _counts()
        torch.cuda.synchronize()
        tr = time.perf_counter()
        with UNetCalls() as n:
            out = api.inference(manager, **{**kwargs, "seed": seed})
        dt = time.perf_counter() - tr
        launches = _delta(_counts(), before)
        if n.n != STEPS or launches != want:
            raise AssertionError(f"preprocess: spatial_controlnet_depth seed "
                                 f"{seed}: {n.n} UNet calls, launches "
                                 f"{launches}; expected {STEPS}, {want}")
        if out["images"].shape != (1, side, side, 3):
            raise AssertionError(f"preprocess: images {out['images'].shape}")
        if seed == 0:
            images = out["images"]
        if i:
            seconds.append(dt)
        log(f"preprocess: spatial_controlnet_depth seed {seed}: {dt:.3f} s"
            f"{' (warm-up)' if i == 0 else ''}, {n.n} UNet calls, launches "
            f"{ {k: v for k, v in launches.items() if v} }")
    direct = _counts()
    totals = ctx.setdefault("launches", {})
    for k, v in direct.items():
        totals[k] = totals.get(k, 0) + v
    if not (direct["K1"] and direct["K2"]):
        raise AssertionError("preprocess: K1 or K2 never launched")
    p50 = float(np.median(seconds))
    ctx.setdefault("p50", {})["spatial_controlnet_depth"] = p50
    before = _counts()
    with UNetCalls() as n:
        status, body, http_s = _http(port, "/generate", payload)
    launches = _delta(_counts(), before)
    if status != 200 or n.n != STEPS or launches != want:
        raise AssertionError(f"preprocess: POST /generate {status}, {n.n} "
                             f"UNet calls, launches {launches}")
    if base64.b64decode(body["images"][0]) != native.encode_png(images[0]):
        raise AssertionError(
            "preprocess: the POST's PNG differs from inference()'s "
            f"(max abs {np.abs(_pngs(body)[0].astype(int) - images[0]).max()}"
            f")")
    _, plain, _ = _http(port, "/generate", base)
    moved = int(np.abs(_pngs(plain)[0].astype(int) - images[0]).max())
    if moved == 0:
        raise AssertionError("preprocess: the Depth unit left the spatial "
                             "image as it was")
    log(f"preprocess: spatial_controlnet_depth p50 {p50:.4f} s/image "
        f"(inference(), after one warm-up); POST /generate {http_s:.3f} s, "
        f"its PNG inference()'s bit for bit; max abs {moved} from the "
        f"spatial image on uint8; launches a request {want}")
    depth_fn = manager.get_preprocessor("Depth")
    depth_ms = _event_ms(lambda: depth_fn(photo))
    log(f"preprocess: the Depth detector alone (DPT-Large, 512^2 -> 384^2 "
        f"-> 512^2): {depth_ms:.3f} ms on the card (CUDA events)")
    profile_request(lambda: torch.from_numpy(depth_fn(photo)),
                    "Depth detector", depth_ms / 1e3, host_ops=False)

    # 5. /preprocess
    for name, opts in (("Canny", {}), ("Openpose", {"include_hand": True})):
        status, body, dt = _http(port, "/preprocess", {
            "image": photo.tolist(), "preprocessor": name, "options": opts})
        want_map = manager.get_preprocessor(name)(photo, **opts)
        want_png = native.encode_png(np.round(want_map * 255).astype(
            np.uint8))
        if status != 200 or base64.b64decode(body["image"]) != want_png:
            raise AssertionError(f"preprocess: POST /preprocess {name}: "
                                 f"{status} {str(body)[:200]}")
        log(f"preprocess: POST /preprocess {name} {opts}: {dt:.3f} s, its "
            f"PNG the in-process detector's bit for bit")
    server.shutdown()
    server.server_close()
    profile_request(lambda: torch.from_numpy(api.inference(
        manager, **{**kwargs, "seed": 99})["images"]),
        "spatial_controlnet_depth", p50, host_ops=False)
    cudnn.allow_tf32 = False
    del manager
    torch.cuda.empty_cache()


LORA_RANK = 8
TI_WORD = "sksstyle"  # the textual-inversion file's trigger word
PLUS_DEPTH = 4  # the published ip-adapter-plus_sd15's Resampler layers


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def _leaves(tree, path=""):
    """(path, tensor) of every tensor of ``tree``, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k, v in sorted(tree.items())
                for x in _leaves(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{path}/{i}")]
    return [] if tree is None else [(path, tree)]


def _as_stored(t: torch.Tensor) -> torch.Tensor:
    """What a tensor becomes when written in fp16 and loaded in bf16: fp32
    -> fp16 -> fp32 -> bf16, each rounding to nearest even; a 4-d one with
    the strides the converter gives it (channels_last, 1x1 kernels too)."""
    out = torch.empty(t.shape, dtype=torch.bfloat16, device=t.device,
                      memory_format=torch.channels_last if t.dim() == 4
                      else torch.contiguous_format)
    return out.copy_(t.to(torch.float16).float())


def _check_tree(what, got, want, extra_rows=0):
    """``got`` equals ``want`` leaf for leaf, bit for bit (the token table
    may carry ``extra_rows`` zero rows); returns the number of leaves."""
    gl, wl = _leaves(got), _leaves(want)
    if [p for p, _ in gl] != [p for p, _ in wl]:
        raise AssertionError(f"weights: {what}: the trees differ in shape")
    for (p, a), (_, b) in zip(gl, wl):
        if p.endswith("token_embedding") and extra_rows:
            if a.shape[0] != b.shape[0] + extra_rows or \
                    bool(a[b.shape[0]:].any()):
                raise AssertionError(f"weights: {what}: {p} has no "
                                     f"{extra_rows} zero rows")
            a = a[:b.shape[0]]
        if a.dtype != b.dtype or a.shape != b.shape or \
                not torch.equal(a, b):
            raise AssertionError(f"weights: {what}: {p} differs")
        if a.dim() == 4 and not a.is_contiguous(
                memory_format=torch.channels_last):
            raise AssertionError(f"weights: {what}: {p} is not "
                                 f"channels_last")
    return len(gl)


def lora_for(params, rank: int, seed: int) -> dict:
    """A kohya LoRA (name -> fp16 numpy) of rank ``rank`` on every
    attention linear, ``ff``, ``proj_in``/``proj_out`` (1x1 convs on SD1.5)
    and the resnets' 3x3 convs of the UNet, and every linear of the text
    encoder; down ~ N(0, 1/fan_in), up ~ N(0, 0.02^2)."""
    from diffusionspatialcontrol_tpu_torch.convert import lora

    rng = np.random.default_rng(seed)
    out = {}
    for prefix, index, tree in (
            ("lora_unet", lora._module_index(params["unet"]), params["unet"]),
            ("lora_te", lora._clip_module_index(params["clip"]),
             params["clip"])):
        for name, path in sorted(index.items()):
            last = name.rsplit(".", 1)[-1]
            if prefix == "lora_unet" and not (
                    ".attn" in name or ".ff." in name
                    or last in ("proj_in", "proj_out")
                    or (".resnets." in name and last in ("conv1", "conv2"))):
                continue
            k = lora._get(tree, path)["kernel"]
            o, i = k.shape[:2]
            tail = tuple(k.shape[2:])
            fan_in = i * int(np.prod(tail, dtype=np.int64))
            mod = f"{prefix}_{lora._normalize(name)}"
            out[f"{mod}.lora_down.weight"] = (rng.standard_normal(
                (rank, i) + tail) / np.sqrt(fan_in)).astype(np.float16)
            out[f"{mod}.lora_up.weight"] = (0.02 * rng.standard_normal(
                (o, rank) + ((1, 1) if tail else ()))).astype(np.float16)
            out[f"{mod}.alpha"] = np.array(rank, np.float16)
    return out


def host_lora_merge(kernel, up, down, scale):
    """The JAX package's merge arithmetic (``convert/lora.py``: numpy fp32
    in its HWIO / (in, out) layouts, one cast to the leaf's dtype), back in
    the port's layouts: the reference a merged leaf is held to."""
    w = kernel.float().cpu().numpy()
    w = w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T
    if up.ndim == 4:
        up2 = up.reshape(up.shape[0], up.shape[1])
        if down.shape[2:] == (1, 1):
            delta = (up2 @ down.reshape(down.shape[0], down.shape[1])
                     ).T[None, None]
        else:
            delta = np.einsum("or,rihw->oihw", up2, down).transpose(
                2, 3, 1, 0)
    else:
        delta = (up @ down).T
    new = w + scale * delta
    new = new.transpose(3, 2, 0, 1) if new.ndim == 4 else new.T
    return torch.from_numpy(np.ascontiguousarray(new)).to(kernel.dtype)


def plus_state_dict(unet_cfg, embed_dim: int, depth: int, seed: int):
    """An "IP-Adapter Plus" file's groups: ``random_state_dict``'s layout
    (the JAX package's numpy draws) with the Resampler grown to ``depth``
    layers, the added layers drawn like its first."""
    from diffusionspatialcontrol_tpu_torch.models import ip_adapter as ipa

    sd = ipa.random_state_dict(unet_cfg, "resampler", seed=seed,
                               embed_dim=embed_dim)
    proj, rng = sd["image_proj"], np.random.default_rng(seed + 1)
    for i in range(2, depth):
        for k in [k for k in proj if k.startswith("layers.0.")]:
            v = proj[k]
            proj[f"layers.{i}." + k[len("layers.0."):]] = (
                v if v.std() == 0 else 0.02 * rng.standard_normal(v.shape)
            ).astype(np.float32)
    return sd


def _maxrss_gb() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def phase_weights(ctx):
    """Weights from disk at full width: a diffusers checkpoint of SD1.5
    (random weights drawn in fp32 from seed 0, written in fp16, the
    published dtype, by the port's own safetensors writer; no tokenizer/,
    so the hash tokenizer reads the prompts as everywhere here) loaded by
    ``ModelManager.register`` + ``get`` in bf16, by ``cached_convert``
    (convert and snapshot, then restore) and by a server started with
    ``--model``. Every loaded leaf must equal the drawn tree after fp32 ->
    fp16 -> bf16 bit for bit; the spatial request (512^2, 25 DPM++ 2M
    Karras steps, CFG 7.5, the two-phrase map) through ``inference()`` must
    give the PNG of the same request on that tree given to the manager
    directly, bit for bit, and so must the POST. Then, on the loaded tree:
    the spatial request timed, a ``"pallas2"`` request (K5 on the converted
    kernels); a kohya LoRA of rank 8 (every attention linear, ff,
    proj_in/proj_out, the resnets' 3x3 convs and the text encoder's
    linears) and a 2-vector textual-inversion file merged by
    ``get_variant`` (every merged leaf equal to the host numpy merge at the
    leaf's dtype, the base tree unchanged) serving the spatial request with
    the trigger word; an "IP-Adapter Plus" file with the published depth-4
    Resampler (``spatial_ip_plus_masked`` from the file, through the
    manager's ViT-H/14 tower) and a ControlNet file (its leaves checked,
    its image equal to the drawn ControlNet's); and the spatial request on
    the loaded values with the random init's strides for the 1x1 kernels,
    profiled beside the loaded tree's at the end. Prints the seconds to write
    and read each file, to convert and restore, the host's peak RSS and the
    card's peak allocation, and the requests' p50s; the files go into a
    temporary directory that is removed at the end."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_weights_")
    try:
        _weights(ctx, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _weights(ctx, root):
    import base64

    from diffusionspatialcontrol_tpu_torch import GenerationConfig, sd15_config
    from diffusionspatialcontrol_tpu_torch.app import api
    from diffusionspatialcontrol_tpu_torch.app import server as srv_mod
    from diffusionspatialcontrol_tpu_torch.convert import cache, lora
    from diffusionspatialcontrol_tpu_torch.convert.safetensors import (
        load_file,
        save_file,
    )
    from diffusionspatialcontrol_tpu_torch.models.factory import (
        init_pipeline_params,
        param_count,
    )
    from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import (
        StableDiffusionTorch,
        to_uint8,
    )
    from diffusionspatialcontrol_tpu_torch.runtime import native
    from diffusionspatialcontrol_tpu_torch.text.tokenizer import load_tokenizer

    cfg, dev = sd15_config(), ctx["device"]
    for key in ("launches", "p50", "seconds"):
        ctx.setdefault(key, {})
    t_phase = time.perf_counter()
    # 1. the drawn tree, written as a diffusers directory in fp16
    t0 = time.perf_counter()
    drawn = _with_text_bias(init_pipeline_params(0, cfg, torch.float32), 0)
    torch.cuda.synchronize()
    n_params = param_count(drawn)
    log(f"weights: SD1.5 {n_params / 1e6:.1f} M parameters drawn in fp32 "
        f"(seed 0) in {time.perf_counter() - t0:.1f} s")
    ckpt = os.path.join(root, "sd15")
    write_s = write_diffusers_checkpoint(drawn, ckpt)
    files = {sub: os.path.join(ckpt, sub, name) for sub, name in (
        ("unet", "diffusion_pytorch_model.safetensors"),
        ("vae", "diffusion_pytorch_model.safetensors"),
        ("text_encoder", "model.safetensors"))}
    expected = _tree_map(_as_stored, drawn)
    del drawn
    torch.cuda.empty_cache()
    for sub, path in files.items():
        size = os.path.getsize(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tensors = load_file(path)
        mapped = time.perf_counter() - t0
        on_card = [t.to(dev) for t in tensors.values()]
        torch.cuda.synchronize()
        read = time.perf_counter() - t0
        del tensors, on_card
        log(f"weights: {sub}: {size / 1e9:.3f} GB written in "
            f"{write_s[sub]:.2f} s ({size / 1e9 / write_s[sub]:.2f} GB/s), "
            f"read to the card in {read:.2f} s ({size / 1e9 / read:.2f} "
            f"GB/s; the header and map {1e3 * mapped:.1f} ms)")
    # 2. loaded by the manager, by cached_convert and by the server
    torch.cuda.reset_peak_memory_stats()
    alloc0 = torch.cuda.memory_allocated()
    manager = api.ModelManager()
    manager.register("sd15-disk", ckpt, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, loaded, tok = manager.get("sd15-disk")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_leaves = _check_tree("ModelManager.get", loaded, expected,
                           extra_rows=64)
    log(f"weights: ModelManager.get (load_pipeline_params, bf16, 64 spare "
        f"embedding rows): {load_s:.2f} s, {n_leaves} leaves equal to the "
        f"drawn tree after fp32 -> fp16 -> bf16, bit for bit; the card's "
        f"peak allocation over it "
        f"{(torch.cuda.max_memory_allocated() - alloc0) / 1e9:.2f} GB above "
        f"the {alloc0 / 1e9:.2f} GB before; host peak RSS "
        f"{_maxrss_gb():.2f} GB; tokenizer {type(tok).__name__}")
    snap_dir = os.path.join(root, "cache")
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = cache.cached_convert(ckpt, snap_dir, cfg, torch.bfloat16)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        _check_tree("cached_convert", tree, expected, extra_rows=64)
        del tree
    snap = os.path.join(snap_dir, f"sd15-{cfg.name}")
    log(f"weights: cached_convert: convert and snapshot "
        f"({os.path.getsize(snap) / 1e9:.3f} GB) {times[0]:.2f} s, restore "
        f"{times[1]:.2f} s; both trees equal the drawn one")
    os.remove(snap)
    torch.cuda.empty_cache()
    # 3. the spatial request: inference() on the loaded and on the drawn
    # tree, the POST, then the pipeline on the loaded tree, timed
    manager._dirs["sd15-drawn"] = ("", cfg)
    manager._cache["sd15-drawn"] = expected
    manager._tokenizers["sd15-drawn"] = load_tokenizer()
    state = _masks(512, 512)
    req = dict(prompt=PROMPT, neg_prompt=NEG, sampler="DPM++ 2M Karras",
               steps=STEPS, cfg_scale=7.5, width=512, height=512, seed=0,
               encoding_mode="short")
    pngs = {m: native.encode_png(api.inference(
        manager, model=m, region_state=state, **req)["images"][0])
        for m in ("sd15-disk", "sd15-drawn")}
    if pngs["sd15-disk"] != pngs["sd15-drawn"]:
        raise AssertionError("weights: the loaded checkpoint's PNG differs "
                             "from the drawn tree's")
    srv_manager = srv_mod.build_manager_from_args(srv_mod.parse_args(
        ["--model", f"sd15-http={ckpt}"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv_manager.get("sd15-http")
    torch.cuda.synchronize()
    srv_load = time.perf_counter() - t0
    server = srv_mod.serve(srv_manager, port=0, block=False)
    try:
        status, out, dt = _http(server.server_address[1], "/generate", {
            **req, "model": "sd15-http", "region_state": _json_state(state)})
    finally:
        server.shutdown()
        server.server_close()
    if status != 200 or base64.b64decode(out["images"][0]) != \
            pngs["sd15-disk"]:
        raise AssertionError(f"weights: the POST on a server started with "
                             f"--model gave HTTP {status} and another PNG")
    del srv_manager, server
    torch.cuda.empty_cache()
    log(f"weights: the spatial PNG ({len(pngs['sd15-disk'])} bytes) equal "
        f"bit for bit from the loaded checkpoint and the drawn tree by "
        f"inference(), and over HTTP from a server started with --model "
        f"(its load {srv_load:.2f} s, the POST {dt:.2f} s)")
    gen = GenerationConfig(height=512, width=512, num_inference_steps=STEPS,
                           guidance_scale=7.5, sampler="dpmpp_2m",
                           schedule="karras")
    pipe = StableDiffusionTorch(cfg, loaded, tokenizer=tok)
    c1, ids1 = pipe.encode_prompt([PROMPT], [NEG], clip_skip=2)
    rb1 = pipe.encode_region([state], ids1, height=512, width=512)
    spatial = want_launches(cfg, 512, STEPS, True, "xla")
    serve(ctx, "weights_spatial",
          lambda seed: pipe.txt2img(c1, gen, seed=seed, region_biases=rb1),
          [0, 1, 2, 3], STEPS, spatial, 512)
    pipe2 = StableDiffusionTorch(cfg, loaded, tokenizer=tok,
                                 conv_impl="pallas2")
    serve(ctx, "weights_pallas2",
          lambda seed: pipe2.txt2img(c1, gen, seed=seed, region_biases=rb1),
          [0, 1], STEPS, want_launches(cfg, 512, STEPS, True, "pallas2"), 512)
    plain = to_uint8(pipe.txt2img(c1, gen, seed=0, region_biases=rb1)).cpu()
    # 4. a LoRA and a textual-inversion file through get_variant
    t0 = time.perf_counter()
    lora_sd = lora_for(loaded, LORA_RANK, seed=5)
    lora_path = os.path.join(root, "style_lora.safetensors")
    save_file(lora_sd, lora_path)
    ti_path = os.path.join(root, "sksstyle.safetensors")
    vecs = (0.02 * np.random.default_rng(6).standard_normal(
        (2, cfg.clip.hidden_size))).astype(np.float16)
    save_file({TI_WORD: vecs}, ti_path)
    lora_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, variant, vtok = manager.get_variant(
        "sd15-disk", loras=[(lora_path, 0.8)], ti_embeddings=[ti_path])
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    _check_tree("the base tree after get_variant", loaded, expected,
                extra_rows=64)
    t0 = time.perf_counter()
    merged = 0
    for prefix, index, tree, base in (
            ("lora_unet", lora._module_index(variant["unet"]),
             variant["unet"], loaded["unet"]),
            ("lora_te", lora._clip_module_index(variant["clip"]),
             variant["clip"], loaded["clip"])):
        for name, path in index.items():
            mod = f"{prefix}_{lora._normalize(name)}"
            got = lora._get(tree, path)["kernel"]
            old = lora._get(base, path)["kernel"]
            if f"{mod}.lora_up.weight" not in lora_sd:
                if got is not old:
                    raise AssertionError(f"weights: {name} was not in the "
                                         f"LoRA but was replaced")
                continue
            want = host_lora_merge(
                old, lora_sd[f"{mod}.lora_up.weight"].astype(np.float32),
                lora_sd[f"{mod}.lora_down.weight"].astype(np.float32), 0.8)
            if got is old or not torch.equal(got.cpu(), want) or (
                    got.dim() == 4 and not got.is_contiguous(
                        memory_format=torch.channels_last)):
                raise AssertionError(f"weights: the merged {name} differs "
                                     f"from the host numpy merge")
            merged += 1
    if merged != sum(k.endswith("lora_up.weight") for k in lora_sd):
        raise AssertionError(f"weights: {merged} leaves merged")
    table = variant["clip"]["token_embedding"]
    ids = vtok.encode(f"{PROMPT}, {TI_WORD}")
    v = cfg.clip.vocab_size
    if ids[-3:-1] != [v, v + 1] or not torch.equal(
            table[v:v + 2].cpu(), torch.from_numpy(vecs).to(table.dtype)):
        raise AssertionError(f"weights: the TI vectors are not in the "
                             f"table ({ids[-4:]})")
    log(f"weights: a rank-{LORA_RANK} kohya LoRA of {merged} modules "
        f"({os.path.getsize(lora_path) / 1e6:.1f} MB fp16) and a 2-vector "
        f"TI file written in {lora_s:.2f} s; get_variant merged them in "
        f"{merge_s:.2f} s; every merged leaf equal to the host numpy merge "
        f"(checked in {time.perf_counter() - t0:.1f} s), the rest and the "
        f"base tree unchanged, '{TI_WORD}' -> ids {ids[-3:-1]}")
    vpipe = StableDiffusionTorch(cfg, variant, tokenizer=vtok)
    cv, idsv = vpipe.encode_prompt([f"{PROMPT}, {TI_WORD}"], [NEG],
                                   clip_skip=2)
    rbv = vpipe.encode_region([state], idsv, height=512, width=512)
    serve(ctx, "weights_lora_ti",
          lambda seed: vpipe.txt2img(cv, gen, seed=seed, region_biases=rbv),
          [0, 1, 2], STEPS, spatial, 512)
    moved = int((to_uint8(vpipe.txt2img(cv, gen, seed=0, region_biases=rbv))
                 .cpu().int() - plain.int()).abs().max())
    if moved == 0:
        raise AssertionError("weights: the LoRA and TI left the image as it "
                             "was")
    # 5. an IP-Adapter Plus file of depth 4 and a ControlNet file
    enc_cfg, _ = manager.get_image_encoder()
    ip_sd = plus_state_dict(cfg.unet, enc_cfg.hidden_size, PLUS_DEPTH, 0)
    ip_path = os.path.join(root, "ip-adapter-plus_sd15.safetensors")
    t0 = time.perf_counter()
    save_file({f"{g}.{k}": v for g in ip_sd for k, v in ip_sd[g].items()},
              ip_path)
    ip_write = time.perf_counter() - t0
    ref = synthetic_image(512, 7)[0] * 0.5 + 0.5
    mask = right_half_mask(512)[0]
    units = [api.IPAdapterUnit(ip_path, ref, mask=mask)]
    ip_pipe, ads = ip_pipeline(manager, loaded, cfg, units, dev,
                               torch.bfloat16)
    if ads[0].variant != "resampler" or \
            len(ads[0].proj_params["layers"]) != PLUS_DEPTH:
        raise AssertionError("weights: the Plus file gave no depth-4 "
                             "Resampler")
    log(f"weights: IP-Adapter Plus file ({os.path.getsize(ip_path) / 1e6:.1f}"
        f" MB, written in {ip_write:.2f} s): a {PLUS_DEPTH}-layer Resampler, "
        f"{ads[0].num_tokens} tokens")

    def run_ip(seed):
        return ip_pipe.txt2img(c1, gen, seed=seed, region_biases=rb1,
                               extras=ip_extras(manager, ip_pipe, units, ads))

    serve(ctx, "weights_ip_plus4_masked", run_ip, [0, 1, 2], STEPS,
          want_launches(cfg, 512, STEPS, True, "xla", ip_adapters=1,
                        ip_once=ip_tower_launches(
                            "resampler", enc_cfg.num_layers,
                            resampler_layers=PLUS_DEPTH)),
          512, strict=True)
    defer_profile(ctx, lambda: run_ip(99), "weights_ip_plus4_masked")
    cn_drawn = unit_controlnet(cfg.unet, 1, dev, torch.float32, HEAD_RMS)
    cn_dir = os.path.join(root, "controlnet")
    os.makedirs(cn_dir)
    cn_file = os.path.join(cn_dir, "diffusion_pytorch_model.safetensors")
    t0 = time.perf_counter()
    save_file({k: v.to(torch.float16) for k, v in
               diffusers_state_dict(cn_drawn).items()}, cn_file)
    cn_write = time.perf_counter() - t0
    cn_expected = _tree_map(_as_stored, cn_drawn)
    del cn_drawn
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cn = manager.get_controlnet(cn_dir, cfg.unet)
    torch.cuda.synchronize()
    cn_load = time.perf_counter() - t0
    n_cn = _check_tree("the ControlNet file", cn, cn_expected)
    image = synthetic_image(512, 7) * 0.5 + 0.5

    def run_cn(seed, net=cn):
        return pipe.txt2img(c1, gen, seed=seed, region_biases=rb1,
                            extras=pipe.build_controlnet_extras(
                                gen, [net], [image], scales=[1.0]))

    serve(ctx, "weights_controlnet", run_cn, [0, 1], STEPS,
          want_launches(cfg, 512, STEPS, True, "xla", controlnets=1), 512,
          strict=True)
    if not torch.equal(to_uint8(run_cn(0)), to_uint8(run_cn(0, cn_expected))):
        raise AssertionError("weights: the ControlNet file's image differs "
                             "from the drawn ControlNet's")
    log(f"weights: ControlNet file ({os.path.getsize(cn_file) / 1e9:.3f} GB "
        f"fp16, written in {cn_write:.2f} s, loaded in {cn_load:.2f} s): "
        f"{n_cn} leaves equal to the drawn ones, its image equal to theirs")
    # 6. the loaded tree's layouts against the random init's: a converted
    # 1x1 kernel has channels_last strides, the init's the contiguous ones
    # (either tensor is contiguous in both formats, so .contiguous() keeps
    # its strides: a copy into a fresh tensor sets them); the same values
    # in both, profiled at the end of the run
    init_strides = _tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)
        if t.dim() == 4 and t.shape[2:] == (1, 1) else t, loaded)
    k = init_strides["unet"]["down_blocks"][0]["attentions"][0]["proj_in"][
        "kernel"]
    if k.stride() != (k.shape[1], 1, 1, 1):
        raise AssertionError(f"weights: a 1x1 kernel's strides {k.stride()}")
    pipe_i = StableDiffusionTorch(cfg, init_strides, tokenizer=tok)
    serve(ctx, "weights_spatial_init_strides",
          lambda seed: pipe_i.txt2img(c1, gen, seed=seed, region_biases=rb1),
          [0, 1, 2], STEPS, spatial, 512)
    same = torch.equal(to_uint8(pipe_i.txt2img(c1, gen, seed=0,
                                               region_biases=rb1)).cpu(),
                       plain)
    log(f"weights: the loaded tree with the init's 1x1-kernel strides gives "
        f"{'the same' if same else 'another'} uint8 image")
    defer_profile(ctx, lambda: pipe.txt2img(c1, gen, seed=99,
                                            region_biases=rb1),
                  "weights_spatial")
    log(f"weights: p50 s/image after one warm-up: " + ", ".join(
        f"{k} {ctx['p50'][k]:.4f}" for k in (
            "weights_spatial", "weights_pallas2", "weights_lora_ti",
            "weights_ip_plus4_masked", "weights_controlnet",
            "weights_spatial_init_strides"))
        + f"; host peak RSS {_maxrss_gb():.2f} GB, the card's peak "
        f"allocation {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; the "
        f"phase's requests served and checked in "
        f"{time.perf_counter() - t_phase:.1f} s (card: {card_line()})")


KERNEL_GROUPS = (  # (group, test on the lower-cased kernel name)
    # both attention bodies carry HAS_BIAS among their template arguments
    ("K1", lambda n: "dsc::attention" in n and "true" in n),
    ("K2", lambda n: "dsc::attention" in n and "false" in n),
    ("K4", lambda n: "conv_mma_kernel" in n or "conv_direct_kernel" in n),
    ("K5", lambda n: "conv_wgmma_kernel" in n or "conv_igemm_kernel" in n),
    ("conv", lambda n: "conv" in n or "fprop" in n or "dgrad" in n),
    ("gemm", lambda n: "gemm" in n or "nvjet" in n or "cutlass" in n),
    ("norm", lambda n: "norm" in n),
    ("other", lambda n: True),
)


def defer_profile(ctx, run, kind, host_ops=False):
    """Queue a ``profile_request`` of ``run`` for the end of the run, beside
    the p50 that ``serve`` records for ``kind``. A torch.profiler run (with
    the host's ops most of all) leaves the host slower at launching for the
    rest of the process (PERF.md), so every timed request comes before the
    first profile."""
    ctx.setdefault("profiles", []).append((run, kind, host_ops))


def run_deferred_profiles(ctx):
    """The queued profiles; then the first profiled request type is timed
    again (p50 of 4 after a warm-up) beside its p50 from before them: the
    profiler's after-effect on the host."""
    from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import to_uint8

    profiles = ctx.pop("profiles", [])
    t0 = time.perf_counter()
    skipped = []
    for run, kind, host_ops in profiles:
        if time.perf_counter() - ctx["t_start"] > PROFILE_DEADLINE_S:
            skipped.append(kind)
            continue
        profile_request(run, kind, ctx["p50"][kind], host_ops=host_ops)
    log(f"profiles: {len(profiles) - len(skipped)} requests profiled in "
        f"{time.perf_counter() - t0:.1f} s"
        + (f"; not profiled, past {PROFILE_DEADLINE_S:.0f} s since the "
           f"start: {', '.join(skipped)}" if skipped else ""))
    for fn in ctx.pop("deferred", []):
        fn()
    run, kind, _ = profiles[0]
    seconds = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        to_uint8(run()).cpu()
        seconds.append(time.perf_counter() - t0)
    log(f"profiles: {kind} timed again after them: p50 "
        f"{np.median(seconds[1:]):.4f} s/image against "
        f"{ctx['p50'][kind]:.4f} before the first profile")


def profile_request(run, kind, p50_s, host_ops=True):
    """One batch-1 request, ``run()`` (fp32 images) and their uint8 copy to
    the host, under torch.profiler: the device's busy time (sum
    of kernel times) against the request's unprofiled p50 wall time, kernel
    launches, and device time by kernel group and by kernel. The profiler's
    own cost on the host inflates the profiled wall time, so the busy share
    is taken against the p50. With ``host_ops`` the host's ops are
    recorded too; without, the kernels only, which take a third of the
    time to collect and sum. The spatial request is profiled both ways in
    each run, to hold the two busy times together (PERF.md). The log line
    gives the seconds the profile took."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diffusionspatialcontrol_tpu_torch.pipeline.pipeline import to_uint8

    torch.cuda.synchronize()
    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if host_ops else [])) as prof:
        t0 = time.perf_counter()
        to_uint8(run()).cpu()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError(f"profile: {kind}: no device time recorded")
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    count = sum(e.count for e in kernels)
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    for e in kernels:
        name = e.key.lower()
        group = next(g for g, test in KERNEL_GROUPS if test(name))
        groups[group] += e.self_device_time_total / 1e3
    log(f"profile: {kind}{'' if host_ops else ' (kernels only)'}: device "
        f"busy {busy_ms:.1f} ms = "
        f"{100 * busy_ms / (1e3 * p50_s):.1f}% of the p50 wall "
        f"({1e3 * p50_s:.1f} ms; {wall_ms:.1f} ms profiled), {count} kernel "
        f"launches; by group (ms): " + ", ".join(
            f"{g} {t:.1f}" for g, t in groups.items())
        + f"; profiled and summed in {time.perf_counter() - t_all:.1f} s")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log(f"profile: {kind}:   {e.self_device_time_total / 1e3:8.2f} ms "
            f"x{e.count:<5d} {e.key[:110]}")


KERNEL_LINE = {  # name, source, what "ms" and the other times are per
    "K1": ("K1 region_attention", "region_attention.cu",
           "the 16 launches of one SD1.5 512^2 UNet call on the spatial "
           "path, bf16, cold L2; library = scaled_dot_product_attention"),
    "K2": ("K2 flash_attention", "flash_attention.cu",
           "the 16 self-attention launches of one SD1.5 512^2 UNet call, "
           "bf16, cold L2; library = scaled_dot_product_attention"),
    "K3": ("K3 flash_attention at the streaming shapes", "flash_attention.cu",
           "one launch at B=2, L=S=16384, H=8, D=40 (the hires pass's "
           "level-0 self-attention), bf16, cold L2; launches = K2's at that "
           "shape; library = scaled_dot_product_attention"),
    "K4": ("K4 conv_fused", "conv_fused.cu",
           "the 44 launches of one SD1.5 512^2 UNet call, bf16, cold L2; "
           "library = cuDNN conv2d+bias on the pre-activated input"),
    "K5": ("K5 conv_fused_v2", "conv_fused_v2.cu",
           "the 44 launches of one SD1.5 512^2 UNet call, bf16, cold L2; "
           "library = cuDNN conv2d+bias on the pre-activated input"),
}


def kernels_line(ctx):
    out = []
    for key, (name, src, per) in KERNEL_LINE.items():
        r = ctx["kernels"][key]
        out.append({
            "name": name, "route": "cuda",
            "source": f"diffusionspatialcontrol_tpu_torch/csrc/{src}",
            "replaces": REPLACES[key], "launches": ctx["launches"][key],
            "max_abs_err": r["err"][1], "max_abs_err_fp32": r["err"][0],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "per": per, "shapes": r["shapes"]})
        if key == "K4":
            out[-1]["launches_at_k4b_shapes"] = ctx["launches"]["K4b"]
        if key in ("K1", "K2"):
            out[-1][f"launches_at_s{CHUNKED}"] = ctx["launches"][
                f"{key} S={CHUNKED}"]
    return json.dumps({"kernels": out})


def run_tree(tree: str, phases: str, no_profiles: bool) -> int:
    """``python3 chip_smoke.py --phases ...`` in ``tree``, with this file's
    ColdTimer in place of that tree's own (and without its deferred
    profiles when ``no_profiles``)."""
    here = os.path.abspath(__file__)
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('_timer', {here!r})\n"
        "timer = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(timer)\n"
        "import chip_smoke\n"
        "chip_smoke.ColdTimer = timer.ColdTimer\n"
        + ("chip_smoke.run_deferred_profiles = lambda ctx: None\n"
           if no_profiles else "") +
        f"sys.exit(chip_smoke.main(['--phases', {phases!r}]))\n")
    log(f"chip_smoke: {tree}/chip_smoke.py --phases {phases}, timed with "
        f"the ColdTimer of {here}")
    return subprocess.run([sys.executable, "-c", code], cwd=tree).returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    ap.add_argument("--tree", metavar="DIR",
                    help="run the chip_smoke.py of another checkout (for "
                    "example a parent commit unpacked with git archive) "
                    "with this file's ColdTimer, so that the kernel times "
                    "of two trees come from one timer")
    ap.add_argument("--no-profiles", action="store_true",
                    help="skip the profiles queued for the end of the run "
                    "(the p50s of two trees, one after the other, in one "
                    "call)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on "
              "the card and has nothing to run here", file=sys.stderr)
        return 1
    if args.tree:
        return run_tree(args.tree, args.phases, args.no_profiles)
    import diffusionspatialcontrol_tpu_torch  # noqa: F401  (fails outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = {"device": torch.device("cuda")}
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    run = {"build": phase_build, "kernels": phase_kernels,
           "tiny": phase_tiny, "main": phase_main, "modes": phase_modes,
           "weights": phase_weights,
           "app": phase_app, "preprocess": phase_preprocess}
    t_all = ctx["t_start"] = time.perf_counter()
    for name in PHASES:
        if name not in phases:
            continue
        t0 = time.perf_counter()
        with torch.inference_mode():
            run[name](ctx)
        torch.cuda.synchronize()
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s "
            f"({time.perf_counter() - t_all:.1f} s since the start)")
    if ctx.get("profiles") and not args.no_profiles:
        with torch.inference_mode():
            run_deferred_profiles(ctx)
        torch.cuda.synchronize()
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
