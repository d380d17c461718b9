"""K4 and K5: GroupNorm-affine + SiLU + 3x3 conv in one pass, two
hand-written CUDA kernels with one plain PyTorch version beside them.

    out = conv3x3(silu(x * scale + bias)) + conv_bias [+ channel_bias] [+ skip]

Replaces ``diffusionspatialcontrol_tpu/ops/pallas/conv_fused.py``:

* K4, ``gn_silu_conv3x3`` -> ``csrc/conv_fused.cu`` (direct convolution;
  bf16 on ``mma.sync``), the counterpart of both ``_kernel`` (K4a, the
  whole map per program) and ``_kernel_rows`` (K4b, row blocks with a
  halo). The TPU picks one of them by whether the map fits VMEM; the CUDA
  grid tiles every map.
* K5, ``gn_silu_conv3x3_v2`` -> ``csrc/conv_fused_v2.cu`` (implicit GEMM;
  bf16 on ``wgmma`` with the weights by TMA), the counterpart of
  ``_kernel_v2``.

Both compute one function, ``gn_silu_conv3x3_plain``: the activation is
rounded to ``x.dtype`` before the conv, the zero padding stays zero after
the SiLU, the conv, the biases and the skip are summed in fp32, and the
result is rounded once. That is not the unfused ``xla`` chain, which rounds
the GroupNorm output, the conv output and the sum separately.

Operands: ``x`` (B, H, W, C_in) and ``skip`` (B, H, W, C_out) NHWC and
contiguous; ``kernel`` the port's OIHW conv kernel stored ``channels_last``,
i.e. (C_out, 3, 3, C_in) in memory, which both kernels read as it is;
``scale``/``bias`` (B, C_in) and ``channel_bias`` (B, C_out) fp32. C_in and
C_out are multiples of 8. The kernels pad nothing: what they do not take
raises, and there is no fallback to another conv path.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise. Each launcher adds to its wrapper's ``launches`` and to
its ``shapes`` tally, keyed by (B, H, W, C_in, C_out).

bf16 operands run the tensor-core bodies (K4 on ``mma.sync``, K5 on
``wgmma``; ``csrc/conv_tc.cuh``), launched by :func:`conv_plan`'s plan:
where the output tiles alone would leave SMs idle, the C_in chunks are
split over several blocks of a tile, whose fp32 partials go to a
workspace this module allocates per launch (``torch.empty``) and are
summed in split order by the tile's last block, found by a ticket counter
per tile that is zeroed once per device here and reset by the kernels.
fp32 operands keep the CUDA-core bodies and take no plan.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from ._launch import on_cpu, raise_on_error, stream_arg

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fold_group_norm(p, x, num_groups: int = 32, eps: float = 1e-5):
    """GroupNorm statistics and affine folded into per-(batch, channel)
    ``scale`` and ``bias``, so that ``x * scale + bias == group_norm(p, x)``:
    mean and biased variance over (H, W, channels of the group), fp32.
    Returns (scale, bias), each (B, C) fp32."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), correction=0)  # (B, G)
    rstd = torch.rsqrt(var + eps)
    per = c // num_groups
    scale = p["scale"].float()[None] * rstd.repeat_interleave(per, dim=1)
    bias = p["bias"].float()[None] - mean.repeat_interleave(per, dim=1) * scale
    return scale, bias


def gn_silu_conv3x3_plain(x, scale, bias, kernel, conv_bias,
                          channel_bias=None, skip=None):
    """What K4 and K5 compute, in plain PyTorch and in the Pallas body's
    order. x (B, H, W, C_in), kernel OIHW -> (B, H, W, C_out) in x's dtype."""
    act = F.silu(x.float() * scale[:, None, None, :] + bias[:, None, None, :])
    act = act.to(x.dtype).float()
    # conv2d's zero padding pads the activation: the border stays zero
    y = F.conv2d(act.permute(0, 3, 1, 2), kernel.float(), conv_bias.float(),
                 padding=1).permute(0, 2, 3, 1)
    if channel_bias is not None:
        y = y + channel_bias.float()[:, None, None, :]
    if skip is not None:
        y = y + skip.float()
    return y.to(x.dtype)


def _check(x, scale, bias, kernel, conv_bias, channel_bias, skip):
    """Raise on operands the kernels do not take; returns the small fp32
    per-channel vectors, contiguous."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C_in), got {tuple(x.shape)}")
    b, h, w, c_in = x.shape
    c_out = kernel.shape[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"the kernels take fp32 or bf16 activations, got "
                        f"{x.dtype}")
    if kernel.shape != (c_out, c_in, 3, 3) or kernel.dtype != x.dtype:
        raise ValueError(f"kernel must be OIHW ({c_out}, {c_in}, 3, 3) of "
                         f"{x.dtype}, got {tuple(kernel.shape)} "
                         f"{kernel.dtype}")
    if c_in % 8 or c_out % 8:
        raise ValueError(f"C_in and C_out must be multiples of 8, got "
                         f"{c_in}, {c_out}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")
    if not kernel.permute(0, 2, 3, 1).is_contiguous():
        raise ValueError("kernel must be stored channels_last, i.e. "
                         "(C_out, 3, 3, C_in) contiguous")
    if skip is not None and (skip.shape != (b, h, w, c_out)
                             or skip.dtype != x.dtype
                             or not skip.is_contiguous()):
        raise ValueError(f"skip must be contiguous ({b}, {h}, {w}, {c_out}) "
                         f"of {x.dtype}, got {tuple(skip.shape)} "
                         f"{skip.dtype}")
    vectors = []
    for name, t, shape in (("scale", scale, (b, c_in)),
                           ("bias", bias, (b, c_in)),
                           ("conv_bias", conv_bias, (c_out,)),
                           ("channel_bias", channel_bias, (b, c_out))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        vectors.append(None if t is None else t.float().contiguous())
    for t in (x, kernel, skip, *vectors):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("operands must be 16-byte aligned")
    return vectors


SMS = 132           # streaming multiprocessors of an H100 SXM
TILE_N = 128        # output channels of a tile (both bf16 bodies)
K5_STRIP_MAX_W = 8  # K5 tiles padded strips up to this width, boxes beyond


class ConvPlan(NamedTuple):
    """How one bf16 launch is cut: ``tile`` is K4's tile width (16, or 8
    where W <= 8; tiles are 8 rows high) or K5's form (1: strips of 128
    positions of the images laid out with padded rows of W + 2; 0: boxes
    of 8 x 16 pixels of one image); ``splits`` blocks share each of the
    ``tiles_m`` x ``tiles_n`` output tiles, split ``s`` taking C_in chunks
    [s * chunks // splits, (s + 1) * chunks // splits)."""
    tile: int
    tile_pixels: int
    tiles_m: int
    tiles_n: int
    chunk: int
    chunks: int
    splits: int

    @property
    def blocks(self) -> int:
        return self.tiles_m * self.tiles_n * self.splits

    @property
    def ws_bytes(self) -> int:
        """fp32 partials of every block, when the chunks are split."""
        if self.splits == 1:
            return 0
        return 4 * self.blocks * self.tile_pixels * TILE_N

    def chunk_ranges(self):
        """The C_in chunks [c0, c1) of each split, in split order."""
        n, s = self.chunks, self.splits
        return [(i * n // s, (i + 1) * n // s) for i in range(s)]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def conv_plan(version: str, b: int, h: int, w: int, c_in: int,
              c_out: int) -> ConvPlan:
    """The tiles and the split of a bf16 launch of K4 (``version="K4"``) or
    K5 (``"K5"``): the C_in chunks (16 channels for K4, 64 for K5) are
    split over as many blocks as bring the grid to the card's 132 SMs,
    and not split where the output tiles alone fill them."""
    if version == "K4":
        tile = 16 if w > 8 else 8
        tile_pixels = 8 * tile
        tiles_m = b * _cdiv(h, 8) * _cdiv(w, tile)
        chunk = 16
    elif version == "K5":
        tile = 1 if w <= K5_STRIP_MAX_W else 0
        tile_pixels = 128
        if tile:
            pw = w + 2
            tiles_m = _cdiv(b * (h + 2) * pw - 2 * pw, 128)
        else:
            tiles_m = b * _cdiv(h, 8) * _cdiv(w, 16)
        chunk = 64
    else:
        raise ValueError(f"version must be K4 or K5, got {version!r}")
    tiles_n = _cdiv(c_out, TILE_N)
    chunks = _cdiv(c_in, chunk)
    base = tiles_m * tiles_n
    splits = 1 if base >= SMS else min(chunks, _cdiv(SMS, base))
    return ConvPlan(tile, tile_pixels, tiles_m, tiles_n, chunk, chunks,
                    splits)


_tickets = {}  # device -> int32 counters, one per tile of a split launch


def _ticket_array(device) -> torch.Tensor:
    """Zeroed once per device; every split launch leaves it zeroed. A split
    launch has fewer than SMS tiles. One array serves every launch on the
    device, so split launches must not run concurrently on two streams (the
    port launches on the current stream only)."""
    t = _tickets.get(device)
    if t is None:
        t = _tickets[device] = torch.zeros(SMS, dtype=torch.int32,
                                           device=device)
    return t


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(source: str, version: str, wrapper, x, scale, bias, kernel,
            conv_bias, channel_bias, skip):
    """Launch ``dsc_<source>`` of ``csrc/<source>.cu``; counts the launch
    on ``wrapper``."""
    scale, bias, conv_bias, channel_bias = _check(
        x, scale, bias, kernel, conv_bias, channel_bias, skip)
    b, h, w, c_in = x.shape
    c_out = kernel.shape[0]
    out = torch.empty((b, h, w, c_out), dtype=x.dtype, device=x.device)
    ws = tickets = None
    tile, tiles_m, splits = 0, 0, 1  # the fp32 bodies take no plan
    if x.dtype == torch.bfloat16:
        plan = conv_plan(version, b, h, w, c_in, c_out)
        tile, tiles_m, splits = plan.tile, plan.tiles_m, plan.splits
        if splits > 1:
            ws = torch.empty(plan.ws_bytes // 4, dtype=torch.float32,
                             device=x.device)
            tickets = _ticket_array(x.device)
    fn = getattr(_build.load(source), f"dsc_{source}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
             kernel.data_ptr(), conv_bias.data_ptr(), _ptr(channel_bias),
             _ptr(skip), out.data_ptr(), _ptr(ws), _ptr(tickets),
             _DTYPES[x.dtype], b, h, w, c_in, c_out, tile, tiles_m, splits,
             stream_arg(x))
    raise_on_error(err, source)
    wrapper.launches += 1
    wrapper.shapes[(b, h, w, c_in, c_out)] += 1
    return out


def _dispatch(launcher, x, scale, bias, kernel, conv_bias, channel_bias,
              skip):
    operands = [t for t in (x, scale, bias, kernel, conv_bias, channel_bias,
                            skip) if t is not None]
    if on_cpu(*operands):
        _check(x, scale, bias, kernel, conv_bias, channel_bias, skip)
        return gn_silu_conv3x3_plain(x, scale, bias, kernel, conv_bias,
                                     channel_bias, skip)
    return launcher(x, scale, bias, kernel, conv_bias, channel_bias, skip)


def gn_silu_conv3x3_kernel(x, scale, bias, kernel, conv_bias,
                           channel_bias=None, skip=None):
    """Launch K4 on CUDA operands (no dispatch); counts the launch."""
    return _launch("conv_fused", "K4", gn_silu_conv3x3, x, scale, bias,
                   kernel, conv_bias, channel_bias, skip)


def gn_silu_conv3x3(x, scale, bias, kernel, conv_bias, channel_bias=None,
                    skip=None):
    """K4: conv3x3(silu(x*scale+bias)) + conv_bias [+ channel_bias]
    [+ skip], direct convolution."""
    return _dispatch(gn_silu_conv3x3_kernel, x, scale, bias, kernel,
                     conv_bias, channel_bias, skip)


def gn_silu_conv3x3_v2_kernel(x, scale, bias, kernel, conv_bias,
                              channel_bias=None, skip=None):
    """Launch K5 on CUDA operands (no dispatch); counts the launch."""
    return _launch("conv_fused_v2", "K5", gn_silu_conv3x3_v2, x, scale,
                   bias, kernel, conv_bias, channel_bias, skip)


def gn_silu_conv3x3_v2(x, scale, bias, kernel, conv_bias, channel_bias=None,
                       skip=None):
    """K5: the same function as :func:`gn_silu_conv3x3`, implicit GEMM."""
    return _dispatch(gn_silu_conv3x3_v2_kernel, x, scale, bias, kernel,
                     conv_bias, channel_bias, skip)


gn_silu_conv3x3.launches = 0
gn_silu_conv3x3.shapes = collections.Counter()
gn_silu_conv3x3_v2.launches = 0
gn_silu_conv3x3_v2.shapes = collections.Counter()
