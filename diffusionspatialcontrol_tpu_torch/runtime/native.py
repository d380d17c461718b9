"""ctypes binding to the native image codec (port of ``runtime/native.py``).

The C++ source is the repo's own ``native/src/imagecodec.cc``; this module
compiles it at first use with the flags of ``native/Makefile`` into
``build/native/`` at the root of the checkout (named by a hash of the source
and the flags, so a changed source is rebuilt), and leaves ``native/``
untouched. The serving layer uses it for the device-output to response-bytes
path: uint8 conversion, PNG encoding and preview grids.

Unlike the JAX package's binding there is no fallback: when the library
cannot be built, every function raises with the compiler's output. The
card's machine has no PIL, so a silent fallback would only move the failure
to the first PNG.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "src" / "imagecodec.cc"
BUILD_DIR = _ROOT / "build" / "native"
# native/Makefile:2-3
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall"]
LDFLAGS = ["-shared", "-lz", "-lpthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdscimg-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, str(SOURCE), "-o",
           str(tmp), *LDFLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building the image codec failed: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"building the image codec failed (exit {proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a reader never sees a partial library


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        u8p, f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(
            ctypes.c_float)
        lib.dsc_tensor_to_u8.argtypes = [f32p, u8p, ctypes.c_int64,
                                         ctypes.c_int]
        lib.dsc_encode_png.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p,
                                       ctypes.c_int64, ctypes.c_int]
        lib.dsc_encode_png.restype = ctypes.c_int64
        lib.dsc_make_grid.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, u8p]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the codec builds and loads here (raises nothing)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def tensor_to_u8(images: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """fp32 [-1, 1] -> uint8, any shape."""
    arr = np.ascontiguousarray(images, np.float32)
    lib = _load()
    out = np.empty(arr.shape, np.uint8)
    lib.dsc_tensor_to_u8(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         _u8(out), arr.size, n_threads)
    return out


def encode_png(rgb: np.ndarray, compression: int = 6) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes."""
    arr = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = arr.shape
    if c != 3:
        raise ValueError(f"encode_png takes (H, W, 3) images, got "
                         f"{arr.shape}")
    lib = _load()
    cap = arr.size + 4096
    out = np.empty(cap, np.uint8)
    n = lib.dsc_encode_png(_u8(arr), w, h, _u8(out), cap, compression)
    if n < 0:  # the buffer was too small; -n bytes are needed
        cap = -n
        out = np.empty(cap, np.uint8)
        n = lib.dsc_encode_png(_u8(arr), w, h, _u8(out), cap, compression)
    if n <= 0:
        raise RuntimeError("native PNG encode failed")
    return bytes(out[:n].tobytes())


def make_grid(images: np.ndarray, cols: int = 4) -> np.ndarray:
    """(N, H, W, 3) uint8 -> contact sheet (rows*H, cols*W, 3). The JAX
    binding's surface: neither package calls it (the Gradio UI shows its
    images as a gallery)."""
    arr = np.ascontiguousarray(images, np.uint8)
    n, h, w, _ = arr.shape
    rows = (n + cols - 1) // cols
    lib = _load()
    out = np.empty((rows * h, cols * w, 3), np.uint8)
    lib.dsc_make_grid(_u8(arr), n, h, w, cols, _u8(out))
    return out
