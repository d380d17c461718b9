"""Build the CUDA sources under ``csrc/`` with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
loaded with ``ctypes``. Libraries go to ``build/torch_kernels/`` at the root
of the checkout, named by a hash of the source, the headers it may include
and the compiler flags, so a changed source is rebuilt and an unchanged one
is reused. Nothing here runs at import time: the CPU tests import every
module of the port on a machine without ``nvcc``. Processes that build at
once (the ranks of a data-parallel mesh) take a file lock a source, so one
of them compiles it and the others load its library; the lock is the
kernel's (``flock``), released when its holder ends, however it ends.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("region_attention", "flash_attention", "conv_fused",
           "conv_fused_v2", "hed_fuse")

_loaded: Dict[str, object] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (process or None, temp output, final output, lock file or None). The
    lock is held until ``_finish``."""
    out = library_path(name)
    if out.exists():
        return None, None, out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lock = open(BUILD_DIR / f"{name}.lock", "w")
    fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building it
    if out.exists():
        lock.close()
        return None, None, out, None
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except BaseException:
        lock.close()
        raise
    return proc, tmp, out, lock


def _finish(name: str, proc, tmp: Path, out: Path, lock) -> None:
    if proc is None:
        return
    try:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: a reader never sees a partial one
    finally:
        lock.close()  # releases the flock


def build(names: Sequence[str] = SOURCES) -> float:
    """Compile every named source, one nvcc per source, all started
    together. Returns the wall seconds the build took."""
    t0 = time.perf_counter()
    started = [(n, *_start(n)) for n in names]
    for n, *job in started:
        _finish(n, *job)
    return time.perf_counter() - t0


def load(name: str):
    """The ``ctypes`` library of ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        import ctypes

        _finish(name, *_start(name))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
