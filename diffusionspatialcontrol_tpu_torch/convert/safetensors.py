"""Reader and writer for the safetensors format, in plain Python and torch.

The format: an 8-byte little-endian header length ``n``, ``n`` bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` of strings), then the tensors' little-endian
bytes, ``data_offsets`` counted from the end of the header.

The port reads every weight file through this module (the JAX package uses
the ``safetensors`` package, which the card's machine does not have).
``load_file`` maps the file copy-on-write and views each tensor in place
(``torch.frombuffer``), so a 1.7 GB UNet file is not copied on the host
before the converters move its tensors to the device.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}

_MAX_HEADER = 100 * 1024 * 1024  # the reference implementation's limit


def _read_header(f) -> Tuple[int, dict]:
    raw = f.read(8)
    if len(raw) != 8:
        raise ValueError("not a safetensors file: shorter than its header "
                         "length")
    (n,) = struct.unpack("<Q", raw)
    if n > _MAX_HEADER:
        raise ValueError(f"safetensors header of {n} bytes is too large")
    text = f.read(n)
    if len(text) != n:
        raise ValueError("safetensors header is cut short")
    header = json.loads(text)
    if not isinstance(header, dict):
        raise ValueError("safetensors header is not a JSON object")
    return 8 + n, header


def load_metadata(path: str) -> Dict[str, str]:
    """The header's ``__metadata__`` (an empty dict when there is none)."""
    with open(path, "rb") as f:
        return dict(_read_header(f)[1].get("__metadata__") or {})


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file, on the CPU, in its stored dtype, viewing a
    copy-on-write map of the file (writing to a tensor never reaches the
    file)."""
    with open(path, "rb") as f:
        base, header = _read_header(f)
        f.seek(0, 2)
        size = f.tell()
        buf = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
               if size > base else None)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype = _DTYPES[info["dtype"]]
        except KeyError:
            raise ValueError(f"{name}: unsupported dtype {info['dtype']!r}"
                             ) from None
        shape = [int(s) for s in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        count = int(np.prod(shape, dtype=np.int64))
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize or begin < 0 \
                or base + end > size:
            raise ValueError(f"{name}: data offsets [{begin}, {end}] do not "
                             f"fit its shape {shape} {info['dtype']} or the "
                             f"file's {size - base} data bytes")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        offset = base + begin
        if offset % itemsize:  # unaligned: a copy of its bytes
            t = torch.frombuffer(bytearray(buf[offset:base + end]),
                                 dtype=dtype)
        else:
            t = torch.frombuffer(buf, dtype=dtype, count=count, offset=offset)
        out[name] = t.reshape(shape)
    return out


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach()
    return torch.from_numpy(np.ascontiguousarray(value))


def save_file(tensors: Mapping[str, object], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (torch tensors on any device, or numpy arrays) in
    name order; each is copied to the host on its own while it is written,
    in its logical (row-major) order whatever its memory format."""
    items = sorted((k, _as_tensor(v)) for k, v in tensors.items())
    header: Dict[str, object] = {}
    offset = 0
    for name, t in items:
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             f"name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        if not all(isinstance(k, str) and isinstance(v, str)
                   for k, v in metadata.items()):
            raise ValueError("safetensors metadata maps strings to strings")
        header["__metadata__"] = dict(metadata)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for _, t in items:
            if t.numel():
                flat = t.to("cpu").contiguous().reshape(-1)
                f.write(memoryview(flat.view(torch.uint8).numpy()))
