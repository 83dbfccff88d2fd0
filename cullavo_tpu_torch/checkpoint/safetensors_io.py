"""The safetensors file format, read and written by the port's own code (the
``safetensors`` package is not installed beside the card).

A file is an 8-byte little-endian header length, a JSON header mapping each
tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets
into the data section that follows; an optional ``"__metadata__"`` map of
strings), then the raw little-endian data.  ``read_safetensors`` maps the
file and views each tensor in it with ``torch.frombuffer`` (copy-on-write,
no read of the whole file up front); every tensor keeps the file's dtype, so
bf16 stays bf16.  The dtypes are F32, F16, BF16, I8, U8, I32, I64 and BOOL;
any other raises.
"""
from __future__ import annotations

import json
import math
import mmap

import torch

_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
           "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32, "I64": torch.int64,
           "BOOL": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_safetensors(path: str) -> dict:
    """name -> tensor (CPU, the file's dtype and shape), in header order."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        size = f.seek(0, 2)
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    start = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise NotImplementedError(f"{path}: tensor {name!r} has dtype {info['dtype']!r} "
                                      f"(read: {', '.join(_DTYPES)})")
        dtype = _DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        numel = math.prod(shape)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != numel * itemsize or start + end > size:
            raise ValueError(f"{path}: tensor {name!r} spans bytes [{begin}, {end}), not "
                             f"{numel} x {itemsize}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        src = buf
        offset = start + begin
        if offset % itemsize:        # an unaligned tensor: copy its bytes out
            src, offset = bytearray(buf[offset:offset + numel * itemsize]), 0
        out[name] = torch.frombuffer(src, dtype=dtype, count=numel, offset=offset).reshape(shape)
    return out


def write_safetensors(tensors: dict, path: str, metadata: dict | None = None) -> None:
    """Write name -> tensor (any device; written as stored, contiguous) as one
    safetensors file: the largest element size first, then by name, so every
    tensor starts aligned to its element size; the header padded to 8 bytes."""
    items = sorted(tensors.items(), key=lambda kv: (-kv[1].element_size(), kv[0]))
    header, offset = {}, 0
    for name, t in items:
        if t.dtype not in _NAMES:
            raise NotImplementedError(f"tensor {name!r} has dtype {t.dtype} "
                                      f"(written: {', '.join(_DTYPES)})")
        nb = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nb]}
        offset += nb
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for _, t in items:
            if t.numel():
                data = t.detach().contiguous().reshape(-1).view(torch.uint8)
                f.write(memoryview(data.cpu().numpy()))
