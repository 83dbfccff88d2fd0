"""PNG files read and written by the port's own code on ``zlib`` (the machine
with the card has no PIL).

``read_png`` takes 8-bit, non-interlaced PNGs of colour type 0 (grey), 2
(RGB) and 6 (RGBA), undoes the five scanline filters (None, Sub, Up,
Average, Paeth) and returns uint8 RGB ``[H, W, 3]``: grey repeated over the
three channels and alpha dropped, as PIL's ``convert("RGB")`` gives them.
Any other PNG (palette, 16-bit, interlaced, grey with alpha) raises.
``decode_png_rgb`` does the same for PNG bytes (an image of an Arrow
file).  ``read_png_array`` returns the file's own channels, as PIL's
``np.asarray(Image.open(path))`` does: ``[H, W]`` for grey (a label map),
``[H, W, 3]`` or ``[H, W, 4]``.  ``encode_png`` / ``write_png`` write uint8
``[H, W]``, ``[H, W, 3]`` or ``[H, W, 4]`` with filter 0 on every row.  ``rgb2id`` /
``id2rgb`` are panopticapi's RGB <-> segment-id encoding of panoptic PNGs.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("PNG: truncated chunk")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG: no IEND chunk")


def _paeth_row(filt: bytearray, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(filt)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _average_row(filt: bytearray, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(filt)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, C] with the file's C channels (1, 3 or 4)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, color, compression, filter_method, interlace = header
    if depth != 8 or color not in _CHANNELS or compression or filter_method or interlace:
        raise NotImplementedError(
            f"PNG: bit depth {depth}, colour type {color}, interlace {interlace}: only 8-bit, "
            "non-interlaced grey (0), RGB (2) and RGBA (6) are read")
    bpp = _CHANNELS[color]
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG: {len(raw)} bytes of scanlines for {height} x {stride + 1}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, filt = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = filt.copy()
        elif kind == 1:       # Sub: a running sum per channel, mod 256
            cur = np.cumsum(filt.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(stride)
        elif kind == 2:       # Up
            cur = filt + prior
        elif kind == 3:       # Average
            cur = np.frombuffer(_average_row(bytearray(filt.tobytes()), prior.tobytes(), bpp),
                                np.uint8)
        elif kind == 4:       # Paeth
            cur = np.frombuffer(_paeth_row(bytearray(filt.tobytes()), prior.tobytes(), bpp),
                                np.uint8)
        else:
            raise ValueError(f"PNG: unknown filter {kind} on row {y}")
        out[y] = cur
        prior = out[y]
    return out.reshape(height, width, bpp)


def decode_png_rgb(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 RGB [H, W, 3]."""
    img = decode_png(data)
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def read_png(path: str) -> np.ndarray:
    """A PNG file -> uint8 RGB [H, W, 3]."""
    with open(path, "rb") as f:
        return decode_png_rgb(f.read())


def read_png_array(path: str) -> np.ndarray:
    """A PNG file -> uint8 [H, W] (grey), [H, W, 3] or [H, W, 4]."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    return img[..., 0] if img.shape[2] == 1 else img


def rgb2id(color: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 -> [H, W] int64 (panopticapi encoding)."""
    color = color.astype(np.int64)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def id2rgb(ids: np.ndarray) -> np.ndarray:
    out = np.zeros(ids.shape + (3,), np.uint8)
    out[..., 0] = ids % 256
    out[..., 1] = (ids // 256) % 256
    out[..., 2] = (ids // 65536) % 256
    return out


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] (grey), [H, W, 3] (RGB) or [H, W, 4] (RGBA) -> PNG
    bytes, filter 0 on every row."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3
                                                           and img.shape[2] not in (3, 4)):
        raise ValueError(f"encode_png takes uint8 [H, W], [H, W, 3] or [H, W, 4], got "
                         f"{img.dtype} {img.shape}")
    height, width = img.shape[:2]
    color = 0 if img.ndim == 2 else {3: 2, 4: 6}[img.shape[2]]
    rows = img.reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """``encode_png(img)`` written to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
