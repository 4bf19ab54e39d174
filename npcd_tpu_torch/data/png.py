"""The port's PNG reader: what npcd_tpu's SRN loader gets from PIL's
``Image.open(path).convert("RGB")`` (npcd_tpu/data/srn.py:26-29), for the
files SRN holds.

The chunks are read and checked against their CRCs, the IDAT stream is
inflated with zlib, and the five row filters are undone by a host C++
routine, ``csrc/png_unfilter.cpp``, built on first use with the host C++
compiler (there is no other decoder: a missing compiler raises). Colour
types 0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and 6 (RGBA) at bit
depth 8 map to RGB as ``convert("RGB")`` maps them: grey repeated, the
palette looked up, alpha dropped. Interlaced files, other bit depths and
anything else raise, naming the file and what it has."""
from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
_ARGTYPES = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]


def _unfilter_lib() -> ctypes.CDLL:
    from ..ops.kernels.build import load_host

    lib = load_host("png_unfilter")
    lib.png_unfilter.argtypes = _ARGTYPES
    lib.png_unfilter.restype = ctypes.c_int64
    return lib


def _chunks(path: str, data: bytes):
    """(type, body) of each chunk up to IEND, each checked against its CRC."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated before IEND")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        body = data[pos + 8:end]
        if zlib.crc32(kind + body) != struct.unpack(">I", data[end:end + 4])[0]:
            raise ValueError(f"{path}: bad CRC in its {kind!r} chunk")
        pos = end + 4
        if kind == b"IEND":
            return
        yield kind, body


def read_png(path: str) -> np.ndarray:
    """The PNG file at ``path`` as RGB, uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    header, palette, idat = None, None, []
    for kind, body in _chunks(path, data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind[:1].isupper():
            raise ValueError(f"{path}: unknown critical chunk {kind!r}")
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    width, height, depth, colour, compression, filtering, interlace = header
    if colour not in CHANNELS or depth != 8:
        raise ValueError(f"{path}: colour type {colour} at bit depth {depth}; the reader takes "
                         f"colour types {sorted(CHANNELS)} at bit depth 8")
    if interlace or compression or filtering:
        raise ValueError(f"{path}: interlace {interlace}, compression {compression}, filter "
                         f"method {filtering}; the reader takes 0, 0, 0")
    if colour == 3 and palette is None:
        raise ValueError(f"{path}: colour type 3 without a PLTE chunk")
    bpp = CHANNELS[colour]
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of scanlines for {width} x {height} "
                         f"x {bpp}, not {height * (stride + 1)}")
    out = np.empty((height, width, bpp), np.uint8)
    bad = _unfilter_lib().png_unfilter(raw, out.ctypes.data, height, stride, bpp)
    if bad:
        raise ValueError(f"{path}: row {bad - 1} has filter type {raw[(bad - 1) * (stride + 1)]}")
    if colour == 2:
        return out
    if colour == 6:
        return np.ascontiguousarray(out[..., :3])
    if colour == 3:
        if out.max() >= len(palette):
            raise ValueError(f"{path}: palette index {out.max()} past its {len(palette)} entries")
        return palette[out[..., 0]]
    return np.repeat(out[..., :1], 3, axis=-1)  # grey, grey + alpha
