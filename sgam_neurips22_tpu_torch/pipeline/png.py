"""PNG files without Pillow: the generated frames' writer and the seed
templates' reader, from the standard library's `zlib` and `struct`.

The writer stores 8-bit gray, RGB or RGBA rows unfiltered. The reader
takes what Pillow and other encoders write for such images: 8-bit gray,
gray + alpha, RGB or RGBA, not interlaced, with any of the five row
filters, split over any number of IDAT chunks. Anything else raises,
naming the format.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> colour type written


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 pixels [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, not {img.dtype}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    if c not in _COLOR_TYPE:
        raise ValueError(f"write_png takes 1, 3 or 4 channels, not {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)  # filter 0 a row
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters: [H, stride] uint8 scanlines."""
    out = np.zeros((h + 1, stride), np.uint8)  # row 0: the zero row above the first
    pos = 0
    for y in range(1, h + 1):
        ftype, line = raw[pos], np.frombuffer(raw, np.uint8, stride, pos + 1)
        pos += 1 + stride
        up = out[y - 1]
        if ftype == 0:
            out[y] = line
        elif ftype == 1:  # Sub: a running sum of each byte lane, mod 256
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            out[y] = line + up
        elif ftype in (3, 4):  # Average, Paeth: each byte needs its reconstructed left neighbour
            row, prev, filt = bytearray(stride), up.tolist(), line.tolist()
            for x in range(stride):
                a = row[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    row[x] = (filt[x] + ((a + prev[x]) >> 1)) & 0xFF
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    row[x] = (filt[x] + _paeth(a, prev[x], c)) & 0xFF
            out[y] = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"PNG row {y - 1}: unknown filter type {ftype}")
    return out[1:]


def read_png(path: str) -> np.ndarray:
    """uint8 pixels [H, W] (gray) or [H, W, C] (gray + alpha, RGB, RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos: pos + 4])
        kind, body = data[pos + 4: pos + 8], data[pos + 8: pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        kind = {0: "gray", 2: "RGB", 3: "palette", 4: "gray + alpha", 6: "RGBA"}.get(ctype, f"colour type {ctype}")
        raise ValueError(f"{path}: {depth}-bit {kind} PNG{', interlaced' if interlace else ''}; "
                         "this reader takes 8-bit gray, gray + alpha, RGB or RGBA, not interlaced")
    c = _CHANNELS[ctype]
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c)
    return pix.reshape(h, w) if c == 1 else pix.reshape(h, w, c)
