"""PNG files without Pillow: the generated frames' writer and the
templates' and datasets' reader, from the standard library's `zlib` and
`struct`, with the row filters undone in C++ (`csrc/png_unfilter.cpp`,
built with g++ at first use by `core.native`).

The writer stores 8-bit gray, RGB or RGBA rows unfiltered. The reader
takes what Pillow and other encoders write for such images: 8-bit gray,
gray + alpha, RGB or RGBA, not interlaced, with any of the five row
filters, split over any number of IDAT chunks. Anything else raises,
naming the format.
"""
from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> colour type written
_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "png_unfilter.cpp"
_lock = threading.Lock()
_unfilter_lib: Optional[ctypes.CDLL] = None


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


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters: [H, stride] uint8 scanlines, in C++
    (`csrc/png_unfilter.cpp`; the interpreter lock is released meanwhile)."""
    if len(raw) < h * (stride + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes; its header needs {h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    bad = _lib().png_unfilter(raw, h, stride, bpp, out.ctypes.data)
    if bad:
        raise ValueError(f"PNG row {bad - 1}: unknown filter type {raw[(bad - 1) * (stride + 1)]}")
    return out


def _lib() -> ctypes.CDLL:
    global _unfilter_lib
    with _lock:
        if _unfilter_lib is None:
            from sgam_neurips22_tpu_torch.core import native

            lib = ctypes.CDLL(str(native.build(_SOURCE, "libsgam_png")))
            lib.png_unfilter.restype = ctypes.c_int64
            lib.png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_void_p]
            _unfilter_lib = lib
        return _unfilter_lib


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
