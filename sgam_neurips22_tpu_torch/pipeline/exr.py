"""An OpenEXR reader with numpy and zlib only (no OpenEXR package, no
OpenCV, no Pillow): what `convert_exr` needs of Blender's renders.

It reads scanline single-part files (the layout Blender writes, its
multilayer files included) with NONE, RLE, ZIPS or ZIP compression, HALF,
FLOAT and UINT channels, in increasing or decreasing line order. Every other
layout raises a ValueError that names the file and what it lacks: PIZ,
PXR24, B44, B44A, DWAA and DWAB compression, tiled, deep and multipart
files, and subsampled channels.

The layout (OpenEXR's file-format document): a magic number and a version
word whose flag bits mark tiled, deep and multipart files; a header of
(name, type, size, value) attributes up to an empty name; one 64-bit offset
a chunk; then the chunks, each its first scanline y, its byte count and its
data. A chunk holds `LINES[compression]` scanlines; uncompressed, each
scanline holds each channel's row in turn, the channels in the header's
(alphabetical) order, little-endian. RLE and ZIP(S) data, once inflated,
are split bytes (the even bytes, then the odd) with a delta predictor on
top; a chunk whose compressed size is the raw size is stored raw.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

MAGIC = 20000630
COMPRESSIONS = ("NONE", "RLE", "ZIPS", "ZIP", "PIZ", "PXR24", "B44", "B44A", "DWAA", "DWAB")
SUPPORTED = ("NONE", "RLE", "ZIPS", "ZIP")
LINES = {"NONE": 1, "RLE": 1, "ZIPS": 1, "ZIP": 16}
PIXEL_TYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}  # UINT, HALF, FLOAT
LINE_ORDERS = ("INCREASING_Y", "DECREASING_Y", "RANDOM_Y")
TILED, DEEP, MULTIPART = 0x200, 0x800, 0x1000  # version flags


class Channel(NamedTuple):
    name: str
    dtype: np.dtype


class Header(NamedTuple):
    channels: List[Channel]  # in the file's order
    compression: str
    data_window: Tuple[int, int, int, int]  # xmin, ymin, xmax, ymax
    line_order: str


class _Bytes:
    def __init__(self, data: bytes, path: str):
        self.data, self.pos, self.path = data, 0, path

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.path}: truncated EXR (wanted {n} bytes at offset {self.pos})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def cstr(self) -> str:
        end = self.data.find(b"\0", self.pos)
        if end < 0:
            raise ValueError(f"{self.path}: truncated EXR (unterminated name at offset {self.pos})")
        out = self.data[self.pos:end].decode("latin-1")
        self.pos = end + 1
        return out


def _channels(raw: bytes, path: str) -> List[Channel]:
    buf, out = _Bytes(raw, path), []
    while True:
        name = buf.cstr()
        if not name:
            return out
        ptype, _linear, xs, ys = struct.unpack("<iB3xii", buf.take(16))
        if ptype not in PIXEL_TYPES:
            raise ValueError(f"{path}: channel {name!r} has pixel type {ptype}, not UINT, HALF or FLOAT")
        if (xs, ys) != (1, 1):
            raise ValueError(f"{path}: channel {name!r} is subsampled ({xs}, {ys}); "
                             "the reader handles full-resolution channels only")
        out.append(Channel(name, PIXEL_TYPES[ptype]))


def read_header(buf: _Bytes) -> Header:
    path = buf.path
    magic, version = struct.unpack("<ii", buf.take(8))
    if magic != MAGIC:
        raise ValueError(f"{path}: not an OpenEXR file (magic {magic:#x})")
    for flag, what in ((MULTIPART, "a multipart file"), (DEEP, "a deep (non-image) file"), (TILED, "a tiled file")):
        if version & flag:
            raise ValueError(f"{path}: {what}; the reader handles scanline single-part files only")
    attrs: Dict[str, Tuple[str, bytes]] = {}
    while True:
        name = buf.cstr()
        if not name:
            break
        kind = buf.cstr()
        (size,) = struct.unpack("<i", buf.take(4))
        attrs[name] = (kind, buf.take(size))
    for need in ("channels", "compression", "dataWindow", "lineOrder"):
        if need not in attrs:
            raise ValueError(f"{path}: the header has no {need!r} attribute")
    if "tiles" in attrs or attrs.get("type", ("", b""))[1].rstrip(b"\0") not in (b"", b"scanlineimage"):
        kind = attrs.get("type", ("", b"tiledimage"))[1].rstrip(b"\0").decode("latin-1")
        raise ValueError(f"{path}: a {kind} part; the reader handles scanline single-part files only")
    code = attrs["compression"][1][0]
    compression = COMPRESSIONS[code] if code < len(COMPRESSIONS) else f"compression {code}"
    if compression not in SUPPORTED:
        raise ValueError(f"{path}: {compression} compression is not supported (the reader handles "
                         f"{', '.join(SUPPORTED)}); convert the file to ZIP, e.g. in Blender's output settings")
    order = attrs["lineOrder"][1][0]
    return Header(_channels(attrs["channels"][1], path), compression, struct.unpack("<iiii", attrs["dataWindow"][1]),
                  LINE_ORDERS[order] if order < len(LINE_ORDERS) else str(order))


def _rle_decode(data: bytes, size: int, path: str) -> bytes:
    """OpenEXR's run-length code: a negative count n takes the next -n bytes
    as they are, a count n >= 0 repeats the next byte n + 1 times."""
    out, i = bytearray(), 0
    while i < len(data):
        n = struct.unpack_from("b", data, i)[0]
        if n < 0:
            out += data[i + 1:i + 1 - n]
            i += 1 - n
        else:
            out += data[i + 1:i + 2] * (n + 1)
            i += 2
    if len(out) != size:
        raise ValueError(f"{path}: an RLE chunk decodes to {len(out)} bytes, not {size}")
    return bytes(out)


def _unpredict(raw: bytes) -> bytes:
    """Undo the delta predictor and the byte split of RLE and ZIP(S) data."""
    r = np.frombuffer(raw, np.uint8).astype(np.int64)
    t = np.empty(len(r), np.uint8)
    if len(r):  # t[i] = t[i-1] + r[i] - 128, mod 256
        t[0] = r[0]
        t[1:] = (r[0] + np.cumsum(r[1:] - 128)) & 0xFF
    out = np.empty_like(t)
    half = (len(t) + 1) // 2
    out[0::2], out[1::2] = t[:half], t[half:]
    return out.tobytes()


def _decompress(data: bytes, compression: str, size: int, path: str) -> bytes:
    if compression == "NONE" or len(data) == size:
        return data
    if compression == "RLE":
        return _unpredict(_rle_decode(data, size, path))
    raw = zlib.decompress(data)
    if len(raw) != size:
        raise ValueError(f"{path}: a {compression} chunk inflates to {len(raw)} bytes, not {size}")
    return _unpredict(raw)


def read_exr(path: str) -> Tuple[Header, Dict[str, np.ndarray]]:
    """(header, {channel name: [H, W] array in its pixel type: float16,
    float32 or uint32}) of a scanline single-part OpenEXR file."""
    with open(path, "rb") as f:
        buf = _Bytes(f.read(), path)
    hdr = read_header(buf)
    xmin, ymin, xmax, ymax = hdr.data_window
    w, h = xmax - xmin + 1, ymax - ymin + 1
    lines = LINES[hdr.compression]
    n_chunks = (h + lines - 1) // lines
    offsets = struct.unpack(f"<{n_chunks}Q", buf.take(8 * n_chunks))
    row_bytes = [w * ch.dtype.itemsize for ch in hdr.channels]
    line_bytes = sum(row_bytes)
    planes = {ch.name: np.empty((h, w), ch.dtype) for ch in hdr.channels}
    seen = np.zeros(n_chunks, bool)
    for off in offsets:
        chunk = _Bytes(buf.data, path)
        chunk.pos = off
        y, size = struct.unpack("<ii", chunk.take(8))
        first = y - ymin
        if first < 0 or first >= h or first % lines:
            raise ValueError(f"{path}: a chunk starts at scanline {y}, outside the data window {hdr.data_window}")
        n = min(lines, h - first)
        raw = _decompress(chunk.take(size), hdr.compression, n * line_bytes, path)
        pos = 0
        for r in range(n):
            for ch, nb in zip(hdr.channels, row_bytes):
                planes[ch.name][first + r] = np.frombuffer(raw, ch.dtype, w, pos)
                pos += nb
        seen[first // lines] = True
    if not seen.all():
        raise ValueError(f"{path}: {int((~seen).sum())} of {n_chunks} chunks missing")
    return hdr, planes
