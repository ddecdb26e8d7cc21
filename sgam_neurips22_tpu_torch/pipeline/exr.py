"""An OpenEXR reader with numpy and zlib only (no OpenEXR package, no
OpenCV, no Pillow): what `convert_exr` needs of Blender's renders.

It reads scanline single-part files (the layout Blender writes, its
multilayer files included) with NONE, RLE, ZIPS, ZIP, PIZ, PXR24, B44 or
B44A compression, HALF, FLOAT and UINT channels, in increasing or
decreasing line order. Every other layout raises a ValueError that names
the file and what it lacks: DWAA and DWAB compression, tiled, deep and
multipart files, and subsampled channels.

The layout (OpenEXR's file-format document): a magic number and a version
word whose flag bits mark tiled, deep and multipart files; a header of
(name, type, size, value) attributes up to an empty name; one 64-bit offset
a chunk; then the chunks, each its first scanline y, its byte count and its
data. A chunk holds `LINES[compression]` scanlines; uncompressed, each
scanline holds each channel's row in turn, the channels in the header's
(alphabetical) order, little-endian. RLE and ZIP(S) data, once inflated,
are split bytes (the even bytes, then the odd) with a delta predictor on
top; a chunk whose compressed size is the raw size is stored raw.

PIZ (32 lines a chunk; OpenEXR's ImfPizCompressor, ImfHuf, ImfWav) codes
the chunk's 16-bit words, channel after channel, through a table of the
values present, a 2D Haar wavelet and a Huffman code: the C++ decoder
`csrc/exr_piz.cpp` (g++ at first use, `core.native`) reads files, and
`piz_words_numpy` is the same decoder in numpy, its plain version.
`csrc/exr_piz.cpp` describes the stream. PXR24 (16 lines a chunk) deflates
byte planes of each row's differences: HALF and UINT exactly, FLOAT
rounded to 24 bits by the writer, which the reader returns as written.
B44 and B44A (32 lines a chunk; OpenEXR's ImfB44Compressor) store each
channel in turn: FLOAT and UINT channels raw, all their rows at once; HALF
channels in 4x4 blocks, row by row, the last row and column of blocks
padded by the writer. A block is 14 bytes (its first value and 15 six-bit
differences scaled by a shift, on an ordered form of the half's bits) or,
where the third byte says a shift of 13 or more, 3 bytes: one value for the
whole block, which B44A writes for flat blocks. A channel flagged pLinear
was stored as exp(x / 8) and is turned back through 8 log(x)
(`B44_LOG_TABLE`). B44 is lossy; the reader returns what the writer kept.
"""
from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

MAGIC = 20000630
COMPRESSIONS = ("NONE", "RLE", "ZIPS", "ZIP", "PIZ", "PXR24", "B44", "B44A", "DWAA", "DWAB")
SUPPORTED = ("NONE", "RLE", "ZIPS", "ZIP", "PIZ", "PXR24", "B44", "B44A")
LINES = {"NONE": 1, "RLE": 1, "ZIPS": 1, "ZIP": 16, "PIZ": 32, "PXR24": 16, "B44": 32, "B44A": 32}
PIXEL_TYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}  # UINT, HALF, FLOAT
LINE_ORDERS = ("INCREASING_Y", "DECREASING_Y", "RANDOM_Y")
TILED, DEEP, MULTIPART = 0x200, 0x800, 0x1000  # version flags
_PIZ_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "exr_piz.cpp"
_PIZ_ERRORS = {-1: "is truncated", -2: "has a bitmap past 8192 bytes", -3: "has an invalid Huffman table",
               -4: "has an invalid Huffman code", -5: "decodes to another number of words"}
_lock = threading.Lock()
_piz_cdll: Optional[ctypes.CDLL] = None


class Channel(NamedTuple):
    name: str
    dtype: np.dtype
    linear: bool = False  # the header's pLinear flag (perceptually linear), which only B44(A) reads


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
        ptype, linear, xs, ys = struct.unpack("<iB3xii", buf.take(16))
        if ptype not in PIXEL_TYPES:
            raise ValueError(f"{path}: channel {name!r} has pixel type {ptype}, not UINT, HALF or FLOAT")
        if (xs, ys) != (1, 1):
            raise ValueError(f"{path}: channel {name!r} is subsampled ({xs}, {ys}); "
                             "the reader handles full-resolution channels only")
        out.append(Channel(name, PIXEL_TYPES[ptype], bool(linear)))


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


def _huf_decode(data: bytes, n_out: int, path: str) -> np.ndarray:
    """OpenEXR's Huffman stream (see csrc/exr_piz.cpp) -> n_out uint16 words."""
    if not data:
        if n_out:
            raise ValueError(f"{path}: a PIZ chunk decodes to 0 words, not {n_out}")
        return np.zeros(0, np.uint16)
    if len(data) < 20:
        raise ValueError(f"{path}: a PIZ chunk is truncated")
    im, top, _, n_bits, _ = struct.unpack_from("<5I", data)
    if im > top or top > 1 << 16:
        raise ValueError(f"{path}: a PIZ chunk has an invalid Huffman table")
    bits = np.unpackbits(np.frombuffer(data, np.uint8, offset=20))
    lengths = np.zeros(top + 1, np.int64)
    pos, s = 0, im

    def field(n):
        nonlocal pos
        if pos + n > len(bits):
            raise ValueError(f"{path}: a PIZ chunk is truncated")
        v = int(bits[pos:pos + n] @ (1 << np.arange(n - 1, -1, -1)))
        pos += n
        return v

    while s <= top:
        n = field(6)
        if n >= 59:  # a run of zero lengths: 2-5, or 6-261 in the next 8 bits
            run = field(8) + 6 if n == 63 else n - 57
            if s + run > top + 1:
                raise ValueError(f"{path}: a PIZ chunk has an invalid Huffman table")
            s += run
        else:
            lengths[s] = n
            s += 1
    start = (pos + 7) // 8 * 8  # the codes start at the next byte
    if start + n_bits > len(bits):
        raise ValueError(f"{path}: a PIZ chunk is truncated")
    # canonical codes: the lowest code of each length, longer codes lower
    count = np.bincount(lengths, minlength=60)
    first, c = [0] * 60, 0
    for n in range(58, 0, -1):
        first[n], c = c, (c + int(count[n])) >> 1
    order = np.lexsort((np.arange(top + 1), lengths))  # by length, then symbol
    order = order[lengths[order] > 0]
    codes = {}  # (length, code) -> symbol
    nxt = list(first)
    for sym in order.tolist():
        n = int(lengths[sym])
        codes[n, nxt[n]] = sym
        nxt[n] += 1
    out: List[int] = []
    stream = bits[start:start + n_bits].tolist()
    i, end = 0, len(stream)
    while i < end:
        v = n = 0
        while True:
            if i >= end or n == 58:
                raise ValueError(f"{path}: a PIZ chunk has an invalid Huffman code")
            v = (v << 1) | stream[i]
            i += 1
            n += 1
            sym = codes.get((n, v))
            if sym is not None:
                break
        if sym == top:  # the run symbol: the last word again, 8 bits' worth of times
            if i + 8 > end or not out:
                raise ValueError(f"{path}: a PIZ chunk has an invalid Huffman code")
            run = 0
            for b in stream[i:i + 8]:
                run = (run << 1) | b
            i += 8
            out.extend([out[-1]] * run)
        else:
            out.append(sym)
    if len(out) != n_out:
        raise ValueError(f"{path}: a PIZ chunk decodes to {len(out)} words, not {n_out}")
    return np.array(out, np.uint16)


def _wdec14(lo: np.ndarray, hi: np.ndarray):
    ls, hs = lo.view(np.int16).astype(np.int32), hi.view(np.int16).astype(np.int32)
    a = ls + (hs & 1) + (hs >> 1)
    return (a & 0xFFFF).astype(np.uint16), ((a - hs) & 0xFFFF).astype(np.uint16)


def _wdec16(lo: np.ndarray, hi: np.ndarray):
    m, d = lo.astype(np.int32), hi.astype(np.int32)
    b = (m - (d >> 1)) & 0xFFFF
    return ((d + b - 0x8000) & 0xFFFF).astype(np.uint16), b.astype(np.uint16)


def _wav2_decode(a: np.ndarray, max_value: int) -> None:
    """The inverse 2D wavelet of the [ny, nx] uint16 view `a`, in place:
    level by level from the coarsest, every 2x2 block of a level at once."""
    dec = _wdec14 if max_value < 1 << 14 else _wdec16
    ny, nx = a.shape
    p = 1
    while p <= min(nx, ny):
        p <<= 1
    p2, p = p >> 1, p >> 2
    while p >= 1:
        ye, xe = ny // p2 * p2, nx // p2 * p2  # past the last block
        px, p01 = a[0:ye:p2, 0:xe:p2], a[0:ye:p2, p:xe:p2]
        p10, p11 = a[p:ye:p2, 0:xe:p2], a[p:ye:p2, p:xe:p2]
        i00, i10 = dec(px, p10)
        i01, i11 = dec(p01, p11)
        px[...], p01[...] = dec(i00, i01)
        p10[...], p11[...] = dec(i10, i11)
        if nx & p:  # the odd column
            a[0:ye:p2, xe], a[p:ye:p2, xe] = dec(a[0:ye:p2, xe], a[p:ye:p2, xe])
        if ny & p:  # the odd row
            a[ye, 0:xe:p2], a[ye, p:xe:p2] = dec(a[ye, 0:xe:p2], a[ye, p:xe:p2])
        p2, p = p, p >> 1


def piz_words_numpy(data: bytes, nx: int, ny: int, sizes: Sequence[int], path: str = "<PIZ>") -> np.ndarray:
    """The 16-bit words of a PIZ chunk of ny rows of nx pixels, channel
    after channel, each channel sizes[c] words a pixel (1: HALF, 2: FLOAT or
    UINT, low word first) and its rows in turn: the plain version of
    `csrc/exr_piz.cpp`."""
    buf = _Bytes(data, path)
    lo, hi = struct.unpack("<HH", buf.take(4))
    if hi >= 8192:
        raise ValueError(f"{path}: a PIZ chunk has a bitmap past 8192 bytes")
    bitmap = np.zeros(8192, np.uint8)
    if lo <= hi:
        bitmap[lo:hi + 1] = np.frombuffer(buf.take(hi - lo + 1), np.uint8)
    present = np.unpackbits(bitmap, bitorder="little").astype(bool)
    present[0] = True
    lut = np.zeros(1 << 16, np.uint16)  # rank -> value
    values = np.flatnonzero(present)
    lut[:len(values)] = values
    (length,) = struct.unpack("<i", buf.take(4))
    if length < 0 or buf.pos + length > len(data):
        raise ValueError(f"{path}: a PIZ chunk is truncated")
    words = _huf_decode(buf.take(length), nx * ny * sum(sizes), path)
    at = 0
    for size in sizes:
        plane = words[at:at + nx * ny * size].reshape(ny, nx * size)
        for j in range(size):
            _wav2_decode(plane[:, j::size], len(values) - 1)
        at += nx * ny * size
    return lut[words]


def _piz_lib() -> ctypes.CDLL:
    global _piz_cdll
    with _lock:
        if _piz_cdll is None:
            from sgam_neurips22_tpu_torch.core import native

            lib = ctypes.CDLL(str(native.build(_PIZ_SOURCE, "libsgam_exr_piz")))
            lib.piz_decode.restype = ctypes.c_int64
            lib.piz_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                                       ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64]
            _piz_cdll = lib
        return _piz_cdll


def piz_words(data: bytes, nx: int, ny: int, sizes: Sequence[int], path: str = "<PIZ>") -> np.ndarray:
    """`piz_words_numpy`'s words, decoded by `csrc/exr_piz.cpp`."""
    sz = np.asarray(sizes, np.int32)
    out = np.empty(nx * ny * int(sz.sum()), np.uint16)
    status = _piz_lib().piz_decode(data, len(data), nx, ny, sz.ctypes.data, len(sz), out.ctypes.data, out.size)
    if status:
        raise ValueError(f"{path}: a PIZ chunk {_PIZ_ERRORS.get(status, f'fails ({status})')}")
    return out


def _piz(data: bytes, channels: List[Channel], w: int, n: int, path: str, native: bool) -> bytes:
    sizes = [ch.dtype.itemsize // 2 for ch in channels]
    words = (piz_words if native else piz_words_numpy)(data, w, n, sizes, path).astype("<u2")
    at, rows = 0, []
    for size in sizes:  # each channel's rows back into scanlines
        rows.append(words[at:at + n * w * size].view(np.uint8).reshape(n, -1))
        at += n * w * size
    return np.concatenate(rows, axis=1).tobytes()


_PXR24_PLANES = {"<u4": 4, "<f2": 2, "<f4": 3}  # byte planes a sample: UINT, HALF, FLOAT (24 bits)


def _pxr24(data: bytes, channels: List[Channel], w: int, n: int, path: str) -> bytes:
    """Each row of each channel: byte planes (most significant first) of
    the differences of its samples' bits, summed back here mod 2^32 (a
    FLOAT's 24 bits are its top three bytes)."""
    planes = [_PXR24_PLANES[ch.dtype.str] for ch in channels]
    raw = np.frombuffer(zlib.decompress(data), np.uint8)
    if raw.size != n * w * sum(planes):
        raise ValueError(f"{path}: a PXR24 chunk inflates to {raw.size} bytes, not {n * w * sum(planes)}")
    raw, at, rows = raw.reshape(n, -1), 0, []
    for ch, k in zip(channels, planes):
        b = raw[:, at:at + k * w].reshape(n, k, w).astype(np.uint32)
        at += k * w
        diff = np.zeros((n, w), np.uint32)
        for i in range(k):
            diff |= b[:, i] << np.uint32(8 * (3 - i) if k == 3 else 8 * (k - 1 - i))
        bits = np.cumsum(diff, axis=1, dtype=np.uint32)
        rows.append(bits.astype(ch.dtype.str.replace("f", "u")).view(np.uint8).reshape(n, -1))
    return np.concatenate(rows, axis=1).tobytes()


def _b44_log_table() -> np.ndarray:
    """OpenEXR's logTable (b44ExpLogTable): for every half bit pattern h,
    the half of 8 log(h) taken in float (as logf, correctly rounded), or 0
    where h is not finite or is below zero."""
    f = np.arange(1 << 16, dtype=np.uint16).view(np.float16).astype(np.float32)
    keep = np.isfinite(f) & ~(f < 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        log = np.log(f.astype(np.float64)).astype(np.float32) * np.float32(8)
    return np.where(keep, log, np.float32(0)).astype(np.float16).view(np.uint16)


B44_LOG_TABLE = _b44_log_table()
_B44_FLAT = 13 << 2  # a third byte at least this marks a 3-byte block


def _b44_unpack14(b: np.ndarray) -> np.ndarray:
    """[m, 14] bytes -> [m, 16] ordered 16-bit values (ImfB44Compressor's
    unpack14): the first value, then 15 six-bit differences, each times
    2^shift less 32 * 2^shift, down each column and along the first row."""
    b = b.astype(np.int64)
    shift = b[:, 2] >> 2
    bias = 0x20 << shift

    def d(x):
        return ((x & 0x3F) << shift) - bias

    s = [None] * 16
    s[0] = (b[:, 0] << 8) | b[:, 1]
    s[4] = s[0] + d((b[:, 2] << 4) | (b[:, 3] >> 4))
    s[8] = s[4] + d((b[:, 3] << 2) | (b[:, 4] >> 6))
    s[12] = s[8] + d(b[:, 4])
    for col, at in ((1, 5), (2, 8), (3, 11)):  # each column's top from the one before, then down
        s[col] = s[col - 1] + d(b[:, at] >> 2)
        s[col + 4] = s[col + 3] + d((b[:, at] << 4) | (b[:, at + 1] >> 4))
        s[col + 8] = s[col + 7] + d((b[:, at + 1] << 2) | (b[:, at + 2] >> 6))
        s[col + 12] = s[col + 11] + d(b[:, at + 2])
    return np.stack(s, axis=1) & 0xFFFF


def _b44_channel(data: bytes, pos: int, w: int, n: int, linear: bool, path: str) -> Tuple[np.ndarray, int]:
    """One HALF channel's [n, w] bit patterns from the blocks at data[pos:]
    and the position past them."""
    nby, nbx = -(-n // 4), -(-w // 4)
    starts, flat = np.empty(nby * nbx, np.int64), np.empty(nby * nbx, bool)
    for i in range(nby * nbx):  # a block's size shows in its third byte
        if pos + 3 > len(data):
            raise ValueError(f"{path}: a B44 chunk is truncated")
        starts[i], flat[i] = pos, data[pos + 2] >= _B44_FLAT
        pos += 3 if flat[i] else 14
    if pos > len(data):
        raise ValueError(f"{path}: a B44 chunk is truncated")
    raw = np.frombuffer(data, np.uint8)
    s = np.empty((nby * nbx, 16), np.int64)
    first = raw[starts[:, None] + np.arange(2)].astype(np.int64)
    s[flat] = ((first[flat, 0] << 8) | first[flat, 1])[:, None]
    s[~flat] = _b44_unpack14(raw[starts[~flat, None] + np.arange(14)])
    s = np.where(s & 0x8000, s & 0x7FFF, ~s & 0xFFFF).astype(np.uint16)  # ordered form -> half bits
    if linear:
        s = B44_LOG_TABLE[s]
    blocks = s.reshape(nby, nbx, 4, 4).transpose(0, 2, 1, 3).reshape(nby * 4, nbx * 4)
    return blocks[:n, :w], pos


def _b44(data: bytes, channels: List[Channel], w: int, n: int, path: str) -> bytes:
    """B44 and B44A: each channel in turn, FLOAT and UINT raw, HALF in 4x4
    blocks (the edge blocks padded)."""
    pos, rows = 0, []
    for ch in channels:
        if ch.dtype.itemsize != 2:
            size = n * w * ch.dtype.itemsize
            if pos + size > len(data):
                raise ValueError(f"{path}: a B44 chunk is truncated")
            rows.append(np.frombuffer(data, np.uint8, size, pos).reshape(n, -1))
            pos += size
            continue
        bits, pos = _b44_channel(data, pos, w, n, ch.linear, path)
        rows.append(bits.astype("<u2").view(np.uint8).reshape(n, -1))
    if pos != len(data):
        raise ValueError(f"{path}: a B44 chunk holds {len(data) - pos} bytes past its blocks")
    return np.concatenate(rows, axis=1).tobytes()


def _decompress(data: bytes, hdr: Header, w: int, n: int, path: str, native: bool = True) -> bytes:
    """The raw scanline bytes of a chunk of n rows of w pixels."""
    size = n * w * sum(ch.dtype.itemsize for ch in hdr.channels)
    compression = hdr.compression
    if compression == "NONE" or len(data) == size:
        return data
    if compression == "PIZ":
        return _piz(data, hdr.channels, w, n, path, native)
    if compression == "PXR24":
        return _pxr24(data, hdr.channels, w, n, path)
    if compression in ("B44", "B44A"):
        return _b44(data, hdr.channels, w, n, path)
    if compression == "RLE":
        return _unpredict(_rle_decode(data, size, path))
    raw = zlib.decompress(data)
    if len(raw) != size:
        raise ValueError(f"{path}: a {compression} chunk inflates to {len(raw)} bytes, not {size}")
    return _unpredict(raw)


def read_exr(path: str, native: bool = True) -> Tuple[Header, Dict[str, np.ndarray]]:
    """(header, {channel name: [H, W] array in its pixel type: float16,
    float32 or uint32}) of a scanline single-part OpenEXR file; PIZ chunks
    through `csrc/exr_piz.cpp`, or `piz_words_numpy` without `native`."""
    with open(path, "rb") as f:
        buf = _Bytes(f.read(), path)
    hdr = read_header(buf)
    xmin, ymin, xmax, ymax = hdr.data_window
    w, h = xmax - xmin + 1, ymax - ymin + 1
    lines = LINES[hdr.compression]
    n_chunks = (h + lines - 1) // lines
    offsets = struct.unpack(f"<{n_chunks}Q", buf.take(8 * n_chunks))
    row_bytes = [w * ch.dtype.itemsize for ch in hdr.channels]
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
        raw = _decompress(chunk.take(size), hdr, w, n, path, native)
        pos = 0
        for r in range(n):
            for ch, nb in zip(hdr.channels, row_bytes):
                planes[ch.name][first + r] = np.frombuffer(raw, ch.dtype, w, pos)
                pos += nb
        seen[first // lines] = True
    if not seen.all():
        raise ValueError(f"{path}: {int((~seen).sum())} of {n_chunks} chunks missing")
    return hdr, planes
