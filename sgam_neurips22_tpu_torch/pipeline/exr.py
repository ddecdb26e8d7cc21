"""An OpenEXR reader with numpy and zlib only (no OpenEXR package, no
OpenCV, no Pillow): what `convert_exr` needs of Blender's renders, and what
OpenEXR's InputFile reads of any image file.

It reads single-part files, scanline or tiled, and a multipart file's
first part (as InputFile does), with any of OpenEXR's compressions (NONE,
RLE, ZIPS, ZIP, PIZ, PXR24, B44, B44A, DWAA, DWAB), HALF, FLOAT and UINT
channels, in any line order; a tiled part's full-resolution level (0, 0),
whatever its level mode. Deep files and parts, subsampled channels and an
unknown compression code raise a ValueError that names the file and what
it lacks, as OpenEXR's InputFile refuses the first two.

The layout (OpenEXR's file-format document): a magic number and a version
word whose flag bits mark tiled, deep and multipart files; a header of
(name, type, size, value) attributes up to an empty name (a multipart
file: one a part, then an empty one); one 64-bit offset a chunk (a
multipart file: each part's table in turn; a tiled part: every level's
tiles, level (0, 0) first); then the chunks (a multipart file's each
after its part number), each its first scanline y, or its tile x, tile
y, level x and level y, then its byte count and its data. A scanline
chunk holds `LINES[compression]` scanlines, a tile its tile's rows, both
cropped to the data window; uncompressed, each row holds each channel's
samples in turn, the channels in the header's (alphabetical) order,
little-endian. RLE and ZIP(S) data, once inflated, are split bytes (the
even bytes, then the odd) with a delta predictor on top; a chunk whose
stored size is at least its raw size is raw, as OpenEXR reads it.

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

DWAA and DWAB (32 and 256 lines a chunk; OpenEXR's DwaCompressor) sort the
channels by the rules the chunk carries (a channel-name suffix after the
last `.` and a pixel type; chunks of version 0 and 1 carry none and take
the legacy ones) into lossy ones (R, G, B, Y), run-length coded ones (A)
and the rest (UNKNOWN: kept whole, deflated); R, G and B under one prefix
form a set coded as Y'CbCr. A lossy channel is 8x8 blocks of half DCT
coefficients: the DC words deflated as ZIP's, the AC words run-length
coded in zig-zag order, then Huffman-coded as PIZ's (`huf_words`, the C++
decoder, or `huf_words_numpy`) or deflated. A block decodes through
OpenEXR's float inverse DCT, in the order of operations of its x86 build
(`dwa_idct`; a block with no AC takes its DC-only shortcut), a set through
the inverse Rec. 709 transform, then rounds to half and maps through the
nonlinear -> linear table `DWA_TO_LINEAR` (which a pLinear channel outside
a set skips). FLOAT channels coded lossy return that half widened. The
reader returns what OpenEXR's x86 reader returns, bit for bit.
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
LINES = {"NONE": 1, "RLE": 1, "ZIPS": 1, "ZIP": 16, "PIZ": 32, "PXR24": 16, "B44": 32, "B44A": 32, "DWAA": 32,
         "DWAB": 256}
PIXEL_TYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}  # UINT, HALF, FLOAT
LINE_ORDERS = ("INCREASING_Y", "DECREASING_Y", "RANDOM_Y")
LEVEL_MODES = ("ONE_LEVEL", "MIPMAP_LEVELS", "RIPMAP_LEVELS")
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
    tiles: Optional[Tuple[int, int, str, bool]] = None  # tile width, height, level mode, levels rounded up
    multipart: bool = False  # the first part of a multipart file (its chunks start with a part number)
    chunk_count: Optional[int] = None  # the part's chunkCount attribute, where it has one


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


def _attributes(buf: _Bytes) -> Dict[str, Tuple[str, bytes]]:
    """A header's (name, type, size, value) attributes, up to an empty name."""
    attrs: Dict[str, Tuple[str, bytes]] = {}
    while True:
        name = buf.cstr()
        if not name:
            return attrs
        kind = buf.cstr()
        (size,) = struct.unpack("<i", buf.take(4))
        attrs[name] = (kind, buf.take(size))


def read_header(buf: _Bytes) -> Header:
    """The header of a single-part file, or of a multipart file's first
    part (the part OpenEXR's InputFile reads); `buf` is left at the start
    of that part's offset table."""
    path = buf.path
    magic, version = struct.unpack("<ii", buf.take(8))
    if magic != MAGIC:
        raise ValueError(f"{path}: not an OpenEXR file (magic {magic:#x})")
    if version & DEEP:
        raise ValueError(f"{path}: a deep (non-image) file; the reader handles scanline and tiled images only")
    attrs = _attributes(buf)
    kind = ""  # a single part's type follows its version flags, as OpenEXR sets it
    if version & MULTIPART:
        for need in ("name", "type"):  # OpenEXR counts the chunks itself where chunkCount is missing
            if need not in attrs:
                raise ValueError(f"{path}: a multipart file whose first part has no {need!r} attribute")
        kind = attrs["type"][1].rstrip(b"\0").decode("latin-1")
        while _attributes(buf):  # the other parts' headers, up to an empty one
            pass
        tiled = kind == "tiledimage"
    else:  # the tiled flag decides; a scanline file's stray 'tiles' attribute is ignored, as OpenEXR does
        tiled = bool(version & TILED)
        if tiled and "tiles" not in attrs:
            raise ValueError(f"{path}: a tiled file whose header has no 'tiles' attribute")
    if kind not in ("", "scanlineimage", "tiledimage"):
        raise ValueError(f"{path}: a {kind} part; the reader handles scanline and tiled images only")
    for need in ("channels", "compression", "dataWindow", "lineOrder") + (("tiles",) if tiled else ()):
        if need not in attrs:
            raise ValueError(f"{path}: the header has no {need!r} attribute")
    code = attrs["compression"][1][0]
    if code >= len(COMPRESSIONS):
        raise ValueError(f"{path}: compression {code} is not an OpenEXR compression (the reader handles "
                         f"{', '.join(COMPRESSIONS)})")
    tiles = None
    if tiled:
        tw, th, mode = struct.unpack("<IIB", attrs["tiles"][1][:9])
        if mode & 0xF >= len(LEVEL_MODES) or mode >> 4 > 1 or not tw or not th:
            raise ValueError(f"{path}: a tile description ({tw} x {th}, mode {mode:#x}) OpenEXR does not define")
        tiles = (tw, th, LEVEL_MODES[mode & 0xF], bool(mode >> 4))
    order = attrs["lineOrder"][1][0]
    return Header(_channels(attrs["channels"][1], path), COMPRESSIONS[code],
                  struct.unpack("<iiii", attrs["dataWindow"][1]), LINE_ORDERS[order] if order < len(LINE_ORDERS)
                  else str(order), tiles, bool(version & MULTIPART),
                  struct.unpack("<i", attrs["chunkCount"][1])[0] if "chunkCount" in attrs else None)


def level_sizes(hdr: Header) -> List[Tuple[int, int]]:
    """(width, height) of each level of a tiled part, in the order of its
    offset table (level (0, 0) first; RIPMAP levels x fastest)."""
    xmin, ymin, xmax, ymax = hdr.data_window
    w, h = xmax - xmin + 1, ymax - ymin + 1
    _, _, mode, up = hdr.tiles

    def levels(n):  # OpenEXR's roundLog2 + 1
        return (n - 1).bit_length() + 1 if up else n.bit_length()

    def size(n, level):
        return max(-(-n >> level) if up else n >> level, 1)

    if mode == "ONE_LEVEL":
        return [(w, h)]
    if mode == "MIPMAP_LEVELS":
        return [(size(w, lv), size(h, lv)) for lv in range(levels(max(w, h)))]
    return [(size(w, lx), size(h, ly)) for ly in range(levels(h)) for lx in range(levels(w))]


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


def huf_words_numpy(data: bytes, n_out: int, path: str = "<Huffman>", what: str = "a PIZ chunk") -> np.ndarray:
    """OpenEXR's Huffman stream (ImfHuf; see csrc/exr_piz.cpp) -> n_out
    uint16 words: the plain version of `huf_words`."""
    if not data:
        if n_out:
            raise ValueError(f"{path}: {what} decodes to 0 words, not {n_out}")
        return np.zeros(0, np.uint16)
    if len(data) < 20:
        raise ValueError(f"{path}: {what} is truncated")
    im, top, _, n_bits, _ = struct.unpack_from("<5I", data)
    if im > top or top > 1 << 16:
        raise ValueError(f"{path}: {what} has an invalid Huffman table")
    bits = np.unpackbits(np.frombuffer(data, np.uint8, offset=20))
    lengths = np.zeros(top + 1, np.int64)
    pos, s = 0, im

    def field(n):
        nonlocal pos
        if pos + n > len(bits):
            raise ValueError(f"{path}: {what} is truncated")
        v = int(bits[pos:pos + n] @ (1 << np.arange(n - 1, -1, -1)))
        pos += n
        return v

    while s <= top:
        n = field(6)
        if n >= 59:  # a run of zero lengths: 2-5, or 6-261 in the next 8 bits
            run = field(8) + 6 if n == 63 else n - 57
            if s + run > top + 1:
                raise ValueError(f"{path}: {what} has an invalid Huffman table")
            s += run
        else:
            lengths[s] = n
            s += 1
    start = (pos + 7) // 8 * 8  # the codes start at the next byte
    if start + n_bits > len(bits):
        raise ValueError(f"{path}: {what} is truncated")
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
                raise ValueError(f"{path}: {what} has an invalid Huffman code")
            v = (v << 1) | stream[i]
            i += 1
            n += 1
            sym = codes.get((n, v))
            if sym is not None:
                break
        if sym == top:  # the run symbol: the last word again, 8 bits' worth of times
            if i + 8 > end or not out:
                raise ValueError(f"{path}: {what} has an invalid Huffman code")
            run = 0
            for b in stream[i:i + 8]:
                run = (run << 1) | b
            i += 8
            out.extend([out[-1]] * run)
        else:
            out.append(sym)
    if len(out) != n_out:
        raise ValueError(f"{path}: {what} decodes to {len(out)} words, not {n_out}")
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
    words = huf_words_numpy(buf.take(length), nx * ny * sum(sizes), path)
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
            lib.huf_words.restype = ctypes.c_int64
            lib.huf_words.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
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


def huf_words(data: bytes, n_out: int, path: str = "<Huffman>", what: str = "a DWA chunk's AC stream") -> np.ndarray:
    """`huf_words_numpy`'s words, decoded by `csrc/exr_piz.cpp`."""
    out = np.empty(n_out, np.uint16)
    status = _piz_lib().huf_words(data, len(data), out.ctypes.data, n_out)
    if status:
        raise ValueError(f"{path}: {what} {_PIZ_ERRORS.get(status, f'fails ({status})')}")
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


# ---------------------------------------------------------------- DWAA, DWAB
DWA_UNKNOWN, DWA_LOSSY, DWA_RLE = 0, 1, 2  # OpenEXR's CompressorScheme


class DwaRule(NamedTuple):
    """A channel rule of a DWA chunk: a channel whose name's last
    `.`-separated part is `suffix` (case-blind where `nocase`) and whose
    pixel type is `ptype` is coded by `scheme`; `csc` (0, 1, 2: R, G, B)
    joins it to the RGB set of its name's prefix."""
    suffix: str
    scheme: int
    ptype: int
    csc: int = -1
    nocase: bool = False


# the rules of chunks of version 0 and 1, which carry none
DWA_LEGACY_RULES = tuple(DwaRule(sfx, DWA_LOSSY, 1, csc, True) for sfx, csc in (
    ("r", 0), ("red", 0), ("g", 1), ("grn", 1), ("green", 1), ("b", 2), ("blu", 2), ("blue", 2),
    ("y", -1), ("by", -1), ("ry", -1))) + tuple(DwaRule("a", DWA_RLE, t, -1, True) for t in (0, 1, 2))
DWA_ZIGZAG = np.array([0, 1, 5, 6, 14, 15, 27, 28, 2, 4, 7, 13, 16, 26, 29, 42, 3, 8, 12, 17, 25, 30, 41, 43,
                       9, 11, 18, 24, 31, 40, 44, 53, 10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55,
                       60, 21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63])  # [row * 8 + col]
_DWA_COUNTS = struct.Struct("<11Q")
_F32 = np.float32


def _dwa_to_linear_table() -> np.ndarray:
    """OpenEXR's dwaCompressorToLinear: for every half bit pattern x of the
    stored (nonlinear) value, the half of |x|^2.2 where |x| <= 1, else of
    (e^2.2)^(|x| - 1), negated where x < 0 (so -0 maps to +0), each taken
    in float; 0 for infinities and NaNs."""
    x = np.arange(1 << 16, dtype=np.uint16).view(np.float16).astype(np.float64)
    a = np.abs(x)
    base = float(_F32(2.7182818 ** 2.2))
    with np.errstate(all="ignore"):
        lin = np.where(a <= 1, a ** float(_F32(2.2)), base ** (a - 1).astype(_F32).astype(np.float64)).astype(_F32)
        lin = np.where(x < 0, -lin, lin).astype(np.float16).view(np.uint16)
    lin[(np.arange(1 << 16) & 0x7C00) == 0x7C00] = 0
    return lin


DWA_TO_LINEAR = _dwa_to_linear_table()
_DWA_IDENTITY = np.arange(1 << 16, dtype=np.uint16)


# OpenEXR's 8x8 inverse DCT constants, .5 cos(k pi / 16) as its x86 code
# writes them (a: k = 4, b: 1, c: 2, d: 3, e: 5, f: 6, g: 7)
_IDCT_A, _IDCT_B, _IDCT_C, _IDCT_D, _IDCT_E, _IDCT_F, _IDCT_G = (_F32(v) for v in (
    3.535536e-01, 4.903927e-01, 4.619398e-01, 4.157349e-01, 2.777855e-01, 1.913422e-01, 9.754573e-02))


def _idct_rows(x: np.ndarray) -> np.ndarray:
    """The row pass along the last axis: each output the even inputs'
    products with one row of the even matrix summed in order, plus or
    minus the odd inputs' products summed in order."""
    a, b, c, d, e, f, g = _IDCT_A, _IDCT_B, _IDCT_C, _IDCT_D, _IDCT_E, _IDCT_F, _IDCT_G
    x0, x1, x2, x3, x4, x5, x6, x7 = (x[..., k] for k in range(8))
    even = (a * x0 + c * x2 + a * x4 + f * x6, a * x0 + f * x2 - a * x4 - c * x6,
            a * x0 - f * x2 - a * x4 + c * x6, a * x0 - c * x2 + a * x4 - f * x6)
    odd = (b * x1 + d * x3 + e * x5 + g * x7, d * x1 - g * x3 - b * x5 - e * x7,
           e * x1 - b * x3 + g * x5 + d * x7, g * x1 - e * x3 + d * x5 - b * x7)
    return np.stack([even[0] + odd[0], even[1] + odd[1], even[2] + odd[2], even[3] + odd[3],
                     even[3] - odd[3], even[2] - odd[2], even[1] - odd[1], even[0] - odd[0]], axis=-1)


def _idct_columns(x: np.ndarray) -> np.ndarray:
    """The column pass along the last axis: the even part through
    a (x0 +- x4) and c x2 +- f x6, the odd part's four products summed in
    pairs."""
    a, b, c, d, e, f, g = _IDCT_A, _IDCT_B, _IDCT_C, _IDCT_D, _IDCT_E, _IDCT_F, _IDCT_G
    x0, x1, x2, x3, x4, x5, x6, x7 = (x[..., k] for k in range(8))
    theta0, theta3 = a * (x0 + x4), a * (x0 - x4)
    theta1, theta2 = c * x2 + f * x6, f * x2 - c * x6
    gamma = (theta0 + theta1, theta3 + theta2, theta3 - theta2, theta0 - theta1)
    beta = ((b * x1 + d * x3) + (e * x5 + g * x7), (d * x1 - g * x3) - (b * x5 + e * x7),
            (e * x1 - b * x3) + (g * x5 + d * x7), (g * x1 - e * x3) + (d * x5 - b * x7))
    return np.stack([gamma[0] + beta[0], gamma[1] + beta[1], gamma[2] + beta[2], gamma[3] + beta[3],
                     gamma[3] - beta[3], gamma[2] - beta[2], gamma[1] - beta[1], gamma[0] - beta[0]], axis=-1)


def dwa_idct(coefs: np.ndarray, last: np.ndarray) -> np.ndarray:
    """[m, 64] float32 coefficients (rows of 8) -> [m, 64] float32 pixels:
    OpenEXR's inverse 8x8 DCT, rows then columns, in float32 with its x86
    build's order of operations (each rounds as there), or for a block whose
    AC words hold no literal (`last` == 0) its DC-only shortcut, every pixel
    dc a a."""
    out = np.empty_like(coefs)
    full = last > 0
    rows = _idct_rows(coefs[full].reshape(-1, 8, 8))
    out[full] = _idct_columns(rows.transpose(0, 2, 1)).transpose(0, 2, 1).reshape(-1, 64)
    out[~full] = (coefs[~full, :1] * _IDCT_A) * _IDCT_A
    return out


def _dwa_rules(data: bytes, pos: int, path: str) -> Tuple[List[DwaRule], int]:
    """A version-2 chunk's rules: a u16 byte count (itself included), then
    each rule's suffix, a byte of csc index + 1 (high 4 bits), scheme (2
    bits) and case-blindness (low bit), and a byte of pixel type."""
    if pos + 2 > len(data):
        raise ValueError(f"{path}: a DWA chunk is truncated")
    (size,) = struct.unpack_from("<H", data, pos)
    end = pos + size
    if size < 2 or end > len(data):
        raise ValueError(f"{path}: a DWA chunk has a rule table of {size} bytes")
    buf, rules = _Bytes(data[:end], path), []
    buf.pos = pos + 2
    while buf.pos < end:
        suffix = buf.cstr()
        flags, ptype = buf.take(2)
        csc, scheme = (flags >> 4) - 1, (flags >> 2) & 3
        if csc > 2 or scheme > DWA_RLE or ptype > 2:
            raise ValueError(f"{path}: a DWA chunk has an invalid rule for {suffix!r}")
        rules.append(DwaRule(suffix.lower() if flags & 1 else suffix, scheme, ptype, csc, bool(flags & 1)))
    return rules, end


def _dwa_classify(channels: Sequence[Channel], rules: Sequence[DwaRule]) -> Tuple[List[int], List[List[int]]]:
    """Each channel's scheme (the last rule that matches it, else UNKNOWN)
    and the RGB sets ([R, G, B] channel indices, by prefix in byte order)
    that decode together through the inverse YCbCr transform."""
    codes = {np.dtype(t): c for c, t in PIXEL_TYPES.items()}
    schemes, sets = [], {}
    for i, ch in enumerate(channels):
        prefix, _, suffix = ch.name.rpartition(".")
        trio = sets.setdefault(prefix, [-1, -1, -1])
        scheme = DWA_UNKNOWN
        for rule in rules:
            if rule.ptype == codes[ch.dtype] and (suffix.lower() if rule.nocase else suffix) == rule.suffix:
                scheme = rule.scheme
                if rule.csc >= 0:
                    trio[rule.csc] = i
        schemes.append(scheme)
    return schemes, [trio for _, trio in sorted(sets.items(), key=lambda kv: kv[0].encode("latin-1"))
                     if min(trio) >= 0]


def _dwa_ac_blocks(ac: np.ndarray, at: int, n_blocks: int, path: str) -> Tuple[np.ndarray, np.ndarray, int]:
    """The AC words of n_blocks blocks from ac[at:]: ([n_blocks, 64] uint16
    coefficients in zig-zag order, DC slot 0, each block's last literal
    position, the position past them). A word 0xff00 ends a block, 0xffnn
    skips nn zeros, any other word is the next coefficient."""
    words = ac[at:]
    run = (words >> 8) == 0xFF
    step = np.where(words == 0xFF00, 64, np.where(run, words & 0xFF, 1)).astype(np.int64)
    before = np.concatenate([[0], np.cumsum(step)])  # coefficients passed before each word
    # a block started at word s ends at the first word that takes it to 63 coefficients
    nxt = np.searchsorted(before[1:], before[:-1] + 63) + 1
    starts = np.empty(n_blocks + 1, np.int64)
    s, table, n = 0, nxt.tolist(), len(words)
    for k in range(n_blocks):
        if s >= n:
            raise ValueError(f"{path}: a DWA chunk's AC words end in block {k} of {n_blocks}")
        starts[k] = s
        s = table[s]
    starts[n_blocks] = s
    if s > n:
        raise ValueError(f"{path}: a DWA chunk's AC words end in block {n_blocks - 1} of {n_blocks}")
    idx = np.flatnonzero(~run[:s])
    block = np.searchsorted(starts, idx, side="right") - 1
    pos = 1 + before[idx] - before[starts[block]]
    coefs = np.zeros((n_blocks, 64), np.uint16)
    coefs[block, pos] = words[idx]
    last = np.zeros(n_blocks, np.int64)
    np.maximum.at(last, block, pos)
    return coefs, last, at + int(s)


def _dwa_lossy(ac: np.ndarray, ac_at: int, dc: np.ndarray, dc_at: int, trio: List[int], w: int, n: int,
               lut: np.ndarray, path: str) -> Tuple[List[np.ndarray], int, int]:
    """One lossy decoder (an RGB set, or one channel): [n, w] half bit
    patterns of each of its channels, and where its AC and DC words end.
    Blocks run in rows of 8x8, each block's channels in turn; the DC words
    hold each channel's blocks in turn."""
    k, nby, nbx = len(trio), -(-n // 8), -(-w // 8)
    nb = nby * nbx
    if dc_at + k * nb > len(dc):
        raise ValueError(f"{path}: a DWA chunk's DC words end before its blocks do")
    zig, last, ac_end = _dwa_ac_blocks(ac, ac_at, nb * k, path)
    zig[:, 0] = dc[dc_at:dc_at + k * nb].reshape(k, nb).T.reshape(-1)  # block-major, channel fastest
    coefs = zig[:, DWA_ZIGZAG].view(np.float16).astype(_F32)
    px = dwa_idct(coefs, last).reshape(nb, k, 64)
    if k == 3:  # Y'CbCr -> R'G'B', Rec. 709
        y, cb, cr = px[:, 0], px[:, 1], px[:, 2]
        px = np.stack([y + _F32(1.5747) * cr, y - _F32(0.1873) * cb - _F32(0.4682) * cr,
                       y + _F32(1.8556) * cb], axis=1)
    bits = lut[px.astype(np.float16).view(np.uint16)]
    out = bits.reshape(nby, nbx, k, 8, 8).transpose(2, 0, 3, 1, 4).reshape(k, nby * 8, nbx * 8)[:, :n, :w]
    return list(out), ac_end, dc_at + k * nb


def _dwa(data: bytes, channels: List[Channel], w: int, n: int, path: str, native: bool) -> bytes:
    """DWAA and DWAB (OpenEXR's DwaCompressor): eleven u64 counts, the
    rules (version 2), then four sections: UNKNOWN channels' rows deflated;
    the lossy channels' AC words (Huffman-coded as PIZ's, or deflated);
    their DC words (deflated with ZIP's byte split and predictor); RLE
    channels' byte planes, run-length coded and deflated."""
    if len(data) < _DWA_COUNTS.size:
        raise ValueError(f"{path}: a DWA chunk is truncated")
    (version, unknown_raw, unknown_size, ac_size, dc_size, rle_size, rle_packed, rle_raw, ac_count, dc_count,
     ac_coding) = _DWA_COUNTS.unpack_from(data)
    if version > 2:
        raise ValueError(f"{path}: a DWA chunk of version {version} (OpenEXR writes 0 to 2)")
    rules, pos = (_dwa_rules(data, _DWA_COUNTS.size, path) if version == 2
                  else (list(DWA_LEGACY_RULES), _DWA_COUNTS.size))
    if pos + unknown_size + ac_size + dc_size + rle_size > len(data):
        raise ValueError(f"{path}: a DWA chunk is truncated")
    sections = []
    for size in (unknown_size, ac_size, dc_size, rle_size):
        sections.append(data[pos:pos + size])
        pos += size
    unknown = zlib.decompress(sections[0]) if unknown_size else b""
    if ac_coding == 0:  # OpenEXR's static Huffman
        ac = ((huf_words if native else huf_words_numpy)(sections[1], ac_count, path, "a DWA chunk's AC stream")
              if ac_size else None)
    elif ac_coding == 1:
        ac = np.frombuffer(zlib.decompress(sections[1]), "<u2") if ac_size else None
    else:
        raise ValueError(f"{path}: a DWA chunk's AC coding is {ac_coding} (OpenEXR's are 0 Huffman, 1 deflate)")
    ac = np.zeros(0, np.uint16) if ac is None else ac.astype(np.uint16)
    dc = np.frombuffer(_unpredict(zlib.decompress(sections[2])), "<u2") if dc_size else np.zeros(0, np.uint16)
    rle_packed_got = zlib.decompress(sections[3]) if rle_raw else b""
    if (len(unknown), ac.size, dc.size, len(rle_packed_got)) != (unknown_raw, ac_count, dc_count,
                                                                rle_packed if rle_raw else 0):
        raise ValueError(f"{path}: a DWA chunk's sections do not hold the sizes its counts give")
    rle = _rle_decode(rle_packed_got, rle_raw, path) if rle_raw else b""
    schemes, sets = _dwa_classify(channels, rules)
    rows: List[Optional[np.ndarray]] = [None] * len(channels)
    ac_at = dc_at = 0
    for trio in sets + [[i] for i, s in enumerate(schemes) if s == DWA_LOSSY and all(i not in t for t in sets)]:
        for i in trio:
            if schemes[i] != DWA_LOSSY or channels[i].dtype.kind != "f":
                raise ValueError(f"{path}: a DWA chunk codes channel {channels[i].name!r} lossy, "
                                 "which OpenEXR does for HALF and FLOAT channels of an RGB set or a lossy rule")
        lut = DWA_TO_LINEAR if len(trio) == 3 or not channels[trio[0]].linear else _DWA_IDENTITY
        bits, ac_at, dc_at = _dwa_lossy(ac, ac_at, dc, dc_at, trio, w, n, lut, path)
        for i, b in zip(trio, bits):
            half = b.astype("<u2").view(np.float16)
            rows[i] = (half if channels[i].dtype.itemsize == 2 else half.astype("<f4")).view(np.uint8).reshape(n, -1)
    at = {DWA_UNKNOWN: 0, DWA_RLE: 0}
    for i, (ch, scheme) in enumerate(zip(channels, schemes)):
        if scheme == DWA_LOSSY:
            continue
        size = n * w * ch.dtype.itemsize
        src = unknown if scheme == DWA_UNKNOWN else rle
        if at[scheme] + size > len(src):
            raise ValueError(f"{path}: a DWA chunk's {'UNKNOWN' if scheme == DWA_UNKNOWN else 'RLE'} "
                             "section ends before its channels do")
        plane = np.frombuffer(src, np.uint8, size, at[scheme])
        if scheme == DWA_RLE:  # byte planes: every pixel's first byte, then every second byte, ...
            plane = plane.reshape(ch.dtype.itemsize, n * w).T
        rows[i] = np.ascontiguousarray(plane).reshape(n, -1)
        at[scheme] += size
    return np.concatenate(rows, axis=1).tobytes()


def _decompress(data: bytes, hdr: Header, w: int, n: int, path: str, native: bool = True) -> bytes:
    """The raw scanline bytes of a chunk of n rows of w pixels."""
    size = n * w * sum(ch.dtype.itemsize for ch in hdr.channels)
    compression = hdr.compression
    if compression == "NONE" or len(data) >= size:  # OpenEXR reads a chunk that does not shrink as raw
        return data[:size]
    if compression == "PIZ":
        return _piz(data, hdr.channels, w, n, path, native)
    if compression == "PXR24":
        return _pxr24(data, hdr.channels, w, n, path)
    if compression in ("B44", "B44A"):
        return _b44(data, hdr.channels, w, n, path)
    if compression in ("DWAA", "DWAB"):
        return _dwa(data, hdr.channels, w, n, path, native)
    if compression == "RLE":
        return _unpredict(_rle_decode(data, size, path))
    raw = zlib.decompress(data)
    if len(raw) != size:
        raise ValueError(f"{path}: a {compression} chunk inflates to {len(raw)} bytes, not {size}")
    return _unpredict(raw)


def read_exr(path: str, native: bool = True) -> Tuple[Header, Dict[str, np.ndarray]]:
    """(header, {channel name: [H, W] array in its pixel type: float16,
    float32 or uint32}) of a single-part file or a multipart file's first
    part, scanline or tiled (its full-resolution level); PIZ chunks and DWA
    AC words through the C++ Huffman decoder, or numpy's without `native`."""
    with open(path, "rb") as f:
        buf = _Bytes(f.read(), path)
    hdr = read_header(buf)
    xmin, ymin, xmax, ymax = hdr.data_window
    w, h = xmax - xmin + 1, ymax - ymin + 1
    if hdr.tiles:
        tw, th = hdr.tiles[:2]
        nx, ny = -(-w // tw), -(-h // th)
        n_table = sum(-(-lw // tw) * -(-lh // th) for lw, lh in level_sizes(hdr))
    else:
        tw, th = w, LINES[hdr.compression]
        nx, ny = 1, -(-h // th)
        n_table = ny
    if hdr.multipart and hdr.chunk_count not in (None, n_table):
        raise ValueError(f"{path}: the first part's chunkCount is {hdr.chunk_count}, its layout has {n_table}")
    offsets = struct.unpack(f"<{n_table}Q", buf.take(8 * n_table))[:nx * ny]  # level (0, 0) comes first
    planes = {ch.name: np.empty((h, w), ch.dtype) for ch in hdr.channels}
    seen = np.zeros((ny, nx), bool)
    for off in offsets:
        chunk = _Bytes(buf.data, path)
        chunk.pos = off
        if hdr.multipart:
            (part,) = struct.unpack("<i", chunk.take(4))
            if part != 0:
                raise ValueError(f"{path}: the first part's offset table points at a chunk of part {part}")
        if hdr.tiles:
            tx, ty, lx, ly, size = struct.unpack("<5i", chunk.take(20))
            if (lx, ly) != (0, 0) or not (0 <= tx < nx and 0 <= ty < ny):
                raise ValueError(f"{path}: a level-0 offset points at tile ({tx}, {ty}) of level ({lx}, {ly})")
        else:
            y, size = struct.unpack("<ii", chunk.take(8))
            if y < ymin or y > ymax or (y - ymin) % th:
                raise ValueError(f"{path}: a chunk starts at scanline {y}, outside the data window {hdr.data_window}")
            tx, ty = 0, (y - ymin) // th
        x0, y0 = tx * tw, ty * th
        cw, n = min(tw, w - x0), min(th, h - y0)
        raw = np.frombuffer(_decompress(chunk.take(size), hdr, cw, n, path, native), np.uint8)
        if raw.size != n * cw * sum(ch.dtype.itemsize for ch in hdr.channels):
            raise ValueError(f"{path}: a {hdr.compression} chunk holds {raw.size} bytes, not {n} rows of {cw} pixels")
        pos = 0
        for ch in hdr.channels:  # each row holds each channel's samples in turn
            nb = cw * ch.dtype.itemsize
            rows = raw.reshape(n, -1)[:, pos:pos + nb]
            planes[ch.name][y0:y0 + n, x0:x0 + cw] = rows.copy().view(ch.dtype)
            pos += nb
        seen[ty, tx] = True
    if not seen.all():
        raise ValueError(f"{path}: {int((~seen).sum())} of {nx * ny} chunks missing")
    return hdr, planes
