"""The port's EXR reader (`pipeline/exr.py`) and converter (`convert_exr.py`)
against the JAX tool (`tools/convert_exr.py`), on the CPU.

EXR files are written here byte by byte from the OpenEXR file layout
(`write_exr`: `struct` and `zlib`, independent of the port's reader): NONE,
RLE, ZIPS, ZIP, PIZ (the test's own bitmap, wavelet and Huffman encoder)
and PXR24 (with its own 24-bit rounding, `float24`); HALF, FLOAT and UINT
channels; both line orders; a data
window off the origin; Blender's multilayer channel names in both
view-layer namings; single-layer RGBA files and an RGB file with an
Image -> Depth sibling. Each case runs the JAX tool's own `convert_one` on
the same arrays: its multilayer branch through stub `OpenEXR` / `Imath`
modules that serve them (as OpenEXR reads a channel as FLOAT), its OpenCV
branch (OpenEXR unimportable) through a stub `cv2.imread` that returns them
as OpenCV does (BGR(A) float32; this cv2 has no EXR codec). The file names,
the `.npy` bytes and the PNG pixels must be equal. PIZ is read by both
decoders, the C++ one and the numpy one, bit for bit, also where the
wavelet runs modular (more than 2^14 distinct words in a chunk); four
small files written by OpenEXR itself are kept as bytes. B44(A), DWAA/B,
tiled, deep and multipart files, subsampled channels and a file without
RGB raise errors that name what they lack.
"""
import base64
import importlib.util
import os
import struct
import sys
import types
import zlib

import numpy as np
import pytest
from PIL import Image

from sgam_neurips22_tpu_torch import convert_exr as t_conv
from sgam_neurips22_tpu_torch.pipeline import exr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 37, 29  # ZIP's 16-line chunks end with a chunk of 5 lines
COMPRESSION_CODES = {"NONE": 0, "RLE": 1, "ZIPS": 2, "ZIP": 3, "PIZ": 4, "PXR24": 5, "B44": 6, "B44A": 7,
                     "DWAA": 8, "DWAB": 9}
CHUNK_LINES = {"NONE": 1, "RLE": 1, "ZIPS": 1, "ZIP": 16, "PIZ": 32, "PXR24": 16}
PIXEL_CODE = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1, np.dtype(np.float32): 2}
ARRAYS = {}  # path -> {channel: array}: what the stubs serve
# single-channel ("Y") 4 x 33 files written by OpenEXR (cv2.imwrite, OpenCV 4.13) from `_openexr_arrays`:
# the PIZ files' first chunk and the PXR24 files' first two are stored compressed
OPENEXR_STREAMS = {
    "PIZ_HALF": (
        "di8xAQIAAABjaGFubmVscwBjaGxpc3QAEwAAAFkAAQAAAAAAAAABAAAAAQAAAABjb21wcmVzc2lvbgBjb21wcmVzc2lvbgABAAAA"
        "BGRhdGFXaW5kb3cAYm94MmkAEAAAAAAAAAAAAAAAAwAAACAAAABkaXNwbGF5V2luZG93AGJveDJpABAAAAAAAAAAAAAAAAMAAAAg"
        "AAAAbGluZU9yZGVyAGxpbmVPcmRlcgABAAAAAHBpeGVsQXNwZWN0UmF0aW8AZmxvYXQABAAAAAAAgD9zY3JlZW5XaW5kb3dDZW50"
        "ZXIAdjJmAAgAAAAAAAAAAAAAAHNjcmVlbldpbmRvd1dpZHRoAGZsb2F0AAQAAAAAAIA/ACUBAAAAAAAAmgEAAAAAAAAAAAAAbQAA"
        "AIkHmQf+////////////////////AVQAAAAAAAAAeQAAABgAAAA8AQAAAAAAAAghAAvA/wkf8JH/CR/wkf8JH/CR/wkccA0Numbd"
        "Cw26Zt0JDbpm3QcNumbdBQ26Zt0DDbpm3QENumbdMNumbdAgAAAACAAAAEg8RzxGPEU8"
    ),
    "PIZ_FLOAT": (
        "di8xAQIAAABjaGFubmVscwBjaGxpc3QAEwAAAFkAAgAAAAAAAAABAAAAAQAAAABjb21wcmVzc2lvbgBjb21wcmVzc2lvbgABAAAA"
        "BGRhdGFXaW5kb3cAYm94MmkAEAAAAAAAAAAAAAAAAwAAACAAAABkaXNwbGF5V2luZG93AGJveDJpABAAAAAAAAAAAAAAAAMAAAAg"
        "AAAAbGluZU9yZGVyAGxpbmVPcmRlcgABAAAAAHBpeGVsQXNwZWN0UmF0aW8AZmxvYXQABAAAAAAAgD9zY3JlZW5XaW5kb3dDZW50"
        "ZXIAdjJmAAgAAAAAAAAAAAAAAHNjcmVlbldpbmRvd1dpZHRoAGZsb2F0AAQAAAAAAIA/ACUBAAAAAAAAuAEAAAAAAAAAAAAAiwAA"
        "APAHCQgBAAAAAAAAAAD+////////////////////AWkAAAAAAAAAegAAABkAAADZAQAAAAAAAAQhQA/BR/wkj8JH/CR/wkf8JH/C"
        "R/wkcgAOsVnnjvZ54ZYrPPHezzwqxWeeO9nnhFis88d7PPBrFZ5472eeCWKzzx3s88AWKzzx3s88CsVnnjvZ54AgAAAAEAAAAMg/"
        "gD/HP4A/xj+AP8U/gD8="
    ),
    "PXR24_HALF": (
        "di8xAQIAAABjaGFubmVscwBjaGxpc3QAEwAAAFkAAQAAAAAAAAABAAAAAQAAAABjb21wcmVzc2lvbgBjb21wcmVzc2lvbgABAAAA"
        "BWRhdGFXaW5kb3cAYm94MmkAEAAAAAAAAAAAAAAAAwAAACAAAABkaXNwbGF5V2luZG93AGJveDJpABAAAAAAAAAAAAAAAAMAAAAg"
        "AAAAbGluZU9yZGVyAGxpbmVPcmRlcgABAAAAAHBpeGVsQXNwZWN0UmF0aW8AZmxvYXQABAAAAAAAgD9zY3JlZW5XaW5kb3dDZW50"
        "ZXIAdjJmAAgAAAAAAAAAAAAAAHNjcmVlbldpbmRvd1dpZHRoAGZsb2F0AAQAAAAAAIA/AC0BAAAAAAAAeQEAAAAAAADMAQAAAAAA"
        "AAAAAABEAAAAeJyFzNERgDAIA1Baz7qRZ+3+Q6k0UcIA5ucdgaPTFvtyYL1StHDQ1Y+nyr90o+52tFtz8Zoy9/QtPGFFfzERvkaI"
        "FaYQAAAASwAAAHicLcxRDoAwCAPQCpteaDGy3f9QBocKg5+XtKQyecN//dXdPcmq2w4l93oiRjc2VwB1hwUY9+pFS/y3gtybmaOm"
        "WHvEuR9+JFAWhSAAAAAIAAAAADsANAA6ADk="
    ),
    "PXR24_FLOAT": (
        "di8xAQIAAABjaGFubmVscwBjaGxpc3QAEwAAAFkAAgAAAAAAAAABAAAAAQAAAABjb21wcmVzc2lvbgBjb21wcmVzc2lvbgABAAAA"
        "BWRhdGFXaW5kb3cAYm94MmkAEAAAAAAAAAAAAAAAAwAAACAAAABkaXNwbGF5V2luZG93AGJveDJpABAAAAAAAAAAAAAAAAMAAAAg"
        "AAAAbGluZU9yZGVyAGxpbmVPcmRlcgABAAAAAHBpeGVsQXNwZWN0UmF0aW8AZmxvYXQABAAAAAAAgD9zY3JlZW5XaW5kb3dDZW50"
        "ZXIAdjJmAAgAAAAAAAAAAAAAAHNjcmVlbldpbmRvd1dpZHRoAGZsb2F0AAQAAAAAAIA/AC0BAAAAAAAAiAEAAAAAAADrAQAAAAAA"
        "AAAAAABTAAAAeJyVjlsNwFAIQysFJQMpSEHKlVIpOGGEhWW/69cJj7ZagCQcLS0UeOThXpBc9oy9gbsN/5W2vSDn9+qstrd3LvHh"
        "xOZKRm6uEdutnGe63WVtKoEQAAAAWwAAAHicTY7BDQAhCAS3FCo5KWVLoRRKoRQ74VCjwQeZkMngSECcgnojEzoZiz8kQsMv26Qe"
        "p4ZtZXFqHH8AWRHeDoPXAeX5EJqeZmUM7a43B9747WHK9p/NP/K7LlogAAAAEAAAAAAAYD8AAIA+AABAPwAAID8="
    ),
}


# ------------------------------------------------------------ the test's writer
def _split_predict(raw: bytes) -> bytes:
    """OpenEXR's byte split (even bytes, then odd) and delta predictor."""
    b = np.frombuffer(raw, np.uint8)
    t = np.concatenate([b[0::2], b[1::2]]).astype(np.int64)
    out = t.copy()
    out[1:] = (t[1:] - t[:-1] + 128 + 256) % 256
    return out.astype(np.uint8).tobytes()


def _rle(data: bytes) -> bytes:
    """Runs of 3 to 128 equal bytes as (n - 1, byte), stretches of up to
    127 other bytes as (-n, bytes)."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j + 1 - i < 128:
            j += 1
        if j - i + 1 >= 3:
            out += struct.pack("b", j - i) + data[i:i + 1]
            i = j + 1
            continue
        j = i
        while j < n and j - i < 127 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += struct.pack("b", -(j - i)) + data[i:j]
        i = j
    return bytes(out)


def _compress(raw: bytes, compression: str, block=None) -> bytes:
    """A chunk's data: `raw`, its scanline bytes, or for PIZ and PXR24
    `block`, each channel's rows of the chunk ([n, W] little-endian)."""
    if compression == "NONE":
        return raw
    if compression == "PIZ":
        data = _piz(block)
    elif compression == "PXR24":
        data = _pxr24(block)
    else:
        packed = _split_predict(raw)
        data = _rle(packed) if compression == "RLE" else zlib.compress(packed)
    return data if len(data) < len(raw) else raw  # stored raw where it does not shrink, as OpenEXR does


def float24(a: np.ndarray) -> np.ndarray:
    """OpenEXR's PXR24 rounding of float32 to 24 bits (ImfPxr24Compressor's
    floatToFloat24), as the float32 the reader returns: the significand
    rounded to 15 bits, half away from zero in magnitude; truncated where
    rounding would overflow to infinity; NaNs keep a set bit."""
    u = a.astype(np.float32).view(np.uint32).astype(np.int64)
    s, e, m = u & 0x80000000, u & 0x7F800000, u & 0x007FFFFF
    rounded = ((e | m) + (m & 0x80)) >> 8
    finite = np.where(rounded >= 0x7F8000, (e | m) >> 8, rounded)
    special = np.where(m != 0, (e >> 8) | (m >> 8) | ((m >> 8) == 0), e >> 8)
    i = np.where(e == 0x7F800000, special, finite)
    return (((s >> 8) | i) << 8).astype(np.uint32).view(np.float32)


def _pxr24(block) -> bytes:
    """PXR24: each row of each channel as byte planes (most significant
    first) of its samples' differences, UINT 4 planes, HALF 2, FLOAT 3 of
    its 24-bit rounding; deflated."""
    out = bytearray()
    for r in range(block[0].shape[0]):
        for b in block:
            if b.dtype == np.float32:
                bits, planes = float24(b[r]).view(np.uint32).astype(np.int64) >> 8, (16, 8, 0)
            elif b.dtype == np.float16:
                bits, planes = b[r].view(np.uint16).astype(np.int64), (8, 0)
            else:
                bits, planes = b[r].astype(np.int64), (24, 16, 8, 0)
            diff = np.diff(bits, prepend=0) % (1 << 32)
            for shift in planes:
                out += ((diff >> shift) & 0xFF).astype(np.uint8).tobytes()
    return zlib.compress(bytes(out))


class _BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int):
        self.bits.extend((value >> (n - 1 - i)) & 1 for i in range(n))

    def tobytes(self) -> bytes:
        pad = self.bits + [0] * (-len(self.bits) % 8)
        return np.packbits(np.array(pad, np.uint8)).tobytes() if pad else b""


def _huffman_lengths(freq: dict) -> dict:
    """Code lengths of a Huffman code for {symbol: count}."""
    import heapq

    heap = [(f, i, [s]) for i, (s, f) in enumerate(sorted(freq.items()))]
    heapq.heapify(heap)
    depth = dict.fromkeys(freq, 0)
    tie = len(heap)
    while len(heap) > 1:
        f1, _, a = heapq.heappop(heap)
        f2, _, b = heapq.heappop(heap)
        for sym in a + b:
            depth[sym] += 1
        heapq.heappush(heap, (f1 + f2, tie, a + b))
        tie += 1
    return depth


def _canonical(lengths: dict) -> dict:
    """OpenEXR's canonical codes from code lengths: the lowest code of each
    length, longer lengths first, symbols of a length in order."""
    count = [0] * 59
    for n in lengths.values():
        count[n] += 1
    start, c = [0] * 59, 0
    for n in range(58, 0, -1):
        start[n], c = c, (c + count[n]) >> 1
    codes = {}
    for sym in sorted(lengths):
        codes[sym] = (start[lengths[sym]], lengths[sym])
        start[lengths[sym]] += 1
    return codes


def _huffman(words: np.ndarray) -> bytes:
    """OpenEXR's Huffman stream of 16-bit words: a run symbol one past the
    largest word, runs of a repeated word sent as (word, run, 8-bit count)
    where that is shorter, the packed table of code lengths."""
    values, counts = np.unique(words, return_counts=True)
    im, run_sym = int(values[0]), int(values[-1]) + 1
    lengths = _huffman_lengths({**dict(zip(values.tolist(), counts.tolist())), run_sym: 1})
    codes = _canonical(lengths)
    table = _BitWriter()
    s = im
    while s <= run_sym:
        if s in lengths:
            table.put(lengths[s], 6)
            s += 1
            continue
        run = 1
        while s + run <= run_sym and s + run not in lengths and run < 261:
            run += 1
        if run == 1:
            table.put(0, 6)
        elif run < 6:
            table.put(59 + run - 2, 6)
        else:
            table.put(63, 6)
            table.put(run - 6, 8)
        s += run
    data = _BitWriter()

    def send(sym, repeats):  # sym once and `repeats` more times
        code, n = codes[sym]
        rc, rn = codes[run_sym]
        if n + rn + 8 < n * repeats:
            data.put(code, n)
            data.put(rc, rn)
            data.put(repeats, 8)
        else:
            for _ in range(repeats + 1):
                data.put(code, n)

    seq, cur, reps = words.tolist(), None, 0
    for i, w in enumerate(seq):
        if i and w == cur and reps < 255:
            reps += 1
            continue
        if i:
            send(cur, reps)
        cur, reps = w, 0
    send(cur, reps)
    tab = table.tobytes()
    return struct.pack("<5I", im, run_sym, len(tab), len(data.bits), 0) + tab + data.tobytes()


def _wenc(a: np.ndarray, b: np.ndarray, w14: bool):
    """OpenEXR's wavelet step: (mean, difference) of 16-bit words, plain
    below 2^14, modular above."""
    a32, b32 = a.astype(np.int64), b.astype(np.int64)
    if w14:
        sa, sb = a.view(np.int16).astype(np.int64), b.view(np.int16).astype(np.int64)
        return ((sa + sb) >> 1) & 0xFFFF, (sa - sb) & 0xFFFF
    ao = (a32 + 0x8000) & 0xFFFF
    m, d = (ao + b32) >> 1, ao - b32
    m = np.where(d < 0, (m + 0x8000) & 0xFFFF, m)
    return m, d & 0xFFFF


def _wav2_encode(a: np.ndarray, max_value: int) -> None:
    """OpenEXR's 2D wavelet of the [ny, nx] uint16 view `a`, in place, from
    the finest level up."""
    w14 = max_value < 1 << 14
    ny, nx = a.shape
    p, p2 = 1, 2
    while p2 <= min(nx, ny):
        ye, xe = ny // p2 * p2, nx // p2 * p2
        px, p01, p10, p11 = a[0:ye:p2, 0:xe:p2], a[0:ye:p2, p:xe:p2], a[p:ye:p2, 0:xe:p2], a[p:ye:p2, p:xe:p2]
        i00, i01 = _wenc(px, p01, w14)
        i10, i11 = _wenc(p10, p11, w14)
        px[...], p10[...] = _wenc(i00.astype(np.uint16), i10.astype(np.uint16), w14)
        p01[...], p11[...] = _wenc(i01.astype(np.uint16), i11.astype(np.uint16), w14)
        if nx & p:
            a[0:ye:p2, xe], a[p:ye:p2, xe] = _wenc(a[0:ye:p2, xe], a[p:ye:p2, xe], w14)
        if ny & p:
            a[ye, 0:xe:p2], a[ye, p:xe:p2] = _wenc(a[ye, 0:xe:p2], a[ye, p:xe:p2], w14)
        p, p2 = p2, p2 << 1


def _piz(block) -> bytes:
    """PIZ: the chunk's 16-bit words (channel after channel, a 32-bit
    sample's low word first) mapped to their ranks among the values
    present (a bitmap of which is stored), each channel's word planes
    wavelet-transformed, then Huffman-coded."""
    planes = [np.ascontiguousarray(b).view("<u2").reshape(b.shape[0], -1) for b in block]
    words = np.concatenate([p.reshape(-1) for p in planes])
    present = np.zeros(1 << 16, bool)
    present[words] = True
    present[0] = False
    bitmap = np.packbits(present, bitorder="little")
    nz = np.flatnonzero(bitmap)
    lo, hi = (int(nz[0]), int(nz[-1])) if len(nz) else (8191, 0)
    present[0] = True
    rank = np.cumsum(present).astype(np.int64) - 1
    max_value = int(rank[-1])
    out, at = rank[words].astype(np.uint16), 0
    for b, p in zip(block, planes):
        plane = out[at:at + p.size].reshape(p.shape)
        size = b.dtype.itemsize // 2
        for j in range(size):
            _wav2_encode(plane[:, j::size], max_value)
        at += p.size
    huf = _huffman(out)
    head = struct.pack("<HH", lo, hi) + (bitmap[lo:hi + 1].tobytes() if lo <= hi else b"")
    return head + struct.pack("<i", len(huf)) + huf


def _attr(name: str, kind: str, value: bytes) -> bytes:
    return name.encode() + b"\0" + kind.encode() + b"\0" + struct.pack("<i", len(value)) + value


def write_exr(path, channels: dict, compression: str = "ZIP", decreasing: bool = False, origin=(0, 0),
              version_flags: int = 0, extra_attrs: bytes = b"", sampling=(1, 1)) -> dict:
    """A scanline single-part OpenEXR file of `channels` ({name: [H, W]
    float16 / float32 / uint32}); returns {"chunks", "compressed"}: the
    chunk count and how many of them are stored compressed. The stubs
    serve the arrays under `path`."""
    names = sorted(channels)
    h, w = channels[names[0]].shape
    x0, y0 = origin
    chlist = b"".join(n.encode() + b"\0" + struct.pack("<iB3xii", PIXEL_CODE[channels[n].dtype], 0, *sampling)
                      for n in names) + b"\0"
    box = struct.pack("<iiii", x0, y0, x0 + w - 1, y0 + h - 1)
    header = (_attr("channels", "chlist", chlist)
              + _attr("compression", "compression", bytes([COMPRESSION_CODES[compression]]))
              + _attr("dataWindow", "box2i", box) + _attr("displayWindow", "box2i", box)
              + _attr("lineOrder", "lineOrder", bytes([1 if decreasing else 0]))
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
              + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)) + extra_attrs + b"\0")
    lines = CHUNK_LINES.get(compression, 32)
    starts = list(range(0, h, lines))
    chunks, compressed = {}, 0
    held = {n: channels[n].copy() for n in names}  # what the file holds: PXR24 rounds FLOAT to 24 bits
    for s in starts:
        block = [np.ascontiguousarray(channels[n][s:s + lines]).astype(channels[n].dtype.newbyteorder("<"))
                 for n in names]
        raw = b"".join(b[r].tobytes() for r in range(len(block[0])) for b in block)
        data = _compress(raw, compression, block)
        compressed += len(data) < len(raw)
        if compression == "PXR24" and len(data) < len(raw):
            for n in names:
                if held[n].dtype == np.float32:
                    held[n][s:s + lines] = float24(held[n][s:s + lines])
        chunks[s] = struct.pack("<ii", y0 + s, len(data)) + data
    prefix = struct.pack("<ii", 20000630, 2 | version_flags) + header
    table_end = len(prefix) + 8 * len(starts)
    offsets, body, pos = {}, b"", table_end
    for s in (reversed(starts) if decreasing else starts):
        offsets[s] = pos
        body += chunks[s]
        pos += len(chunks[s])
    with open(path, "wb") as f:
        f.write(prefix + b"".join(struct.pack("<Q", offsets[s]) for s in starts) + body)
    ARRAYS[str(path)] = held | {"_origin": origin}
    return {"chunks": len(starts), "compressed": compressed}


def smooth(rng, h, w, dtype):
    """A smooth field with a little noise: it compresses, so each codec's
    decoder runs."""
    yy, xx = np.mgrid[0:h, 0:w]
    f = 0.5 + 0.4 * np.sin(yy / 5.0 + rng.uniform(0, 6)) * np.cos(xx / 7.0) + rng.uniform(0, 0.01, (h, w))
    if dtype == np.uint32:
        return (f * 8).astype(np.uint32)
    return (f * 1.3).astype(dtype)


# ---------------------------------------------------------- the JAX tool's stubs
class _PixelType:
    FLOAT = 2

    def __init__(self, v):
        self.v = v


class _InputFile:
    """OpenEXR.InputFile over ARRAYS: channel() returns FLOAT bytes."""

    def __init__(self, path):
        self.arrays = ARRAYS[str(path)]

    def header(self):
        (x0, y0), (h, w) = self.arrays["_origin"], next(v for k, v in self.arrays.items() if k != "_origin").shape
        p = types.SimpleNamespace
        return {"dataWindow": p(min=p(x=x0, y=y0), max=p(x=x0 + w - 1, y=y0 + h - 1)),
                "channels": {k: None for k in self.arrays if k != "_origin"}}

    def channel(self, name, pixel_type):
        assert pixel_type.v == _PixelType.FLOAT
        return np.ascontiguousarray(self.arrays[name], np.float32).tobytes()


def _cv2_imread(path, flags):
    """cv2.imread of an EXR as OpenCV returns it: B, G, R(, A) float32, or
    one channel [H, W]; None for a missing file."""
    arrays = ARRAYS.get(str(path))
    if arrays is None or not os.path.exists(path):
        return None
    chans = {k: v.astype(np.float32) for k, v in arrays.items() if k != "_origin"}
    if len(chans) == 1:
        return next(iter(chans.values()))
    return np.stack([chans[c] for c in ("B", "G", "R", "A") if c in chans], axis=2)


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_convert_exr", os.path.join(REPO, "tools", "convert_exr.py"))
    mod = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENCV_IO_ENABLE_OPENEXR", "1")  # the tool sets it at import
        spec.loader.exec_module(mod)
    return mod


def _jax_convert(jax_tool, path, out, index, monkeypatch, multilayer: bool):
    import cv2

    with monkeypatch.context() as mp:
        if multilayer:
            mp.setitem(sys.modules, "OpenEXR", types.SimpleNamespace(InputFile=_InputFile))
            mp.setitem(sys.modules, "Imath", types.SimpleNamespace(PixelType=_PixelType))
        else:
            mp.setitem(sys.modules, "OpenEXR", None)
            mp.setattr(cv2, "imread", _cv2_imread)
        jax_tool.convert_one(str(path), str(out), index)


def _assert_same_outputs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        if n.endswith(".npy"):
            assert (a / n).read_bytes() == (b / n).read_bytes(), n
        else:
            assert np.array_equal(np.asarray(Image.open(a / n)), np.asarray(Image.open(b / n))), n


def _both(jax_tool, tmp_path, path, monkeypatch, multilayer=True, index=3):
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    ours.mkdir(exist_ok=True)
    theirs.mkdir(exist_ok=True)
    t_conv.convert_one(str(path), str(ours), index)
    _jax_convert(jax_tool, path, theirs, index, monkeypatch, multilayer)
    _assert_same_outputs(ours, theirs)
    return ours


def _blender(rng, layer="View Layer", dtype=np.float16, depth_dtype=np.float32, inst=True):
    ch = {f"{layer}.Combined.{c}": smooth(rng, H, W, dtype) for c in "RGB"}
    ch[f"{layer}.Combined.A"] = np.ones((H, W), dtype)
    ch[f"{layer}.Depth.Z"] = (smooth(rng, H, W, np.float32) * 9 + 7).astype(depth_dtype)
    if inst:
        ch[f"{layer}.IndexOB.X"] = smooth(rng, H, W, np.uint32).astype(np.float32)
    return ch


# ------------------------------------------------------------------- the cases
@pytest.mark.parametrize("compression", ["NONE", "RLE", "ZIPS", "ZIP", "PIZ", "PXR24"])
@pytest.mark.parametrize("ptype", ["HALF", "FLOAT", "UINT"])
def test_multilayer_matches_the_jax_tool(jax_tool, tmp_path, monkeypatch, compression, ptype):
    dtype = {"HALF": np.float16, "FLOAT": np.float32, "UINT": np.uint32}[ptype]
    rng = np.random.default_rng(len(compression) * 7 + len(ptype))
    ch = _blender(rng)
    for c in "RGB":
        ch[f"View Layer.Combined.{c}"] = smooth(rng, H, W, dtype)
    ch["View Layer.Depth.Z"] = (smooth(rng, H, W, np.float32) * 9 + 7).astype(dtype)
    if compression == "PIZ":  # FLOAT samples on a 2^-10 grid: few low words, so that a 37 x 29 chunk shrinks
        ch = {k: np.round(v * 1024) / 1024 if v.dtype == np.float32 else v for k, v in ch.items()}
    stats = write_exr(tmp_path / "f.exr", ch, compression)
    if compression != "NONE":
        assert stats["compressed"] > 0  # the codec's decoder ran
    out = _both(jax_tool, tmp_path, tmp_path / "f.exr", monkeypatch)
    assert sorted(os.listdir(out)) == ["dm_00003.npy", "im_00003.png", "in_00003.npy"]
    hdr, planes = exr.read_exr(str(tmp_path / "f.exr"))
    assert hdr.compression == compression
    held = ARRAYS[str(tmp_path / "f.exr")]  # the arrays, FLOAT rounded to 24 bits by PXR24
    for name, arr in ch.items():
        assert planes[name].dtype == arr.dtype and np.array_equal(planes[name], held[name]), name
    if compression == "PIZ":  # the numpy decoder reads the same bits
        _, plain = exr.read_exr(str(tmp_path / "f.exr"), native=False)
        for name in ch:
            assert np.array_equal(plain[name].view(np.uint8), planes[name].view(np.uint8)), name


@pytest.mark.parametrize("compression", ["NONE", "ZIP"])
def test_decreasing_line_order_and_offset_window(jax_tool, tmp_path, monkeypatch, compression):
    ch = _blender(np.random.default_rng(11))
    write_exr(tmp_path / "f.exr", ch, compression, decreasing=True, origin=(3, 5))
    hdr, _ = exr.read_exr(str(tmp_path / "f.exr"))
    assert hdr.line_order == "DECREASING_Y" and hdr.data_window == (3, 5, 3 + W - 1, 5 + H - 1)
    _both(jax_tool, tmp_path, tmp_path / "f.exr", monkeypatch)


@pytest.mark.parametrize("layer", ["View Layer", "ViewLayer", "Composite"])
def test_blender_namings(jax_tool, tmp_path, monkeypatch, layer):
    ch = _blender(np.random.default_rng(5), layer=layer, inst=layer != "Composite")
    write_exr(tmp_path / "f.exr", ch, "ZIP")
    out = _both(jax_tool, tmp_path, tmp_path / "f.exr", monkeypatch)
    assert ("in_00003.npy" in os.listdir(out)) == (layer != "Composite")


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_single_layer_rgba_takes_depth_from_alpha(jax_tool, tmp_path, monkeypatch, dtype):
    rng = np.random.default_rng(7)
    ch = {c: smooth(rng, H, W, dtype) for c in "RGB"} | {"A": (smooth(rng, H, W, dtype) * 9 + 7).astype(dtype)}
    write_exr(tmp_path / "render.exr", ch, "ZIPS")
    out = _both(jax_tool, tmp_path, tmp_path / "render.exr", monkeypatch, multilayer=False)
    assert np.array_equal(np.load(out / "dm_00003.npy"), ch["A"].astype(np.float32))


@pytest.mark.parametrize("sibling", [True, False])
def test_single_layer_rgb_takes_depth_from_its_sibling(jax_tool, tmp_path, monkeypatch, sibling):
    rng = np.random.default_rng(9)
    write_exr(tmp_path / "Image0001.exr", {c: smooth(rng, H, W, np.float16) for c in "RGB"}, "RLE")
    if sibling:
        write_exr(tmp_path / "Depth0001.exr", {"Y": (smooth(rng, H, W, np.float32) * 9 + 7)}, "ZIP")
    out = _both(jax_tool, tmp_path, tmp_path / "Image0001.exr", monkeypatch, multilayer=False)
    assert ("dm_00003.npy" in os.listdir(out)) == sibling  # never the colour file as depth


def test_cli_numbers_the_sorted_renders(jax_tool, tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(2)
    src = tmp_path / "renders"
    src.mkdir()
    for name in ("b.exr", "a.exr", "c.exr"):
        write_exr(src / name, _blender(rng), "ZIP")
    t_conv.main([str(src), "--out", str(tmp_path / "port")])
    assert f"{src / 'c.exr'} -> im/dm_00002" in capsys.readouterr().out
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "OpenEXR", types.SimpleNamespace(InputFile=_InputFile))
        mp.setitem(sys.modules, "Imath", types.SimpleNamespace(PixelType=_PixelType))
        mp.setattr(sys, "argv", ["convert_exr.py", str(src), "--out", str(tmp_path / "jax")])
        jax_tool.main()
    _assert_same_outputs(tmp_path / "port", tmp_path / "jax")
    assert len(os.listdir(tmp_path / "port")) == 9


def test_halves_are_float16_rounding(tmp_path):
    f = np.random.default_rng(4).uniform(-4, 4, (H, W)).astype(np.float32)
    write_exr(tmp_path / "f.exr", {"R": f.astype(np.float16), "G": f.astype(np.float16),
                                   "B": f.astype(np.float16), "Z": f}, "ZIP")
    rgb, depth, _ = t_conv.read_render(str(tmp_path / "f.exr"))
    assert np.array_equal(rgb[..., 0], f.astype(np.float16).astype(np.float32))
    assert np.array_equal(depth, f)  # FLOAT bit-equal


@pytest.mark.parametrize("codec", ["B44", "B44A", "DWAA", "DWAB"])
def test_unsupported_compression_raises_naming_it(tmp_path, codec):
    write_exr(tmp_path / "f.exr", {"R": np.zeros((4, 4), np.float16)}, codec)
    with pytest.raises(ValueError, match=f"f.exr: {codec} compression is not supported"):
        exr.read_exr(str(tmp_path / "f.exr"))


@pytest.mark.parametrize("kind,flags,attrs,match", [
    ("tiled", 0x200, b"", "a tiled file"),
    ("tiles_attribute", 0, _attr("tiles", "tiledesc", struct.pack("<IIB", 16, 16, 0)), "tiledimage"),
    ("deep", 0x800, b"", "a deep"),
    ("multipart", 0x1000, b"", "a multipart file"),
])
def test_other_layouts_raise_naming_them(tmp_path, kind, flags, attrs, match):
    write_exr(tmp_path / "f.exr", {"R": np.zeros((4, 4), np.float16)}, "ZIP", version_flags=flags, extra_attrs=attrs)
    with pytest.raises(ValueError, match=f"f.exr: .*{match}"):
        exr.read_exr(str(tmp_path / "f.exr"))


def test_subsampled_channels_and_missing_rgb_raise(tmp_path):
    write_exr(tmp_path / "sub.exr", {"R": np.zeros((4, 4), np.float16)}, "ZIP", sampling=(2, 2))
    with pytest.raises(ValueError, match="sub.exr: channel 'R' is subsampled"):
        exr.read_exr(str(tmp_path / "sub.exr"))
    write_exr(tmp_path / "norgb.exr", {"View Layer.Depth.Z": np.ones((4, 4), np.float32)}, "ZIP")
    with pytest.raises(ValueError, match="norgb.exr: no RGB channels"):
        t_conv.read_render(str(tmp_path / "norgb.exr"))


def test_piz_modular_wavelet_and_both_decoders(tmp_path):
    """FLOAT and HALF samples whose words take more than 2^14 distinct
    values in a chunk (ramps of bit patterns, which still compress): the
    wavelet runs modular (wdec16). 37 rows: a 5-row last chunk. The native
    and numpy decoders agree bit for bit, chunk by chunk."""
    ramp = np.arange(37 * 640, dtype=np.uint32).reshape(37, 640)
    f = (0x3F800000 + ramp).view(np.float32)
    h = (ramp % 0x7C00).astype(np.uint16).view(np.float16)  # finite halves
    assert len(np.unique(f[:32].view(np.uint16))) > 1 << 14 and len(np.unique(h[:32])) > 1 << 14
    stats = write_exr(tmp_path / "f.exr", {"Z": f, "Y": h}, "PIZ")
    assert stats == {"chunks": 2, "compressed": 2}
    _, native = exr.read_exr(str(tmp_path / "f.exr"))
    _, plain = exr.read_exr(str(tmp_path / "f.exr"), native=False)
    for planes in (native, plain):
        assert np.array_equal(planes["Z"].view(np.uint32), f.view(np.uint32))
        assert np.array_equal(planes["Y"].view(np.uint16), h.view(np.uint16))
    for lines in (32, 5):
        block = [h[:lines].astype("<f2"), f[:lines].astype("<f4")]  # the file's channel order: Y, Z
        data = _piz(block)
        words = exr.piz_words(data, 640, lines, [1, 2])
        assert np.array_equal(words, exr.piz_words_numpy(data, 640, lines, [1, 2]))
        assert np.array_equal(words, np.concatenate([b.view("<u2").reshape(-1) for b in block]))


def test_pxr24_float_is_24_bit_rounding(tmp_path):
    """PXR24 keeps HALF and UINT exactly and FLOAT at OpenEXR's 24 bits,
    specials included; a FLOAT read back is that rounding, bit for bit."""
    f = np.random.default_rng(9).uniform(-3e4, 3e4, (20, 33)).astype(np.float32)
    f[0, :6] = [np.inf, -np.inf, np.nan, np.finfo(np.float32).max, 0.0, -0.0]
    f[1, :3] = np.array([0x7F800001, 0x3F80007F, 0x3F800080], np.uint32).view(np.float32)
    with np.errstate(over="ignore"):
        h = f.astype(np.float16)
    u = np.random.default_rng(10).integers(0, 2**32, (20, 33), dtype=np.uint32)
    assert write_exr(tmp_path / "f.exr", {"F": f, "H": h, "U": u}, "PXR24")["compressed"] == 2
    _, planes = exr.read_exr(str(tmp_path / "f.exr"))
    assert np.array_equal(planes["F"].view(np.uint32), float24(f).view(np.uint32))
    assert np.array_equal(planes["H"].view(np.uint16), h.view(np.uint16))
    assert np.array_equal(planes["U"], u)
    got = planes["F"].view(np.uint32)
    assert got[1, 0] == 0x7F800100 and got[1, 1] == 0x3F800000 and got[1, 2] == 0x3F800100  # NaN kept; ties
    assert got[0, 3] == 0x7F7FFF00  # truncated, not rounded to infinity


@pytest.mark.parametrize("codec", ["PIZ", "PXR24"])
def test_damaged_chunks_raise_naming_the_file(codec):
    block = [smooth(np.random.default_rng(12), 32, 29, np.float16).astype("<f2")]
    if codec == "PIZ":
        data = _piz(block)
        for decode in (exr.piz_words, exr.piz_words_numpy):
            with pytest.raises(ValueError, match="bad.exr: a PIZ chunk is truncated"):
                decode(data[:-8], 29, 32, [1], "bad.exr")  # the Huffman stream cut short
            with pytest.raises(ValueError, match="bad.exr: a PIZ chunk decodes to"):
                decode(data, 29, 31, [1], "bad.exr")  # one row too many in the stream
    else:
        channels = [exr.Channel("R", np.dtype("<f2"))]
        with pytest.raises(ValueError, match="bad.exr: a PXR24 chunk inflates to 1856 bytes, not 1798"):
            exr._pxr24(_pxr24(block), channels, 29, 31, "bad.exr")


def _openexr_arrays(name: str) -> np.ndarray:
    """What OPENEXR_STREAMS[name] holds: PIZ, a ramp of bit patterns falling
    along x and y (the wavelet's differences stay small, so 32 rows
    shrink); PXR24, a seeded array (FLOAT at OpenEXR's 24 bits)."""
    codec, ptype = name.split("_")
    if codec == "PIZ":
        y, x = np.mgrid[0:33, 0:4]
        fall = 200 - (4 * y + x)
        return ((0x3C00 + fall).astype(np.uint16).view(np.float16) if ptype == "HALF"
                else (0x3F803F80 + fall).astype(np.uint32).view(np.float32))
    a = (np.random.default_rng(19).integers(0, 6, (33, 4)) / 8 + 0.25).astype(np.float32)
    a[5:9] = 0.0
    return a.astype(np.float16) if ptype == "HALF" else float24(a)


@pytest.mark.parametrize("name", sorted(OPENEXR_STREAMS))
def test_files_written_by_openexr(tmp_path, name):
    (tmp_path / "f.exr").write_bytes(base64.b64decode(OPENEXR_STREAMS[name]))
    want = _openexr_arrays(name)
    for native in (True, False):
        hdr, planes = exr.read_exr(str(tmp_path / "f.exr"), native=native)
        assert hdr.compression == name.split("_")[0] and list(planes) == ["Y"]
        assert planes["Y"].dtype == want.dtype and np.array_equal(planes["Y"].view(np.uint8), want.view(np.uint8))
