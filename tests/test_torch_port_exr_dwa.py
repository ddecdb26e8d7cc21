"""The port's EXR reader (`pipeline/exr.py`) on DWAA and DWAB chunks, tiled
files and a multipart file's first part, on the CPU.

Files are written here from the OpenEXR file layout (`struct` and `zlib`,
independent of the reader). `dwa_chunk` is the test's own DWA writer: the
eleven counts, the channel rules, the UNKNOWN channels' rows deflated, the
RLE channels' byte planes run-length coded and deflated, the DC words
through ZIP's byte split and predictor, and the AC words run-length coded
as OpenEXR's encoder does (a lone zero as a literal, 0xff00 for the end of
a block, 0xffnn for nn zeros) and Huffman-coded (`_huffman` of the PIZ
tests) or deflated; lossy channels from chosen coefficients. `Image.part`
lays a part out in scanline chunks or in tiles of every level (MIPMAP and
RIPMAP, rounded down or up), `write_parts` as a single-part or multipart
file.

The cases of CASES were read by OpenEXR itself (cv2.imread): Y, BGR and
BGRA, HALF and FLOAT, pLinear, DWAB, DC-only blocks, deflated AC, legacy
(version 1) rules, UNKNOWN and RLE FLOAT channels, DWAA and lossless tiles,
multipart files; the port's reader, with the C++ and the numpy Huffman
decoder, must give the same array bit for bit (OPENEXR_SHA256). Beside
them: lossy blocks within one half step of a float64 inverse DCT before
the nonlinear table; the vectorised AC parse against a block-by-block
loop; a Blender multilayer DWAA render (both view-layer namings) with
Depth.Z kept exact in the UNKNOWN section, and it and a single-layer RGBA
DWAA render through the JAX tool's `convert_one` (its stub OpenEXR / cv2
serving what OpenEXR reads) against the port's; tiled and multipart files
against the same image in a scanline file; damaged chunks, other parts'
chunks, other levels' tiles and deep parts raising errors that name them.
"""
import hashlib
import os
import struct
import zlib

import numpy as np
import pytest
from test_torch_port_exr import ARRAYS, _attr, _both, _compress, _huffman, _rle, _split_predict, jax_tool  # noqa: F401

from sgam_neurips22_tpu_torch.pipeline import exr

CODES = {"NONE": 0, "RLE": 1, "ZIPS": 2, "ZIP": 3, "PIZ": 4, "PXR24": 5, "B44": 6, "B44A": 7, "DWAA": 8, "DWAB": 9}
LINES = {"NONE": 1, "ZIP": 16, "PIZ": 32, "DWAA": 32, "DWAB": 256}
PTYPE = {np.dtype("<u4"): 0, np.dtype("<f2"): 1, np.dtype("<f4"): 2}
UNKNOWN, LOSSY, RLE = 0, 1, 2
# OpenEXR's default rules (DwaCompressor::initializeDefaultChannelRules): (suffix, scheme, pixel type, csc index)
DEFAULT_RULES = ([(c, LOSSY, t, i) for i, c in enumerate("RGB") for t in (1, 2)]
                 + [(c, LOSSY, t, -1) for c in ("Y", "BY", "RY") for t in (1, 2)]
                 + [("A", RLE, t, -1) for t in (0, 1, 2)])
ZIGZAG = np.array([0, 1, 5, 6, 14, 15, 27, 28, 2, 4, 7, 13, 16, 26, 29, 42, 3, 8, 12, 17, 25, 30, 41, 43, 9, 11,
                   18, 24, 31, 40, 44, 53, 10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60, 21, 34,
                   37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63])  # zig-zag index of [row * 8 + col]


# ------------------------------------------------------------ the test's DWA writer
def classify(channels, rules):
    """(scheme of each channel, lossy decoders): each decoder a list of
    channel indices, the RGB sets ([R, G, B], by prefix) first."""
    schemes, sets = [], {}
    for i, (name, dtype, _) in enumerate(channels):
        prefix, suffix = name.rsplit(".", 1) if "." in name else ("", name)
        scheme = UNKNOWN
        for sfx, sch, ptype, csc in rules:
            if sfx == suffix and ptype == PTYPE[np.dtype(dtype)]:
                scheme = sch
                if csc >= 0:
                    sets.setdefault(prefix, [-1, -1, -1])[csc] = i
        schemes.append(scheme)
    trios = [t for _, t in sorted(sets.items()) if min(t) >= 0]
    done = {i for t in trios for i in t}
    return schemes, trios + [[i] for i, s in enumerate(schemes) if s == LOSSY and i not in done]


def rle_ac(zig: np.ndarray) -> list:
    """OpenEXR's rleAc of a block's 63 AC halves (zig-zag order) as words."""
    bits, out, k = zig.view(np.uint16).tolist(), [], 1
    while k < 64:
        if bits[k]:
            out.append(bits[k])
            k += 1
            continue
        run = 1
        while k + run < 64 and not bits[k + run]:
            run += 1
        out.append(0 if run == 1 else 0xFF00 if k + run == 64 else 0xFF00 | run)
        k += run
    return out


def dwa_chunk(channels, arrays: dict, coefs: dict, rules=DEFAULT_RULES, ac_coding: str = "huffman",
              rule_bytes=None) -> bytes:
    """A DWA chunk of channels [(name, dtype, pLinear)] in file order:
    `arrays` {name: [n, w]} for the RLE and UNKNOWN channels, `coefs`
    {name: [blocks, 64] float16, natural order, blocks in rows of 8x8} for
    the lossy ones. `rules` None writes a version-1 chunk (no rule table)."""
    schemes, decoders = classify(channels, rules if rules is not None else [
        (c, LOSSY, 1, i) for i, c in enumerate("RGB")] + [("Y", LOSSY, 1, -1), ("A", RLE, 1, -1)])
    unknown = b"".join(np.ascontiguousarray(arrays[n]).tobytes() for (n, _, _), s in zip(channels, schemes)
                       if s == UNKNOWN)
    planes = b""
    for (n, _, _), s in zip(channels, schemes):
        if s == RLE:
            a = np.ascontiguousarray(arrays[n])
            planes += a.view(np.uint8).reshape(-1, a.dtype.itemsize).T.tobytes()
    ac, dc = [], []
    for dec in decoders:
        blocks = [np.asarray(coefs[channels[i][0]], np.float16) for i in dec]
        for b in range(len(blocks[0])):
            for c in blocks:
                zig = np.empty(64, np.float16)
                zig[ZIGZAG] = c[b]
                ac += rle_ac(zig)
        for c in blocks:
            dc += c[:, 0].view(np.uint16).tolist()
    ac_words = np.array(ac, "<u2")
    ac_bytes = (b"" if not ac else _huffman(ac_words) if ac_coding == "huffman" else zlib.compress(ac_words.tobytes()))
    dc_bytes = zlib.compress(_split_predict(np.array(dc, "<u2").tobytes())) if dc else b""
    unknown_bytes = zlib.compress(unknown) if unknown else b""
    rle = _rle(planes)
    rle_bytes = zlib.compress(rle) if planes else b""
    if rules is None:
        version, table = 1, b""
    else:
        version = 2
        table = rule_bytes if rule_bytes is not None else b"".join(
            s.encode() + b"\0" + bytes([((csc + 1) << 4) | (sch << 2), pt]) for s, sch, pt, csc in rules)
        table = struct.pack("<H", len(table) + 2) + table
    counts = struct.pack("<11Q", version, len(unknown), len(unknown_bytes), len(ac_bytes), len(dc_bytes),
                         len(rle_bytes), len(rle) if planes else 0, len(planes), len(ac), len(dc),
                         0 if ac_coding == "huffman" else 1)
    return counts + table + unknown_bytes + ac_bytes + dc_bytes + rle_bytes


# ------------------------------------------------------------ the layout writer
def _header(channels, compression, window, display, tiles=None, extra=b"") -> bytes:
    chlist = b"".join(n.encode() + b"\0" + struct.pack("<iB3xii", PTYPE[np.dtype(d)], int(lin), 1, 1)
                      for n, d, lin in channels) + b"\0"
    out = (_attr("channels", "chlist", chlist) + _attr("compression", "compression", bytes([CODES[compression]]))
           + _attr("dataWindow", "box2i", struct.pack("<iiii", *window))
           + _attr("displayWindow", "box2i", struct.pack("<iiii", *display))
           + _attr("lineOrder", "lineOrder", b"\0") + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
           + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
           + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)))
    if tiles:
        tw, th, mode, up = tiles
        out += _attr("tiles", "tiledesc", struct.pack("<IIB", tw, th, mode | (up << 4)))
    return out + extra


def write_parts(path, parts, part_types=None) -> None:
    """An OpenEXR file of `parts`, each {"channels": [(name, dtype,
    pLinear)], "compression", "window", "tiles": None or (w, h, level mode,
    round up), "chunks": [(key, data)]}, key the first row y (scanline) or
    (tx, ty, lx, ly) (tiled), in the order of the part's offset table; one
    part is a single-part file, more a multipart one (the display window
    part 0's data window, shared as OpenEXR requires)."""
    multi = len(parts) > 1
    head = b""
    for i, p in enumerate(parts):
        extra = b""
        if multi:
            kind = (part_types or {}).get(i, "tiledimage" if p["tiles"] else "scanlineimage").encode()
            extra = (_attr("name", "string", f"part{i}".encode()) + _attr("type", "string", kind)
                     + _attr("chunkCount", "int", struct.pack("<i", len(p["chunks"]))))
        head += _header(p["channels"], p["compression"], p["window"], parts[0]["window"], p["tiles"], extra) + b"\0"
    if multi:
        head += b"\0"
    flags = 0x1000 if multi else (0x200 if parts[0]["tiles"] else 0)
    prefix = struct.pack("<ii", 20000630, 2 | flags) + head
    pos = len(prefix) + 8 * sum(len(p["chunks"]) for p in parts)
    table, body = b"", b""
    for i, p in enumerate(parts):
        for key, data in p["chunks"]:
            keys = struct.pack("<4i", *key) if p["tiles"] else struct.pack("<i", key)
            chunk = (struct.pack("<i", i) if multi else b"") + keys + struct.pack("<i", len(data)) + data
            table += struct.pack("<Q", pos)
            body += chunk
            pos += len(chunk)
    with open(path, "wb") as f:
        f.write(prefix + table + body)


def levels(w, h, mode, up):
    """(lx, ly, width, height) of each level in OpenEXR's order: level
    (0, 0) first, MIPMAP levels l = lx = ly, RIPMAP levels x fastest."""
    def n_levels(n):
        lg = 0
        while (1 << (lg + 1)) <= n:
            lg += 1
        return lg + 1 + (up and (1 << lg) < n)

    def size(n, lv):
        return max((n + (1 << lv) - 1) >> lv if up else n >> lv, 1)

    if mode == 0:
        return [(0, 0, w, h)]
    if mode == 1:
        return [(lv, lv, size(w, lv), size(h, lv)) for lv in range(n_levels(max(w, h)))]
    return [(lx, ly, size(w, lx), size(h, ly)) for ly in range(n_levels(h)) for lx in range(n_levels(w))]


class Image:
    """What a part holds: channels [(name, dtype, pLinear)] in file order,
    `coefs` {name: [rows of blocks, blocks, 64] float16} for the lossy
    channels of a DWA part, `arrays` {name: [H, W]} for the others (every
    channel of a lossless part)."""

    def __init__(self, channels, h, w, coefs=None, arrays=None, rules=DEFAULT_RULES, ac_coding="huffman"):
        self.channels, self.h, self.w = channels, h, w
        self.coefs, self.arrays = coefs or {}, arrays or {}
        self.rules, self.ac_coding = rules, ac_coding

    def encode(self, compression, y0, x0, n, w) -> bytes:
        """A chunk of the region's n rows of w pixels; a DWA chunk must
        shrink (OpenEXR reads a chunk that does not as raw pixels)."""
        raw_size = n * w * sum(np.dtype(d).itemsize for _, d, _ in self.channels)
        if compression in ("DWAA", "DWAB"):
            by, bx = y0 // 8, x0 // 8
            co = {k: v[by:by + -(-n // 8), bx:bx + -(-w // 8)].reshape(-1, 64) for k, v in self.coefs.items()}
            data = dwa_chunk(self.channels, {k: v[y0:y0 + n, x0:x0 + w] for k, v in self.arrays.items()}, co,
                             self.rules, self.ac_coding)
            assert len(data) < raw_size, f"a {n} x {w} DWA chunk of {len(data)} bytes does not shrink"
            return data
        block = [np.ascontiguousarray(self.arrays[c][y0:y0 + n, x0:x0 + w]) for c, _, _ in self.channels]
        return _compress(b"".join(b[r].tobytes() for r in range(n) for b in block), compression, block)

    def part(self, compression, tiles=None, origin=(0, 0)) -> dict:
        """A scanline part, or a tiled one (tiles (w, h, level mode, round
        up); each level above (0, 0) holds the corner of the image of its
        size, which the reader skips)."""
        chunks = []
        if tiles is None:
            lines = LINES[compression]
            for y in range(0, self.h, lines):
                chunks.append((origin[1] + y, self.encode(compression, y, 0, min(lines, self.h - y), self.w)))
        else:
            tw, th, mode, up = tiles
            for lx, ly, lw, lh in levels(self.w, self.h, mode, up):
                for ty in range(-(-lh // th)):
                    for tx in range(-(-lw // tw)):
                        region = (ty * th, tx * tw, min(th, lh - ty * th), min(tw, lw - tx * tw))
                        chunks.append(((tx, ty, lx, ly), self.encode(compression, *region)))
        window = (origin[0], origin[1], origin[0] + self.w - 1, origin[1] + self.h - 1)
        return {"channels": self.channels, "compression": compression, "window": window, "tiles": tiles,
                "chunks": chunks}


def random_coefs(rng, h, w, dc=(0.0, 1.5), ac=1.0, dc_only=0.25, density=0.35) -> np.ndarray:
    """[rows of blocks, blocks, 64] float16 coefficients (natural order) of
    a DWA channel: the DC 8 times a stored (nonlinear) value drawn from
    `dc`, a share `density` of the AC nonzero, falling with frequency, and
    a share `dc_only` of the blocks without AC; the AC on a grid of 1/16,
    as quantisation leaves them (few distinct words: a chunk shrinks)."""
    nby, nbx = -(-h // 8), -(-w // 8)
    r, k = np.divmod(np.arange(64), 8)
    c = rng.normal(0, 1, (nby, nbx, 64)) * (ac / (1 + r + k)) * (rng.uniform(0, 1, (nby, nbx, 64)) < density)
    c = np.round(c * 16) / 16
    c[..., 0] = rng.uniform(*dc, (nby, nbx)) * 8
    c[rng.uniform(0, 1, (nby, nbx)) < dc_only, 1:] = 0
    return c.astype(np.float16)


# ------------------------------------------------------------ the files OpenEXR read
H, W = 37, 133  # DWAA's 32-line chunks end with one of 5 lines; 8x8 blocks end with 5 rows and 5 columns
HALF, FLOAT = "<f2", "<f4"


def _rgb(rng, dtype, h=H, w=W, alpha=False, linear=False, **kw):
    ch = [(c, dtype, linear) for c in ("ABGR" if alpha else "BGR")]
    coefs = {"R": random_coefs(rng, h, w, dc=(-0.5, 3.0), ac=2.0, **kw)}
    coefs |= {c: random_coefs(rng, h, w, dc=(-0.1, 0.4), ac=0.3, **kw) for c in "GB"}  # Cb, Cr: small
    arrays = {"A": np.clip(rng.uniform(-0.3, 1.3, (h, w)), 0, 1).astype(dtype)} if alpha else {}
    return Image(ch, h, w, coefs, arrays)


def _y(rng, linear=False, **kw):
    return Image([("Y", HALF, linear)], H, W, {"Y": random_coefs(rng, H, W, dc=(-1.0, 6.0), ac=3.0, **kw)})


def _lossless(rng, h=45, w=37):
    yy, xx = np.mgrid[0:h, 0:w]
    return Image([(c, HALF, False) for c in "BGR"], h, w, arrays={c: (
        0.5 + 0.4 * np.sin(yy / 5.0 + rng.uniform(0, 6)) * np.cos(xx / 7.0) + rng.uniform(0, 0.01, (h, w))
    ).astype(HALF) for c in "BGR"})


def case(name: str, path) -> Image:
    """Write case `name` to `path` (seeded, so the file is the one OpenEXR
    read); returns its part 0's Image."""
    rng = np.random.default_rng(zlib.crc32(("y_half" if name == "y_deflate" else name).encode()))
    if name in ("y_half", "y_half_plinear", "y_dwab", "y_deflate"):
        img = _y(rng, linear=name == "y_half_plinear")
        img.ac_coding = "deflate" if name == "y_deflate" else "huffman"
        write_parts(path, [img.part("DWAB" if name == "y_dwab" else "DWAA")])
    elif name in ("bgr_half", "bgra_half", "bgr_float", "bgra_float", "bgr_half_plinear"):
        img = _rgb(rng, FLOAT if "float" in name else HALF, alpha="bgra" in name, linear="plinear" in name)
        write_parts(path, [img.part("DWAA")])
    elif name == "dc_only":  # what a high compression level leaves: blocks without AC
        img = _rgb(rng, HALF, h=77, w=93, dc_only=0.9)
        write_parts(path, [img.part("DWAB")])
    elif name == "legacy_rules":  # a version-1 chunk: no rules, the legacy ones (case-blind)
        img = _rgb(rng, HALF)
        img.rules = None
        write_parts(path, [img.part("DWAA")])
    elif name in ("unknown_float", "rle_float"):  # rules that keep R, G, B FLOAT whole: UNKNOWN, or RLE
        img = Image([(c, FLOAT, False) for c in "BGR"], H, W, arrays={
            c: rng.uniform(-10, 10, (H, W)).astype(FLOAT) for c in "BGR"})
        img.rules = [("A", RLE, 2, -1)] if name == "unknown_float" else [(c, RLE, 2, -1) for c in "BGR"]
        write_parts(path, [img.part("DWAA")])
    elif name == "tiled_dwaa":  # 40 x 40 tiles over 77 x 93: edge tiles of 37 rows and 13 columns
        img = _rgb(rng, HALF, h=77, w=93)
        write_parts(path, [img.part("DWAA", tiles=(40, 40, 0, 0))])
    elif name.startswith("tiled_"):  # tiled_<codec>_<level mode><round up>
        _, codec, mode = name.split("_")
        img = _lossless(rng)
        size = (16, 8) if codec == "zip" else (32, 24)  # PIZ's tables take room: larger tiles, so that they shrink
        write_parts(path, [img.part(codec.upper(), tiles=(*size, int(mode[0]), int(mode[1])))])
    elif name in ("multi_scanline", "multi_tiled"):
        img = _lossless(rng)
        p0 = img.part("ZIP") if name == "multi_scanline" else img.part("PIZ", tiles=(32, 24, 1, 0))
        other = Image([("Y", HALF, False)], 20, 30, arrays={"Y": rng.uniform(0, 1, (20, 30)).astype(HALF)})
        write_parts(path, [p0, other.part("NONE", origin=(4, 2))])
    else:
        raise KeyError(name)
    return img


def as_cv2(planes: dict) -> np.ndarray:
    """The array cv2.imread returns for these planes: float32, Y alone as
    [H, W], else B, G, R(, A) stacked."""
    if "Y" in planes:
        return planes["Y"].astype(np.float32)
    return np.stack([planes[c].astype(np.float32) for c in "BGRA" if c in planes], axis=2)


# SHA-256 of the float32 array cv2.imread returned for each case's file: OpenCV 4.13 with its bundled OpenEXR
# 2.3.0, on an x86-64 host with AVX (whose DWA decoder takes the order of operations `exr.dwa_idct` follows).
# That cv2's imwrite leaves a DWA file's chunk offsets 0, so the files are this writer's. After a change to a
# case, record its digest again from cv2.imread on such a host.
OPENEXR_SHA256 = {
    "y_half": "efc4b990915fa151a182479cddacbea4b337c2245df0a36a72ba5520abbc9602",
    "y_half_plinear": "10437f114f611776529e76a8173993c4a98b923337736218f9314e1a4c36092f",
    "y_dwab": "27cc99cd9eb41300a110c37d572f92f34102c58d723d625d7249f0417565450d",
    "y_deflate": "efc4b990915fa151a182479cddacbea4b337c2245df0a36a72ba5520abbc9602",
    "bgr_half": "74f22fb6e38fd2b995c40f93233d0fcfc70ca5f85de904d2da043ea36c886426",
    "bgra_half": "a131bfc28bb7761df3c30cb29347b515219f37118ba5c3f51f78cc8e5de951c5",
    "bgr_float": "4f584a5953b0fd4d903972100b869db33be8e038b4a7ab00af0d757d767f7744",
    "bgra_float": "1a41d559b1adc6f178f749881de317c537e812dd2eb7d172091dd289b935bfe0",
    "bgr_half_plinear": "bf2601388a3add013312260bba4e0b13d1e37998cb852d05ec8876614f68a88b",
    "dc_only": "270c1c5b0a74694bf92044d88891f721cdd9de2e091a8dea630a40cb812072e7",
    "legacy_rules": "487bfe3b4a10557b576dd0d2c672afdd6ba6b5a5e338777d25f4c8c63a80af2c",
    "unknown_float": "36302901bc2cf3b7a46b013e49e828bc7551e8dc13ed6fc53bfea81dba47e702",
    "rle_float": "50cc6fc2d1ec02c85f823b15da0ae3f94419d362319f67b63588eb46f8a3bdae",
    "tiled_dwaa": "9cd43869bae34f99f2de14e5d39fdec9c3cd60d1ff6f3524e61bc8dad294f5bf",
    "tiled_zip_00": "bfb82338c99135cf97535be0a2a7b4cc0be1a501ecd59f11f7e746d3aa41d4cf",
    "tiled_zip_01": "c75ddd6625ed8028eff9f871c944b4087b9b6279cc48db8e29e64b0579178566",
    "tiled_zip_10": "2b5f9d3f8065bd81e795140c87dd9aa659c6360fda49ffa14f42b7bf4619d88f",
    "tiled_zip_11": "4fc865f47df81810d2b713222c477f72eacf4c725ef8829b46821b86856da0dd",
    "tiled_zip_20": "2c9f5aa2a96ed34d5300517a7f1c3ddfc56959816f2c6c950d1cc2207d83ceae",
    "tiled_zip_21": "a3713a77a6f8476278030c57a326d12be08131e66763f45a3835b33ea6b45109",
    "tiled_piz_21": "9e3e6d22837cac77b86ce227c2fc6bd657a3b69c49ccfb2861a05f1b72c7b76a",
    "multi_scanline": "3b076d44e2edd30105a2a9bda924b525432929f9c8d0d9393a912fa1387e6a6c",
    "multi_tiled": "efc4d50d40297e2015d35bf037137659440b31a3bda9f74e0cfe10410722061e",
}
CASES = (["y_half", "y_half_plinear", "y_dwab", "y_deflate", "bgr_half", "bgra_half", "bgr_float", "bgra_float",
          "bgr_half_plinear", "dc_only", "legacy_rules", "unknown_float", "rle_float", "tiled_dwaa"]
         + [f"tiled_zip_{m}{u}" for m in range(3) for u in range(2)]
         + ["tiled_piz_21", "multi_scanline", "multi_tiled"])


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.float32).tobytes()).hexdigest()


def _chunk_sizes(path) -> list:
    """(stored bytes, raw bytes) of each chunk of a single-part file's
    level (0, 0), or of a multipart file's first part."""
    data = open(path, "rb").read()
    buf = exr._Bytes(data, str(path))
    hdr = exr.read_header(buf)
    x0, y0, x1, y1 = hdr.data_window
    w, h = x1 - x0 + 1, y1 - y0 + 1
    tw, th = hdr.tiles[:2] if hdr.tiles else (w, exr.LINES[hdr.compression])
    n = -(-w // tw) * -(-h // th)
    px = sum(c.dtype.itemsize for c in hdr.channels)
    out = []
    for off in struct.unpack(f"<{n}Q", buf.take(8 * n)):
        at = off + 4 * hdr.multipart
        if hdr.tiles:
            tx, ty, _, _, size = struct.unpack_from("<5i", data, at)
            out.append((size, min(tw, w - tx * tw) * min(th, h - ty * th) * px))
        else:
            y, size = struct.unpack_from("<ii", data, at)
            out.append((size, min(th, h - (y - y0)) * w * px))
    return out


# ------------------------------------------------------------------- the cases
@pytest.mark.parametrize("name", CASES)
def test_files_read_as_openexr_reads_them(tmp_path, name):
    """Each file the test writes, read by both Huffman decoders, bit-equal
    to what OpenEXR's own reader (cv2.imread) returned for it; every DWA
    chunk stored compressed (so the DWA decoder ran on each), and at least
    one chunk of each other file."""
    path = tmp_path / f"{name}.exr"
    case(name, path)
    hdr, planes = exr.read_exr(str(path))
    _, plain = exr.read_exr(str(path), native=False)
    for c in planes:
        assert np.array_equal(planes[c].view(np.uint8), plain[c].view(np.uint8)), c
    assert _sha(as_cv2(planes)) == OPENEXR_SHA256[name]
    shrunk = [size < raw for size, raw in _chunk_sizes(path)]
    assert all(shrunk) if hdr.compression.startswith("DWA") else any(shrunk)
    assert hdr.compression == {"zip": "ZIP", "piz": "PIZ"}.get(name.split("_")[1], hdr.compression)


def test_deflated_ac_reads_as_huffman_coded_ac(tmp_path):
    img = _rgb(np.random.default_rng(3), HALF, alpha=True)
    write_parts(tmp_path / "huf.exr", [img.part("DWAA")])
    img.ac_coding = "deflate"
    write_parts(tmp_path / "zip.exr", [img.part("DWAA")])
    ac = [struct.unpack_from("<11Q", d)[10] for _, d in img.part("DWAA")["chunks"]]
    assert ac == [1, 1]  # the AC coding each chunk names: deflate
    a, b = exr.read_exr(str(tmp_path / "huf.exr"))[1], exr.read_exr(str(tmp_path / "zip.exr"))[1]
    assert all(np.array_equal(a[c].view(np.uint16), b[c].view(np.uint16)) for c in "ABGR")


def _idct64(coefs: np.ndarray) -> np.ndarray:
    """[blocks, 64] coefficients -> [blocks, 8, 8] pixels: the orthonormal
    2D inverse DCT in float64 (OpenEXR's scaling: a DC-only block is dc / 8)."""
    k = np.arange(8)
    basis = np.where(k[:, None] == 0, np.sqrt(1 / 8), 0.5 * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16))
    return np.einsum("ux,nuv,vy->nxy", basis, coefs.astype(np.float64).reshape(-1, 8, 8), basis)


def _within_one_ulp(got_bits: np.ndarray, ref: np.ndarray, table: np.ndarray) -> bool:
    """Each pixel is table[h] for a half h at most one step from the
    float64 value `ref` rounded to half."""
    h = ref.astype(np.float16)
    cands = [np.nextafter(h, np.float16(-np.inf)), h, np.nextafter(h, np.float16(np.inf))]
    return bool(np.any([table[c.view(np.uint16)] == got_bits for c in cands], axis=0).all())


@pytest.mark.parametrize("kind", ["Y_plinear", "Y", "RGB"])
def test_lossy_blocks_within_one_half_ulp_of_a_float64_idct(tmp_path, kind):
    """Chosen coefficients against a float64 inverse DCT (and YCbCr -> RGB
    in float64): within one half step before OpenEXR's nonlinear -> linear
    table (which a pLinear Y channel skips)."""
    rng = np.random.default_rng(8)
    h, w = 40, 48
    if kind == "RGB":
        img = _rgb(rng, HALF, h, w, dc_only=0.1)
    else:
        img = Image([("Y", HALF, kind == "Y_plinear")], h, w, {"Y": random_coefs(rng, h, w, (-1.0, 5.0), 3.0)})
    write_parts(tmp_path / "f.exr", [img.part("DWAB")])
    planes = exr.read_exr(str(tmp_path / "f.exr"))[1]

    def pixels(c):
        return _idct64(img.coefs[c].reshape(-1, 64)).reshape(h // 8, w // 8, 8, 8).transpose(0, 2, 1, 3).reshape(h, w)

    if kind == "RGB":
        y, cb, cr = pixels("R"), pixels("G"), pixels("B")
        ref = {"R": y + 1.5747 * cr, "G": y - 0.1873 * cb - 0.4682 * cr, "B": y + 1.8556 * cb}
    else:
        ref = {"Y": pixels("Y")}
    table = np.arange(1 << 16, dtype=np.uint16) if kind == "Y_plinear" else exr.DWA_TO_LINEAR
    for c, r in ref.items():
        assert _within_one_ulp(planes[c].view(np.uint16), r, table), c


def test_to_linear_table():
    t = exr.DWA_TO_LINEAR.view(np.float16)
    assert t[0x3C00] == 1 and t[0xBC00] == -1 and exr.DWA_TO_LINEAR[0x8000] == 0  # -0 -> +0
    assert np.all(exr.DWA_TO_LINEAR[[0x7C00, 0xFC00, 0x7E00]] == 0)  # infinities, NaN -> 0
    assert t[0x4000] == np.float16(np.exp(2.2))  # past 1: e^(2.2 (x - 1))
    assert t[0x3800] == np.float16(0.5 ** 2.2) and np.isinf(t[0x4700])  # 7 -> e^13.2, past the halves


def _parse_ac_loop(words, n_blocks):
    """OpenEXR's unRleAc, block by block: (coefficients, last literal)."""
    coefs, last, i = np.zeros((n_blocks, 64), np.uint16), np.zeros(n_blocks, np.int64), 0
    for b in range(n_blocks):
        k = 1
        while k < 64:
            word = int(words[i])
            i += 1
            if word == 0xFF00:
                k = 64
            elif word >> 8 == 0xFF:
                k += word & 0xFF
            else:
                coefs[b, k], last[b] = word, k
                k += 1
    return coefs, last, i


def test_ac_words_parse_as_openexr_does():
    rng = np.random.default_rng(6)
    words, n_blocks = [], 300
    for _ in range(n_blocks):  # literals (zeros among them), runs, runs past the block, an end or none
        zig = np.where(rng.uniform(0, 1, 64) < 0.3, rng.normal(0, 1, 64), 0).astype(np.float16)
        zig[rng.uniform(0, 1, 64) < 0.05] = np.float16(-0.0)
        block = rle_ac(zig)
        if rng.uniform() < 0.2 and block[-1] == 0xFF00:
            block[-1] = 0xFF3F  # a run of 63 zeros ends the block as well
        words += block
    words = np.array(words + [0x3C00] * 5, np.uint16)
    coefs, last, end = exr._dwa_ac_blocks(words, 0, n_blocks, "f.exr")
    want = _parse_ac_loop(words, n_blocks)
    assert np.array_equal(coefs, want[0]) and np.array_equal(last, want[1]) and end == want[2]
    with pytest.raises(ValueError, match="f.exr: a DWA chunk's AC words end in block"):
        exr._dwa_ac_blocks(words[:end - 3], 0, n_blocks, "f.exr")


@pytest.mark.parametrize("layer", ["View Layer", "ViewLayer"])
def test_blender_multilayer_depth_stays_exact(jax_tool, tmp_path, monkeypatch, layer):
    """A Blender multilayer render in DWAA: Combined.R/G/B lossy (one RGB
    set), Combined.A run-length coded, Depth.Z (FLOAT, which no rule
    names) in the UNKNOWN section: A and Z bit-exact, R, G and B as the
    same coefficients under plain names (the bgra_half case) read; and
    convert_one as the JAX tool's on what OpenEXR reads."""
    plain = case("bgra_half", tmp_path / "plain.exr")
    want = exr.read_exr(str(tmp_path / "plain.exr"))[1]
    assert _sha(as_cv2(want)) == OPENEXR_SHA256["bgra_half"]
    depth = (np.random.default_rng(1).uniform(7, 16, (H, W))).astype(FLOAT)
    names = {c: f"{layer}.Combined.{c}" for c in "ABGR"} | {"Z": f"{layer}.Depth.Z"}
    channels = sorted([(names[c], d, lin) for c, d, lin in plain.channels] + [(names["Z"], FLOAT, False)])
    img = Image(channels, H, W, {names[c]: v for c, v in plain.coefs.items()},
                {names["A"]: plain.arrays["A"], names["Z"]: depth})
    schemes = dict(zip((n for n, _, _ in channels), classify(channels, DEFAULT_RULES)[0]))
    assert schemes == {names["A"]: RLE, names["B"]: LOSSY, names["G"]: LOSSY, names["R"]: LOSSY, names["Z"]: UNKNOWN}
    write_parts(tmp_path / "render.exr", [img.part("DWAA")])
    planes = exr.read_exr(str(tmp_path / "render.exr"))[1]
    assert planes[names["Z"]].dtype == np.float32 and np.array_equal(planes[names["Z"]], depth)
    for c in "ABGR":
        assert np.array_equal(planes[names[c]].view(np.uint16), want[c].view(np.uint16)), c
    ARRAYS[str(tmp_path / "render.exr")] = {names[c]: want[c] for c in "ABGR"} | {names["Z"]: depth,
                                                                                  "_origin": (0, 0)}
    out = _both(jax_tool, tmp_path, tmp_path / "render.exr", monkeypatch)
    assert sorted(os.listdir(out)) == ["dm_00003.npy", "im_00003.png"]


def test_convert_one_on_a_dwaa_rgba_render_matches_the_jax_tool(jax_tool, tmp_path, monkeypatch):
    """A single-layer RGBA DWAA render: the JAX tool's OpenCV branch, its
    cv2.imread serving the arrays OpenEXR reads (held by their digest),
    against the port's convert_one."""
    case("bgra_half", tmp_path / "render.exr")
    planes = exr.read_exr(str(tmp_path / "render.exr"))[1]
    assert _sha(as_cv2(planes)) == OPENEXR_SHA256["bgra_half"]
    ARRAYS[str(tmp_path / "render.exr")] = dict(planes) | {"_origin": (0, 0)}
    out = _both(jax_tool, tmp_path, tmp_path / "render.exr", monkeypatch, multilayer=False)
    assert np.array_equal(np.load(out / "dm_00003.npy"), planes["A"].astype(np.float32))


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith(("tiled", "multi"))])
def test_tiled_and_multipart_read_as_the_scanline_file(tmp_path, name):
    """Level (0, 0) of a tiled file, and a multipart file's first part,
    equal the same image in a scanline single-part file: ZIP for the
    lossless ones, DWAA (the same blocks in 32-line chunks) for the DWAA
    tiles."""
    img = case(name, tmp_path / "f.exr")
    codec = "DWAA" if name == "tiled_dwaa" else "ZIP"
    write_parts(tmp_path / "scan.exr", [img.part(codec)])
    hdr, got = exr.read_exr(str(tmp_path / "f.exr"))
    _, want = exr.read_exr(str(tmp_path / "scan.exr"))
    assert (hdr.tiles is not None) == name.startswith("tiled") or name == "multi_tiled"
    assert hdr.multipart == name.startswith("multi") and sorted(got) == sorted(want)
    for c in want:
        assert np.array_equal(got[c].view(np.uint16), want[c].view(np.uint16)), c
    if codec == "ZIP":
        assert all(np.array_equal(want[c], img.arrays[c]) for c in want)


def test_level_tables_follow_openexr_order():
    hdr = exr.Header([], "ZIP", (0, 0, 36, 44), "INCREASING_Y", (16, 8, "RIPMAP_LEVELS", True))
    assert exr.level_sizes(hdr) == [(lw, lh) for _, _, lw, lh in levels(37, 45, 2, True)]
    assert exr.level_sizes(hdr)[:7] == [(37, 45), (19, 45), (10, 45), (5, 45), (3, 45), (2, 45), (1, 45)]
    for mode, up, n in ((1, False, 6), (1, True, 7), (0, False, 1)):
        hdr = hdr._replace(tiles=(16, 8, exr.LEVEL_MODES[mode], up))
        assert exr.level_sizes(hdr) == [(lw, lh) for _, _, lw, lh in levels(37, 45, mode, up)] and len(
            exr.level_sizes(hdr)) == n


def test_chunks_that_do_not_shrink_read_raw(tmp_path):
    """OpenEXR reads a chunk stored at or past its raw size as raw pixels
    (its first raw-size bytes), whatever the compression."""
    a = np.random.default_rng(2).uniform(0, 1, (37, 13)).astype(HALF)
    img = Image([("Y", HALF, False)], 37, 13)
    chunks = [(0, a[:32].tobytes()), (32, a[32:].tobytes() + b"\x55" * 7)]
    write_parts(tmp_path / "f.exr", [{"channels": img.channels, "compression": "DWAA", "window": (0, 0, 12, 36),
                                      "tiles": None, "chunks": chunks}])
    assert np.array_equal(exr.read_exr(str(tmp_path / "f.exr"))[1]["Y"], a)


def _damaged(kind: str) -> bytes:
    img = _rgb(np.random.default_rng(4), HALF, h=16, w=40)
    data = bytearray(img.part("DWAA")["chunks"][0][1])
    if kind == "truncated":
        return bytes(data[:-9])
    if kind == "version":
        struct.pack_into("<Q", data, 0, 3)
    elif kind == "ac_coding":
        struct.pack_into("<Q", data, 80, 2)
    elif kind == "rules":
        struct.pack_into("<H", data, 88, 1)
    elif kind == "ac_count":  # one AC word fewer than the blocks need
        img.rules = [(c, LOSSY, 1, i) for i, c in enumerate("RGB")]
        data = bytearray(dwa_chunk(img.channels, {}, {c: v.reshape(-1, 64) for c, v in img.coefs.items()},
                                   img.rules, "deflate"))
        (n_rules,) = struct.unpack_from("<H", data, 88)
        ac_at = 88 + n_rules + struct.unpack_from("<Q", data, 16)[0]
        ac_size, ac_count = struct.unpack_from("<Q", data, 24)[0], struct.unpack_from("<Q", data, 64)[0]
        words = zlib.decompress(bytes(data[ac_at:ac_at + ac_size]))[:-2]
        packed = zlib.compress(words)
        data = data[:ac_at] + packed + data[ac_at + ac_size:]
        struct.pack_into("<Q", data, 24, len(packed))
        struct.pack_into("<Q", data, 64, ac_count - 1)
    elif kind == "uint_lossy":  # a rule that makes a UINT channel lossy, which OpenEXR refuses
        return dwa_chunk([("Y", "<u4", False)], {}, {"Y": random_coefs(np.random.default_rng(0), 16, 40)
                                                     .reshape(-1, 64)}, [("Y", LOSSY, 0, -1)])
    return bytes(data)


@pytest.mark.parametrize("kind,match", [
    ("truncated", "a DWA chunk is truncated"), ("version", "a DWA chunk of version 3"),
    ("ac_coding", "AC coding is 2"), ("rules", "a rule table of 1 bytes"),
    ("ac_count", "AC words end in block"), ("uint_lossy", "codes channel 'Y' lossy"),
])
def test_damaged_dwa_chunks_raise_naming_the_file(kind, match):
    channels = ([exr.Channel("Y", np.dtype("<u4"))] if kind == "uint_lossy"
                else [exr.Channel(c, np.dtype(HALF)) for c in "BGR"])
    for native in (True, False):
        with pytest.raises(ValueError, match=f"bad.exr: .*{match}"):
            exr._dwa(_damaged(kind), channels, 40, 16, "bad.exr", native)


def test_damaged_huffman_ac_raises_in_both_decoders():
    img = _y(np.random.default_rng(5))
    data = img.part("DWAA")["chunks"][0][1]
    (n_rules,) = struct.unpack_from("<H", data, 88)
    at, size, count = 88 + n_rules + struct.unpack_from("<Q", data, 16)[0], *struct.unpack_from("<Q", data, 24), 0
    stream = data[at:at + size]
    count = struct.unpack_from("<Q", data, 64)[0]
    assert np.array_equal(exr.huf_words(stream, count), exr.huf_words_numpy(stream, count))
    for decode in (exr.huf_words, exr.huf_words_numpy):
        with pytest.raises(ValueError, match="bad.exr: a DWA chunk's AC stream (is truncated|decodes to)"):
            decode(stream[:-6], count, "bad.exr", "a DWA chunk's AC stream")


@pytest.mark.parametrize("kind,match", [
    ("deep_part", "a deepscanline part"),
    ("other_part", "the first part's offset table points at a chunk of part 1"),
    ("level", r"a level-0 offset points at tile \(0, 0\) of level \(1, 1\)"),
    ("chunk_count", "the first part's chunkCount is 5, its layout has 3"),
])
def test_other_parts_and_levels_raise_naming_them(tmp_path, kind, match):
    img = _lossless(np.random.default_rng(9), h=40, w=16)
    p0, p1 = img.part("ZIP"), img.part("ZIP")
    parts, types_ = [p0, p1], None
    if kind == "deep_part":
        types_ = {0: "deepscanline"}
    elif kind == "other_part":  # part 0's table and part 1's swapped
        write_parts(tmp_path / "f.exr", parts)
        data = bytearray(open(tmp_path / "f.exr", "rb").read())
        buf = exr._Bytes(bytes(data), "f.exr")
        exr.read_header(buf)  # leaves buf at part 0's offset table, part 1's after it
        raw = struct.unpack_from("<6Q", data, buf.pos)
        struct.pack_into("<6Q", data, buf.pos, *(raw[3:] + raw[:3]))
        open(tmp_path / "f.exr", "wb").write(bytes(data))
    elif kind == "level":
        t = img.part("ZIP", tiles=(16, 16, 1, 0))
        t["chunks"][0], t["chunks"][3] = t["chunks"][3], t["chunks"][0]  # level (1, 1)'s tile first
        parts = [t]
    elif kind == "chunk_count":
        p0["chunks"] = p0["chunks"] + p0["chunks"][:2]
    if kind != "other_part":
        write_parts(tmp_path / "f.exr", parts, types_)
    with pytest.raises(ValueError, match=f"f.exr: {match}"):
        exr.read_exr(str(tmp_path / "f.exr"))
