"""The port's EXR reader (`pipeline/exr.py`) and converter (`convert_exr.py`)
against the JAX tool (`tools/convert_exr.py`), on the CPU.

EXR files are written here byte by byte from the OpenEXR file layout
(`write_exr`: `struct` and `zlib`, independent of the port's reader): NONE,
RLE, ZIPS and ZIP; HALF, FLOAT and UINT channels; both line orders; a data
window off the origin; Blender's multilayer channel names in both
view-layer namings; single-layer RGBA files and an RGB file with an
Image -> Depth sibling. Each case runs the JAX tool's own `convert_one` on
the same arrays: its multilayer branch through stub `OpenEXR` / `Imath`
modules that serve them (as OpenEXR reads a channel as FLOAT), its OpenCV
branch (OpenEXR unimportable) through a stub `cv2.imread` that returns them
as OpenCV does (BGR(A) float32; this cv2 has no EXR codec). The file names,
the `.npy` bytes and the PNG pixels must be equal. PIZ and the other codecs,
tiled, deep and multipart files, subsampled channels and a file without
RGB raise errors that name what they lack.
"""
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
CHUNK_LINES = {"NONE": 1, "RLE": 1, "ZIPS": 1, "ZIP": 16}
PIXEL_CODE = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1, np.dtype(np.float32): 2}
ARRAYS = {}  # path -> {channel: array}: what the stubs serve


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


def _compress(raw: bytes, compression: str) -> bytes:
    if compression == "NONE":
        return raw
    packed = _split_predict(raw)
    data = _rle(packed) if compression == "RLE" else zlib.compress(packed)
    return data if len(data) < len(raw) else raw  # stored raw where it does not shrink, as OpenEXR does


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
    for s in starts:
        raw = b"".join(np.ascontiguousarray(channels[n][r]).astype(channels[n].dtype.newbyteorder("<")).tobytes()
                       for r in range(s, min(s + lines, h)) for n in names)
        data = _compress(raw, compression)
        compressed += len(data) < len(raw)
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
    ARRAYS[str(path)] = {n: channels[n] for n in names} | {"_origin": origin}
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
@pytest.mark.parametrize("compression", ["NONE", "RLE", "ZIPS", "ZIP"])
@pytest.mark.parametrize("ptype", ["HALF", "FLOAT", "UINT"])
def test_multilayer_matches_the_jax_tool(jax_tool, tmp_path, monkeypatch, compression, ptype):
    dtype = {"HALF": np.float16, "FLOAT": np.float32, "UINT": np.uint32}[ptype]
    rng = np.random.default_rng(len(compression) * 7 + len(ptype))
    ch = _blender(rng)
    for c in "RGB":
        ch[f"View Layer.Combined.{c}"] = smooth(rng, H, W, dtype)
    ch["View Layer.Depth.Z"] = (smooth(rng, H, W, np.float32) * 9 + 7).astype(dtype)
    stats = write_exr(tmp_path / "f.exr", ch, compression)
    if compression != "NONE":
        assert stats["compressed"] > 0  # the codec's decoder ran
    out = _both(jax_tool, tmp_path, tmp_path / "f.exr", monkeypatch)
    assert sorted(os.listdir(out)) == ["dm_00003.npy", "im_00003.png", "in_00003.npy"]
    hdr, planes = exr.read_exr(str(tmp_path / "f.exr"))
    assert hdr.compression == compression
    for name, arr in ch.items():
        assert planes[name].dtype == arr.dtype and np.array_equal(planes[name], arr), name


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


@pytest.mark.parametrize("codec", ["PIZ", "PXR24", "B44", "B44A", "DWAA", "DWAB"])
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
