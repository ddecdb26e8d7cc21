"""The PyTorch port's generation exports on the CPU, held against the JAX
package on the same inputs: the map's surface points and their colours
(`mapping.tsdf.extract_points`, `colorize_points`), the PLY writer and
reader (`mapping.pointcloud`), the native triangle mesh (`mapping.mesh`,
the same C++ source built by the port into its own build directory), the
generator's frame and point-cloud files (`export_frames`,
`export_point_clouds`), the seed templates (`pipeline.templates`) and the
PIL-free PNG codec (`pipeline.png`).

Tolerances: none. Points, colours and the mesh soup are bit-exact; the
PLY files byte-identical; the .npy files equal; PNG pixels equal when
Pillow reads the port's files back (the bytes differ: the port writes
unfiltered rows), and the port's reader equal to Pillow on files Pillow
wrote. The map comes from the JAX package's own integrate (jitted; its
state is carried over with `volume_from_numpy`, so how it was made does
not matter)."""
import os
import shutil
import struct
import warnings
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sgam_neurips22_tpu.mapping import mesh as jmesh
from sgam_neurips22_tpu.mapping import pointcloud as jpc
from sgam_neurips22_tpu.mapping import tsdf as jtsdf
from sgam_neurips22_tpu.pipeline.scene_generation import (
    InfiniteSceneGeneration as JGen,
    SceneGenConfig as JCfg,
)
from sgam_neurips22_tpu.pipeline.templates import load_seed_frames as j_load_seed_frames
from sgam_neurips22_tpu_torch.mapping import mesh, pointcloud, tsdf
from sgam_neurips22_tpu_torch.pipeline import png
from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration, SceneGenConfig
from sgam_neurips22_tpu_torch.pipeline.templates import load_seed_frames
from torch_port_common import H, TINY, TINY_K, W, port_model, tiny_jax_params

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="g++ unavailable: the mesh extractor cannot be built")
MH = MW = 48
MK = np.array([[40.0, 0, 23.5], [0, 40.0, 23.5], [0, 0, 1]], np.float32)
MAP = dict(dims=(64, 64, 64), voxel_size=0.1, sdf_trunc=0.4, origin=(-3.2, -3.2, 0.0), pool_capacity=1 << 12,
           pool_cells=3, render_chunk=1 << 10)


def _poses(n):
    """n world->camera poses looking down +z from small offsets."""
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    out[:, 0, 3] = np.linspace(-0.3, 0.3, n)
    out[:, 1, 3] = np.linspace(0.2, -0.2, n)
    return out


@pytest.fixture(scope="module")
def jax_map():
    """(cfg, JAX volume of 2 scenes, rgbs [2, N, H, W, 3], depths [2, N, H, W],
    w2cs [N, 4, 4]): a wavy surface per scene, 3 frames each, fused by
    the JAX package's integrate; a hashed claim table (claim_bits 16)."""
    cfg = jtsdf.TSDFConfig(**MAP, axis_order=(2, 0, 1), claim_bits=16)
    rng = np.random.default_rng(3)
    n = 3
    w2cs = _poses(n)
    yy, xx = np.mgrid[0:MH, 0:MW]
    depths = np.stack([np.stack([3.0 + 0.4 * s + 0.3 * np.sin(xx / 5.0 + i) * np.cos(yy / 7.0)
                                 for i in range(n)]) for s in range(2)]).astype(np.float32)
    depths[:, :, :4, :4] = 0.0  # invalid pixels
    rgbs = rng.uniform(-1, 1, (2, n, MH, MW, 3)).astype(np.float32)
    vol = jtsdf.create_volume(cfg, n_scenes=2)
    for i in range(n):
        vol = jtsdf.integrate(vol, cfg, jnp.asarray(depths[:, i]), None, jnp.asarray(MK), jnp.asarray(w2cs[i]))
    return cfg, vol, rgbs, depths, w2cs


def _port_volume(jvol):
    return tsdf.volume_from_numpy({f: np.asarray(getattr(jvol, f)) for f in tsdf.FIELDS}, device="cpu")


def _port_cfg(jcfg):
    import dataclasses

    return tsdf.TSDFConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("scene", [0, 1])
def test_extract_and_colorize_points_match_jax(jax_map, scene):
    cfg, jvol, rgbs, depths, w2cs = jax_map
    pts, cols = tsdf.extract_points(_port_volume(jvol), _port_cfg(cfg), scene=scene)
    j_pts, j_cols = jtsdf.extract_points(jvol, cfg, scene=scene)
    assert len(pts) > 100 and pts.dtype == np.float32
    np.testing.assert_array_equal(pts, j_pts)
    np.testing.assert_array_equal(cols, j_cols)
    got = tsdf.colorize_points(pts, rgbs[scene], depths[scene], MK, w2cs, tol=0.4)
    ref = jtsdf.colorize_points(j_pts, rgbs[scene], depths[scene], MK, w2cs, tol=0.4)
    np.testing.assert_array_equal(got, ref)
    assert (got != 0.5).any(axis=1).mean() > 0.5  # most points take a frame's colour
    # a tighter band: fewer voxels
    assert len(tsdf.extract_points(_port_volume(jvol), _port_cfg(cfg), max_abs_tsdf=0.3, scene=scene)[0]) < len(pts)


def test_volume_views_match_jax(jax_map):
    cfg, jvol, _, _, _ = jax_map
    vol = _port_volume(jvol)
    np.testing.assert_array_equal(vol.tsdf.numpy(), np.asarray(jvol.tsdf))
    np.testing.assert_array_equal(vol.weight.numpy(), np.asarray(jvol.weight))


@pytest.mark.parametrize("colors", [True, False])
def test_write_ply_byte_identical(tmp_path, colors):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(257, 3)).astype(np.float32)
    cols = rng.uniform(-0.1, 1.1, (257, 3)).astype(np.float32) if colors else None
    pointcloud.write_ply(str(tmp_path / "port.ply"), pts, cols)
    jpc.write_ply(str(tmp_path / "jax.ply"), pts, cols)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    got_pts, got_cols = pointcloud.read_ply(str(tmp_path / "port.ply"))
    np.testing.assert_array_equal(got_pts, pts)
    if colors:
        np.testing.assert_array_equal(got_cols, np.clip(cols * 255.0, 0, 255).astype(np.uint8) / np.float32(255.0))
    else:
        assert got_cols is None


@pytest.mark.parametrize("k", [TINY_K, MK.astype(np.float64)])
def test_unproject_matches_jax(k):
    rng = np.random.default_rng(5)
    rgb = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
    depth = rng.uniform(7, 16, (H, W)).astype(np.float32)
    depth[0, :5] = 0.0
    c2w = np.linalg.inv(_poses(2)[1].astype(np.float64))
    for stride in (1, 2):
        got = pointcloud.unproject_to_color_point_cloud(rgb, depth, k, c2w, stride)
        ref = jpc.unproject_to_color_point_cloud(rgb, depth, k, c2w, stride)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="pinhole"):
        pointcloud.pinhole_inverse(np.array([[20.0, 1.0, 15.5], [0, 20.0, 15.5], [0, 0, 1]]))


@needs_gxx
def test_extract_mesh_matches_jax(jax_map, tmp_path):
    """One scene's block of the map, in the layout axis_order (2, 0, 1)
    gives it, meshed by the port's build of native/mesh_extract.cpp and by
    the JAX package's: the same soup, and the same PLY bytes."""
    import dataclasses

    cfg, jvol, _, _, _ = jax_map
    n = int(np.prod(cfg.dims))
    jvol1 = dataclasses.replace(jvol, grid=jvol.grid[:n])
    pvol1 = _port_volume(jvol)
    pvol1.grid = pvol1.grid[:n]
    verts, cols = mesh.extract_mesh(pvol1, _port_cfg(cfg))
    j_verts, j_cols = jmesh.extract_mesh(jvol1, cfg)
    assert len(verts) > 100
    np.testing.assert_array_equal(verts, j_verts)
    np.testing.assert_array_equal(cols, j_cols)
    capped, _ = mesh.extract_mesh(pvol1, _port_cfg(cfg), max_triangles=10)
    np.testing.assert_array_equal(capped, verts[:10])
    mesh.write_mesh_ply(str(tmp_path / "port.ply"), verts, cols)
    jmesh.write_mesh_ply(str(tmp_path / "jax.ply"), j_verts, j_cols)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    assert mesh.lib_path().parent == mesh.BUILD_DIR and mesh.lib_path().exists()
    with pytest.raises(ValueError, match="one-scene"):
        mesh.extract_mesh(_port_volume(jvol), _port_cfg(cfg))


def _generators(tmp_path, integration: bool):
    """A JAX and a port generator on one 2x2 map-requery (or splat)
    configuration, with the same random frame buffers, every pose visited,
    and (map re-query) the JAX volume of every frame fused, carried over."""
    params = tiny_jax_params()
    kw = dict(dataset="clevr-infinite", output_dim=(2, 2), num_src=2, topk=1, image_resolution=(H, W),
              use_rgbd_integration=integration, tsdf_mem_cap_gb=0.05, tsdf_pool_capacity=1 << 16)
    rng = np.random.default_rng(6)
    rgb = rng.uniform(-1.1, 1.1, (4, H, W, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    depth = np.stack([9.0 + 0.5 * i + np.sin(xx / 4.0) * np.cos(yy / 6.0) for i in range(4)]).astype(np.float32)
    depth[:, :2, :3] = 0.0
    seeds = [((0, 0), rgb[0], depth[0])]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jgen = JGen(params, TINY, JCfg(**kw), seeds=seeds, intrinsics=TINY_K)
        gen = InfiniteSceneGeneration(port_model(params, TINY), SceneGenConfig(**kw), seeds, intrinsics=TINY_K,
                                      device="cpu")
    jgen.rgb_buf, jgen.depth_buf = jnp.asarray(rgb), jnp.asarray(depth)
    gen.rgb_buf, gen.depth_buf = torch.as_tensor(rgb), torch.as_tensor(depth)
    jgen.grid.visited[:] = True
    gen.grid.visited[:] = True
    if integration:
        for idx in range(1, 4):
            jgen.volume = jgen._integrate(idx)
        gen.volume = _port_volume(jgen.volume)
    return jgen, gen


@pytest.mark.parametrize("integration", [pytest.param(True, marks=needs_gxx), False])
def test_export_files_match_jax(tmp_path, integration):
    jgen, gen = _generators(tmp_path, integration)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jgen.export_frames(str(jdir))
    jgen.export_point_clouds(str(jdir))
    gen.export_frames(str(pdir))
    gen.export_point_clouds(str(pdir))
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == names
    want = {"merged_pcds.ply"} | ({"rgbd_integrated_mesh.ply", "rgbd_integrated_trimesh.ply"} if integration else set())
    assert want <= set(names) and sum(n.startswith("im_") for n in names) == 4
    for name in names:
        ours, ref = pdir / name, jdir / name
        if name.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(ours)), np.asarray(Image.open(ref)), err_msg=name)
            np.testing.assert_array_equal(png.read_png(str(ours)), np.asarray(Image.open(ref)), err_msg=name)
        elif name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(ours), np.load(ref), err_msg=name)
        else:
            assert ours.read_bytes() == ref.read_bytes(), name
    # one frame alone, as the streamed unroll writes it
    gen.export_frame(str(tmp_path / "one"), 3, (1, 1))
    assert sorted(os.listdir(tmp_path / "one")) == [f"{p}_00003_01_01.{e}" for p, e in
                                                    (("R", "npy"), ("dm", "npy"), ("im", "png"), ("t", "npy"))]


def _filtered_png(path, img, ftype):
    """An 8-bit RGB PNG whose every row uses row filter `ftype` (0-4),
    encoded as the PNG specification defines each filter."""
    h, w, c = img.shape
    raw = img.astype(np.int64).reshape(h, w * c)
    rows = []
    for y in range(h):
        up = raw[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), raw[y, :-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if ftype == 0:
            pred = np.zeros_like(left)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        rows.append(bytes([ftype]) + ((raw[y] - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def test_png_reader_matches_pillow(tmp_path):
    rng = np.random.default_rng(8)
    yy, xx = np.mgrid[0:37, 0:53]
    smooth = np.stack([xx * 4, yy * 6, (xx + yy) * 2, 255 - xx], axis=-1).astype(np.uint8)
    noisy = rng.integers(0, 256, (37, 53, 4), dtype=np.uint8)
    for name, img in (("gray", smooth[..., 0]), ("gray_noise", noisy[..., 0]), ("rgb", smooth[..., :3]),
                      ("rgb_noise", noisy[..., :3]), ("rgba", smooth), ("rgba_noise", noisy)):
        path = str(tmp_path / f"{name}.png")
        Image.fromarray(img).save(path)
        np.testing.assert_array_equal(png.read_png(path), np.asarray(Image.open(path)), err_msg=name)
        png.write_png(str(tmp_path / f"{name}_port.png"), img)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / f"{name}_port.png")), img, err_msg=name)
    for ftype in range(5):
        path = str(tmp_path / f"filter{ftype}.png")
        _filtered_png(path, noisy[..., :3], ftype)
        np.testing.assert_array_equal(png.read_png(path), np.asarray(Image.open(path)), err_msg=f"filter {ftype}")
        np.testing.assert_array_equal(png.read_png(path), noisy[..., :3])
    Image.fromarray(smooth[..., :3]).convert("P").save(tmp_path / "palette.png")
    with pytest.raises(ValueError, match="palette"):
        png.read_png(str(tmp_path / "palette.png"))
    Image.fromarray((smooth[..., 0].astype(np.uint16) * 200)).save(tmp_path / "gray16.png")
    with pytest.raises(ValueError, match="16-bit gray"):
        png.read_png(str(tmp_path / "gray16.png"))


@pytest.mark.parametrize("dataset,size", [("clevr-infinite", 32), ("clevr-infinite", 24), ("google_earth", 32)])
def test_seed_templates_match_jax(tmp_path, dataset, size):
    """Templates in the reference layout, at the target resolution (read
    without Pillow) and at another (resized with Pillow's LANCZOS, as JAX)."""
    rng = np.random.default_rng(9)
    root = tmp_path / "templates"
    if dataset == "clevr-infinite":
        dirs, names = [root], ["00000_00_00", "00001_00_01"]
    else:
        dirs, names = [root / "seed0", root / "seed1"], ["00000"]
    for d in dirs:
        os.makedirs(d)
        for name in names:
            Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(d / f"im_{name}.png")
            np.save(d / f"dm_{name}.npy", rng.uniform(8, 14, (1, size, size)).astype(np.float32))
    for k in range(len(dirs)):
        got = load_seed_frames(str(root), dataset, k, (32, 32))
        ref = j_load_seed_frames(str(root), dataset, k, (32, 32))
        assert [c for c, _, _ in got] == [c for c, _, _ in ref] and len(got) == len(names)
        for (_, rgb, depth), (_, j_rgb, j_depth) in zip(got, ref):
            np.testing.assert_array_equal(rgb, j_rgb)
            np.testing.assert_array_equal(depth, j_depth)
    with pytest.raises(FileNotFoundError):
        load_seed_frames(str(tmp_path / "empty"), "clevr-infinite", 0, (32, 32))
