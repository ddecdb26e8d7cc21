"""The PyTorch port's camera, pose, warp and TSDF map on the CPU, held
against the JAX package run op by op (under jax.disable_jit, the
reference) on the same numpy inputs.

Tolerances:
- camera, pose, the ray/z conversions, cam2pixel, plane_z_depth and the
  four warp functions: bit-exact against JAX; against the frozen
  tests/goldens/warp.npz at that test's tolerances (pixel2cam 1e-4,
  cam2pixel 1e-5, inverse_warp 1e-4, its mask exact); euler2mat,
  quat2mat and pose_vec2mat at atol 1e-6 (3x3 matrix products, whose
  summation order the two libraries choose);
- to_int32: equal to XLA's float -> int32 conversion, NaN, +-inf,
  +-3e9 and halves included;
- auto_config and TSDFConfig: equal;
- integrate: every state tensor (grid, inpool, pool_ids, cell_counts,
  stats, frame, claim) bit-exact after 3 frames;
- render_depth: bit-exact, splat (cull on and off, the JAX side through
  its XLA scatter and once through its Pallas merge in interpret mode) and
  raycast (nearest and trilinear), from one volume state carried across.

Why op by op: XLA compiles a jitted program, and a lax.cond branch even
outside jit (the JAX pool splat's sub-chunks), with multiply-adds
contracted into FMAs and divisions by a constant folded into reciprocal
multiplications; that moves a voxel centre, a pixel or a voxel id across a
boundary now and then. The port's arithmetic is JAX's op by op."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu.geometry import camera as jcam
from sgam_neurips22_tpu.geometry import pose as jpose
from sgam_neurips22_tpu.geometry import warp as jwarp
from sgam_neurips22_tpu.mapping import tsdf as jtsdf
from sgam_neurips22_tpu.pipeline.scene_generation import SceneGenConfig as JCfg
from sgam_neurips22_tpu.pipeline.scene_generation import _build_grid as j_build_grid
from sgam_neurips22_tpu.pipeline.scene_generation import _tsdf_config as j_tsdf_config
from sgam_neurips22_tpu.geometry.codec import get_codec as j_get_codec
from sgam_neurips22_tpu_torch.core.dtypes import to_int32
from sgam_neurips22_tpu_torch.geometry import camera, pose, warp
from sgam_neurips22_tpu_torch.mapping import tsdf
from sgam_neurips22_tpu_torch.pipeline.scene_generation import SceneGenConfig, _tsdf_config
from sgam_neurips22_tpu_torch.pipeline.trajectory import default_intrinsics, prepare_grid
from torch_port_common import t

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
B, N, H, W = 2, 3, 32, 32
K = np.array([[20.0, 0, (W - 1) / 2], [0, 20.0, (H - 1) / 2], [0, 0, 1]], np.float32)
# the JAX mapping tests' frames: 48^2, f = 40, a 64^3 volume of 0.1 voxels
MH = MW = 48
MK = np.array([[40.0, 0, 23.5], [0, 40.0, 23.5], [0, 0, 1]], np.float32)
MAP = dict(dims=(64, 64, 64), voxel_size=0.1, sdf_trunc=0.4, origin=(-3.2, -3.2, 0.0), pool_capacity=1 << 12,
           pool_cells=3, render_chunk=1 << 10)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: its CPU work is many small ops,
    and the tier-1 run's workers share the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def op_by_op():
    with jax.disable_jit():
        yield


def _rot(rng, b, scale=0.05):
    """Near-orthonormal rotations [b, 3, 3] (second-order exponential)."""
    out = np.zeros((b, 3, 3), np.float32)
    for i in range(b):
        a = rng.normal(size=3) * scale
        kx = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        out[i] = np.eye(3) + kx + kx @ kx / 2
    return out


def test_to_int32_has_xla_semantics():
    x = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.5, -2.5, 0.5, -0.5, 1.7, -1.7, 2147483520.0,
                  -2147483648.0, 2147483648.0, 0.0], np.float32)
    np.testing.assert_array_equal(to_int32(torch.tensor(x)).numpy(), np.asarray(jnp.asarray(x).astype(jnp.int32)))


def test_camera_matches_jax():
    rng = np.random.default_rng(0)
    cam_pts = (rng.normal(size=(B, H, W, 3)) + [0, 0, 10]).astype(np.float32)
    cam_pts[0, 0, :4, 2] = [0.0, -1e-4, 1e-4, -3.0]  # z clamped, behind, at 0
    rot, tr = _rot(rng, B) * 20, rng.normal(size=(B, 3)).astype(np.float32)
    for clamp in (1e-3, None):
        got = camera.cam2pixel(t(cam_pts), t(rot), t(tr), clamp)
        ref = jcam.cam2pixel(cam_pts, rot, tr, clamp)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = camera.cam2pixel(t(cam_pts), t(rot), t(tr[..., None]))[0]  # tr [B, 3, 1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcam.cam2pixel(cam_pts, rot, tr[..., None])[0]))

    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3], w2c[:3, 3] = _rot(rng, 1, 0.3)[0], [1.0, 2.0, 3.0]
    n = np.array([0.1, 0.3, 0.95], np.float32)
    n /= np.linalg.norm(n)
    got = camera.plane_z_depth(t(K), t(w2c), t(n), torch.tensor(5.0), (H, W), 0.1, 30.0)
    ref = jcam.plane_z_depth(K, w2c, n, np.float32(5.0), (H, W), 0.1, 30.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    depth = rng.uniform(1, 10, (B, H, W)).astype(np.float32)
    for fn in ("ray_depth_to_z", "z_depth_to_ray"):
        np.testing.assert_array_equal(getattr(camera, fn)(t(depth), t(K)).numpy(),
                                      np.asarray(getattr(jcam, fn)(depth, K)))


def test_pose_matches_jax():
    rng = np.random.default_rng(1)
    vec = rng.normal(size=(4, 6)).astype(np.float32)
    np.testing.assert_allclose(pose.euler2mat(t(vec[:, 3:])).numpy(), np.asarray(jpose.euler2mat(vec[:, 3:])),
                               atol=1e-6)
    np.testing.assert_allclose(pose.quat2mat(t(vec[:, 3:])).numpy(), np.asarray(jpose.quat2mat(vec[:, 3:])),
                               atol=1e-6)
    for mode in ("euler", "quat"):
        np.testing.assert_allclose(pose.pose_vec2mat(t(vec), mode).numpy(),
                                   np.asarray(jpose.pose_vec2mat(vec, mode)), atol=1e-6)
    with pytest.raises(ValueError):
        pose.pose_vec2mat(t(vec), "axis")


def test_warp_matches_golden():
    """tests/test_goldens.py::test_warp_functions_match_golden, on the port."""
    g = np.load(os.path.join(GOLDENS, "warp.npz"))
    ks = np.tile(g["K"], (g["depth"].shape[0], 1, 1)).astype(np.float32)
    pc = camera.pixel2cam(t(g["depth"]), t(np.linalg.inv(ks)))
    np.testing.assert_allclose(pc.numpy(), g["pixel2cam"].transpose(0, 2, 3, 1), atol=1e-4)
    proj = ks @ g["pose"]
    coords, z = camera.cam2pixel(pc, t(proj[..., :3]), t(proj[..., 3]))
    np.testing.assert_allclose(coords.numpy(), g["cam2pixel_coords"], atol=1e-5)
    np.testing.assert_allclose(z.numpy(), g["cam2pixel_z"], atol=1e-5)
    warped, valid = warp.inverse_warp(t(g["src_img"]), t(g["depth"]), t(g["src_depth"]), t(g["pose"]), t(ks), t(ks))
    np.testing.assert_allclose(warped.numpy(), g["inverse_warp"].transpose(0, 2, 3, 1), atol=1e-4)
    np.testing.assert_array_equal(valid.numpy()[..., 0], g["inverse_warp_valid"][:, 0].astype(bool))


def _warp_inputs(seed=2):
    """Sources, and a target depth with holes (zeros) at every 3rd row and
    4th column: there the target point is the camera centre, so the
    projection divides 0 by z, and where a source's translation has no z
    component (source 0 of scene 0) by 0: NaN and infinite coordinates."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(8, 14, (B, H, W)).astype(np.float32)
    tgt[:, ::3, ::4] = 0.0
    src_d = rng.uniform(8, 14, (B, N, H, W)).astype(np.float32)
    src_i = rng.uniform(-1, 1, (B, N, H, W, 3)).astype(np.float32)
    t2s = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    t2s[..., :3, :3] = _rot(rng, B * N).reshape(B, N, 3, 3)
    t2s[..., :3, 3] = rng.normal(size=(B, N, 3)) * 0.5
    t2s[0, 0, :3, 3] = [0.5, 0.0, 0.0]
    t2s[0, 1, :3, :] = np.eye(3, 4)  # the target's own pose: every hole at (0, 0) * inf
    return src_i, src_d, tgt, np.tile(K, (B, N, 1, 1)), np.tile(K, (B, 1, 1)), t2s


def test_warps_match_jax():
    src_i, src_d, tgt, ks, kt, t2s = _warp_inputs()
    got = warp.inverse_warp_multi_src(*(t(a) for a in (src_i, src_d, tgt, ks, kt, t2s))).numpy()
    ref = np.asarray(jwarp.inverse_warp_multi_src(src_i, src_d, tgt, ks, kt, t2s))
    np.testing.assert_array_equal(got, ref)
    assert (got == 0).all(-1).mean() > 0.01 and (got != 0).any(-1).mean() > 0.5

    pose34 = t2s[:, 0, :3, :]
    got = warp.inverse_warp(t(src_i[:, 0]), t(tgt), t(src_d[:, 0]), t(pose34), t(kt), t(kt))
    ref = jwarp.inverse_warp(src_i[:, 0], tgt, src_d[:, 0], pose34, kt, kt)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    rng = np.random.default_rng(3)
    grid = rng.uniform(-1.2, 1.2, (B, H, W, 2)).astype(np.float32)
    grid[0, 0, :4] = [[np.nan, np.nan], [np.inf, 0.0], [-np.inf, np.nan], [3e9, -3e9]]
    grid[1, 0, :2] = [[-1.0 - 1.0 / W, 0.0], [1.0 + 1.0 / W, 0.0]]  # exactly half a pixel outside
    for fn in ("grid_sample_nearest", "grid_sample_bilinear"):
        got = getattr(warp, fn)(t(src_i[:, 0]), t(grid)).numpy()
        ref = np.asarray(getattr(jwarp, fn)(src_i[:, 0], grid))
        np.testing.assert_array_equal(got, ref, err_msg=fn)
    # the NaN coordinate lands at pixel (0, 0) in JAX, and so in the port
    np.testing.assert_array_equal(got[0, 0, 0], ref[0, 0, 0])


@pytest.mark.parametrize("dataset,shape,extra", [
    ("clevr-infinite", (3, 3), {}), ("google_earth", (25, 1), {}),
    ("clevr-infinite", (3, 3), dict(tsdf_dims=(64, 48, 32), tsdf_voxel_size=0.1, tsdf_render_chunk=1 << 10,
                                    tsdf_pool_recycle=False, tsdf_band_voxels=4)),
], ids=["clevr_auto", "google_earth_auto", "clevr_manual"])
def test_tsdf_config_matches_jax(dataset, shape, extra):
    """The map of bench.py's map-requery cells (CLEVR 3x3, google_earth
    25x1, 256^2, auto volume), and a volume placed by hand: auto_config or
    the manual branch, and every TSDFConfig property."""
    kw = dict(dataset=dataset, output_dim=shape, image_resolution=(256, 256), use_rgbd_integration=True, **extra)
    grid = prepare_grid(dataset, shape, 2.0, default_intrinsics(dataset, (256, 256)))
    got = _tsdf_config(SceneGenConfig(**kw), grid, j_get_codec(dataset).depth_range)
    jcfg = JCfg(**kw)
    ref = j_tsdf_config(jcfg, j_build_grid(jcfg), j_get_codec(dataset).depth_range)
    for f in ("dims", "voxel_size", "sdf_trunc", "origin", "band_voxels", "pool_capacity", "pool_recycle",
              "integrate_stride", "render_chunk", "pool_cells", "axis_order", "claim_bits"):
        assert getattr(got, f) == getattr(ref, f), f
    for p in ("split_axis", "n_cells", "cell_cap", "capacity", "chunk", "band", "trunc", "claim_size"):
        assert getattr(got, p) == getattr(ref, p), p
    assert got.cell_bounds() == ref.cell_bounds()
    lin = np.array([0, 1, 12345, got.n_voxels - 1, -7], np.int32)
    np.testing.assert_array_equal(got.claim_index(t(lin)).numpy(), np.asarray(ref.claim_index(jnp.asarray(lin))))
    g = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    np.testing.assert_array_equal(got.lin_index(t(g)).numpy(), np.asarray(ref.lin_index(jnp.asarray(g))))
    for a, b in zip(got.unlin_index(t(lin[:4])), ref.unlin_index(jnp.asarray(lin[:4]))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the memory cap coarsens the voxel (with a warning) instead of cropping
    c2ws = np.stack([grid.c2w(i) for i in range(grid.size)])
    args = (c2ws, grid.K, (256, 256), j_get_codec(dataset).depth_range, 0.01, 0.03)
    with pytest.warns(UserWarning, match="coarsened"):
        small = tsdf.auto_config(*args, mem_cap_bytes=5e7)
    assert dataclasses.astuple(small) == dataclasses.astuple(jtsdf.auto_config(*args, mem_cap_bytes=5e7, verbose=False))
    assert small.voxel_size > 0.01


def _frames(ns, stride_shift=0.2):
    """3 frames of depth with holes and noise, from poses moving along x."""
    rng = np.random.default_rng(4)
    out = []
    for f in range(3):
        d = rng.uniform(2.0, 4.0, (ns, MH, MW)).astype(np.float32)
        d[:, ::7, ::5] = 0.0
        e = np.tile(np.eye(4, dtype=np.float32), (ns, 1, 1))
        e[:, 0, 3] = stride_shift * f + 0.05 * np.arange(ns)
        e[:, 1, 3] = -0.1 * f
        out.append((d, e))
    return out


def _state(vol):
    return {f: np.asarray(getattr(vol, f)) for f in tsdf.FIELDS}


@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("kw", [
    dict(), dict(pool_recycle=False), dict(integrate_stride=2), dict(integrate_stride=2, pool_recycle=False),
    dict(claim_bits=10),  # hashed claim and inpool tables
], ids=["recycle", "drop", "stride2", "stride2_drop", "hashed"])
def test_integrate_matches_jax(ns, kw):
    """Three frames into a 3-cell pool of 1024 slots (342 a cell, so the
    frames overflow it: recycled, or dropped), at S = 1 and 2."""
    cfg = {**MAP, "pool_capacity": 1 << 10, **kw}
    jc, pc = jtsdf.TSDFConfig(**cfg), tsdf.TSDFConfig(**cfg)
    jv, pv = jtsdf.create_volume(jc, ns), tsdf.create_volume(pc, ns, device="cpu")
    for d, e in _frames(ns):
        d, e = (d[0], e[0]) if ns == 1 else (d, e)
        jv = jtsdf.integrate(jv, jc, jnp.asarray(d), None, jnp.asarray(MK), jnp.asarray(e))
        assert tsdf.integrate(pv, pc, t(d), None, t(MK), t(e)) is pv
    ref = _state(jv)
    for f in tsdf.FIELDS:
        np.testing.assert_array_equal(getattr(pv, f).numpy(), ref[f], err_msg=f)
    frac, n_valid, dropped, recycled = tsdf.fusion_fraction(pv)
    assert (frac, n_valid, dropped, recycled) == jtsdf.fusion_fraction(jv)
    assert n_valid > 0 and (recycled > 0 if pc.pool_recycle else dropped > 0)
    with pytest.raises(ValueError, match="holds"):
        tsdf.integrate(pv, pc, t(np.zeros((ns + 1, MH, MW), np.float32)), None, t(MK), t(np.eye(4, dtype=np.float32)))


@pytest.fixture(scope="module")
def map_state():
    """One JAX volume after 3 frames (a noisy wall at 3.0, 2.7 and 2.4 from
    poses moving along x), carried into the port with volume_from_numpy."""
    jc, pc = jtsdf.TSDFConfig(**MAP), tsdf.TSDFConfig(**MAP)
    rng = np.random.default_rng(5)
    jv = jtsdf.create_volume(jc)
    for f in range(3):
        d = (np.full((MH, MW), 3.0 - 0.3 * f) + rng.uniform(-0.05, 0.05, (MH, MW))).astype(np.float32)
        e = np.eye(4, dtype=np.float32)
        e[0, 3] = 0.3 * f
        with jax.disable_jit():
            jv = jtsdf.integrate(jv, jc, jnp.asarray(d), None, jnp.asarray(MK), jnp.asarray(e))
    pv = tsdf.volume_from_numpy(_state(jv), device="cpu")
    for f in tsdf.FIELDS:
        np.testing.assert_array_equal(getattr(pv, f).numpy(), np.asarray(getattr(jv, f)))
    tgt = np.eye(4, dtype=np.float32)
    tgt[:2, 3] = [0.35, 0.1]
    return jc, jv, pc, pv, tgt


@pytest.mark.parametrize("cull,pallas", [(True, False), (False, False), (True, True)],
                         ids=["cull", "no_cull", "jax_pallas_interpret"])
def test_render_splat_matches_jax(map_state, cull, pallas):
    """The pool splat: the z-buffer's winners bit-exact (the decoded slot of
    each pixel, before refinement and filling) and the rendered depth."""
    jc, jv, pc, pv, tgt = map_state
    ref = np.asarray(jtsdf._render_depth_splat(jv, jc, MK, tgt, (MH, MW), 1.0, 5.0, cull=cull, pallas=pallas))
    got = tsdf._render_depth_splat(pv, pc, t(MK), t(tgt), (MH, MW), 1.0, 5.0, cull=cull).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got > 0).mean() > 0.9
    ref_raw = np.asarray(jtsdf._render_depth_splat(jv, jc, MK, tgt, (MH, MW), 1.0, 5.0, refine=False, pallas=pallas))
    # without refinement and the two fill passes, the winners' depths alone
    from sgam_neurips22_tpu_torch.ops.zbuffer import zbuffer_min_plain

    pix, key, z, starts = tsdf.pool_splat_keys(pv, pc, t(MK), t(tgt)[None], (MH, MW), 1.0, 5.0, cull)
    wins = zbuffer_min_plain(pix, key, MH, MW)
    assert wins.shape == (len(starts), MH * MW) and (wins != tsdf.INT32_MAX).any()
    raw = tsdf._render_depth_splat(pv, pc, t(MK), t(tgt), (MH, MW), 1.0, 5.0, refine=False).numpy()
    np.testing.assert_array_equal(raw, ref_raw)


@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
def test_render_raycast_matches_jax(map_state, interp):
    jc, jv, pc, pv, tgt = map_state
    kw = dict(n_samples=128, method="raycast", interp=interp)
    ref = np.asarray(jtsdf.render_depth(jv, jc, MK, tgt, (MH, MW), 1.0, 5.0, **kw))
    got = tsdf.render_depth(pv, pc, t(MK), t(tgt), (MH, MW), 1.0, 5.0, **kw).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got > 0).mean() > 0.1
    with pytest.raises(NotImplementedError, match="splat"):
        tsdf.render_depth(pv, pc, t(MK), t(tgt)[None], (MH, MW), 1.0, 5.0, method="raycast")


def test_batched_render_matches_jax():
    """The splat's S-scene index arithmetic: two scenes fused in one
    volume, rendered at two poses at once."""
    jc, pc = jtsdf.TSDFConfig(**MAP), tsdf.TSDFConfig(**MAP)
    jv, pv = jtsdf.create_volume(jc, 2), tsdf.create_volume(pc, 2, device="cpu")
    for d, e in _frames(2, 0.3):
        jv = jtsdf.integrate(jv, jc, jnp.asarray(d), None, jnp.asarray(MK), jnp.asarray(e))
        tsdf.integrate(pv, pc, t(d), None, t(MK), t(e))
    exts = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    exts[:, 0, 3] = [0.3, 0.1]
    ref = np.asarray(jtsdf.render_depth(jv, jc, MK, exts, (MH, MW), 1.0, 5.0, pallas=False))
    got = tsdf.render_depth(pv, pc, t(MK), t(exts), (MH, MW), 1.0, 5.0).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (2, MH, MW) and not np.array_equal(got[0], got[1])
