"""The PyTorch port's geometry and conditioning on the CPU, held against the
JAX package: camera and codec at atol 1e-6, the median network bit-exact
against its golden, the nearest splat and get_x against JAX at B=2, N=3."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu.geometry import camera as jcam
from sgam_neurips22_tpu.geometry.codec import get_codec as j_get_codec
from sgam_neurips22_tpu.geometry.splat import render_projection_from_srcs as j_render
from sgam_neurips22_tpu.models.conditioning import get_x as j_get_x
from sgam_neurips22_tpu_torch.geometry import camera
from sgam_neurips22_tpu_torch.geometry.codec import get_codec
from sgam_neurips22_tpu_torch.geometry.splat import median_blur_3x3, render_projection_from_srcs
from sgam_neurips22_tpu_torch.models.conditioning import get_x
from torch_port_common import t

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
B, N, H, W = 2, 3, 32, 32


def _poses(rng, b, n):
    """Small random rotations + translations, source -> target."""
    r = np.zeros((b, n, 3, 3), np.float32)
    for i in range(b):
        for j in range(n):
            a = rng.normal(size=3) * 0.05
            kx = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
            r[i, j] = np.eye(3) + kx + kx @ kx / 2  # near-orthonormal
    tr = (rng.normal(size=(b, n, 3)) * 0.3).astype(np.float32)
    return r, tr


def _splat_inputs(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.uniform(-1, 1, (B, N, H, W, 3)).astype(np.float32)
    depths = rng.uniform(8, 14, (B, N, H, W)).astype(np.float32)
    k = np.array([[20.0, 0, (W - 1) / 2], [0, 20.0, (H - 1) / 2], [0, 0, 1]], np.float32)
    ks = np.broadcast_to(k, (B, N, 3, 3)).copy()
    r, tr = _poses(rng, B, N)
    masks = np.ones((B, N), np.float32)
    masks[1, 2] = 0.0  # a padded source
    return feats, depths, ks, r, tr, masks


def test_camera_matches_jax():
    rng = np.random.default_rng(1)
    depth = rng.uniform(1, 5, (B, 8, 12)).astype(np.float32)
    k = np.array([[30.0, 0.5, 6], [0, 28.0, 4], [0, 0, 1]], np.float32)
    ks = np.stack([k, k * [[1.1], [0.9], [1]]]).astype(np.float32)
    np.testing.assert_array_equal(camera.pixel_grid(8, 12).numpy(), np.asarray(jcam.pixel_grid(8, 12)))
    kinv = camera.inv3x3(t(ks))
    np.testing.assert_allclose(kinv.numpy(), np.asarray(jcam.inv3x3(jnp.asarray(ks))), atol=1e-6)
    np.testing.assert_allclose(kinv.numpy(), np.linalg.inv(ks), atol=1e-6)
    np.testing.assert_allclose(
        camera.pixel2cam(t(depth), kinv).numpy(),
        np.asarray(jcam.pixel2cam(jnp.asarray(depth), jnp.asarray(kinv.numpy()))),
        atol=1e-6, rtol=1e-6,
    )
    r, tr = _poses(rng, 2, 3)
    np.testing.assert_array_equal(
        camera.pose_matrix(t(r), t(tr)).numpy(), np.asarray(jcam.pose_matrix(jnp.asarray(r), jnp.asarray(tr)))
    )


@pytest.mark.parametrize("dataset", ["clevr-infinite", "google_earth", "kitti360"])
def test_codec_matches_jax(dataset):
    rng = np.random.default_rng(2)
    c, jc = get_codec(dataset), j_get_codec(dataset)
    lo, hi = c.depth_range
    depth = rng.uniform(lo, hi, (2, 16, 16)).astype(np.float32)
    mask = rng.random((2, 16, 16)) < 0.3
    disp = rng.uniform(-1, 1, (2, 16, 16)).astype(np.float32)
    np.testing.assert_allclose(c.encode(t(depth)).numpy(), np.asarray(jc.encode(jnp.asarray(depth))), atol=1e-6)
    np.testing.assert_allclose(
        c.encode_masked(t(depth), t(mask)).numpy(),
        np.asarray(jc.encode_masked(jnp.asarray(depth), jnp.asarray(mask))), atol=1e-6,
    )
    np.testing.assert_allclose(c.decode(t(disp)).numpy(), np.asarray(jc.decode(jnp.asarray(disp))), atol=1e-6, rtol=1e-6)


def test_median_blur_bit_exact_vs_golden():
    g = np.load(os.path.join(GOLDENS, "median.npz"))
    got = median_blur_3x3(t(g["x"])).numpy()
    np.testing.assert_array_equal(got, g["median"].transpose(0, 2, 3, 1))


def _agree(a, b):
    """Fraction of pixels whose values are identical across all channels."""
    return float(np.mean(np.all(a == b, axis=-1)))


@pytest.mark.parametrize("seed", [0, 1])
def test_nearest_splat_matches_jax(seed):
    """Depth and features identical to JAX. Up to 0.1% of pixels may differ:
    the projection's multiply-adds may round differently in the two
    frameworks, which moves a point whose u + 0.5 sits within an ulp of a
    pixel boundary, or a key whose quantised z sits on a level boundary."""
    feats, depths, ks, r, tr, masks = _splat_inputs(seed)
    t2s = np.broadcast_to(np.eye(4, dtype=np.float32), (B, N, 4, 4)).copy()
    t2s[..., :3, :3], t2s[..., :3, 3] = r, tr
    ours = render_projection_from_srcs(t(feats), t(depths), t(ks[:, 0]), t(ks), t(t2s), src_masks=t(masks))
    ref = j_render(
        jnp.asarray(feats), jnp.asarray(depths), jnp.asarray(ks[:, 0]), jnp.asarray(ks),
        jnp.asarray(t2s), src_masks=jnp.asarray(masks), pallas=False,
    )
    for name in ("depth", "features", "raw_depth", "raw_features", "extrapolation_mask"):
        assert _agree(getattr(ours, name).numpy(), np.asarray(getattr(ref, name))) >= 0.999, name
    assert (ours.raw_depth.numpy() > 0).mean() > 0.5  # the case really splats


def test_splat_other_modes_raise():
    """The strided splat with collision 'last' and an unknown collision mode
    raise ValueError, as in JAX; the other modes run (held to JAX in
    tests/test_torch_port_splat_modes.py)."""
    feats, depths, ks, r, tr, _ = _splat_inputs()
    t2s = torch.eye(4).expand(B, N, 4, 4)
    args = (t(feats), t(depths), t(ks[:, 0]), t(ks), t2s)
    for kw, match in ((dict(collision="last", splat_stride=2), "splat_stride"), (dict(collision="first"), "unknown")):
        with pytest.raises(ValueError, match=match):
            render_projection_from_srcs(*args, **kw)
        with pytest.raises(ValueError, match=match):
            j_render(*(jnp.asarray(a.numpy()) for a in args), pallas=False, **kw)
    for kw in (dict(collision="last"), dict(collision="nearest_exact"), dict(splat_stride=2)):
        res = render_projection_from_srcs(*args, **kw)
        assert res.depth.shape == (B, H, W, 1) and res.features.shape == (B, H, W, 3)


def test_get_x_matches_jax():
    feats, depths, ks, r, tr, masks = _splat_inputs(3)
    rng = np.random.default_rng(4)
    batch = {
        "dst_img": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
        "dst_depth": rng.uniform(8, 14, (B, H, W)).astype(np.float32),
        "src_imgs": feats, "src_depths": depths, "Ks": ks,
        "R_rels": r, "t_rels": tr, "src_masks": masks,
    }
    ours = get_x({k: t(v) for k, v in batch.items()}, "clevr-infinite")
    ref = j_get_x({k: jnp.asarray(v) for k, v in batch.items()}, "clevr-infinite")
    assert _agree(ours.x.numpy(), np.asarray(ref.x)) >= 0.999
    np.testing.assert_allclose(ours.x_dst.numpy(), np.asarray(ref.x_dst), atol=1e-6)
    assert _agree(ours.extrapolation_mask.numpy(), np.asarray(ref.extrapolation_mask)) >= 0.999
    # map re-query: the warped target view replaces the splat; depth <= 0
    # (map holes, here every 5th pixel) is extrapolated
    warped_depth = batch["dst_depth"][::-1].copy()
    warped_depth[:, ::5] = 0.0
    requery = {"dst_img": batch["dst_img"], "dst_depth": batch["dst_depth"],
               "warped_tgt_features": feats[:, 0], "warped_tgt_depth": warped_depth}
    ours = get_x({k: t(v) for k, v in requery.items()}, "clevr-infinite")
    ref = j_get_x({k: jnp.asarray(v) for k, v in requery.items()}, "clevr-infinite")
    np.testing.assert_array_equal(ours.extrapolation_mask.numpy(), np.asarray(ref.extrapolation_mask))
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), atol=1e-6)
