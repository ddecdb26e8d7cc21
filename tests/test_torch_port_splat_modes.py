"""The port's remaining splat modes on the CPU against the JAX package: the
strided splat (`splat_stride=2`, with 5 and 3 sources), the collision
rules "nearest_exact" and "last" (points behind the camera among them),
`fill_from_nearest_neighbor` and the "last" write order bit-exact on the
same inputs, and 3x3 unrolls in these modes.

Whole splats are held as tests/test_torch_port_geometry.py holds the
nearest one: identical on >= 99.9% of pixels, since XLA:CPU may round the
projection's multiply-adds differently at a pixel boundary."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu.geometry.splat import _fill_from_nearest_neighbor as j_fill
from sgam_neurips22_tpu.geometry.splat import _zbuffer_scatter as j_scatter
from sgam_neurips22_tpu.geometry.splat import render_projection_from_srcs as j_render
from sgam_neurips22_tpu.pipeline.scene_generation import (
    InfiniteSceneGeneration as JGen,
    SceneGenConfig as JCfg,
)
from sgam_neurips22_tpu_torch.geometry import splat
from sgam_neurips22_tpu_torch.pipeline.scene_generation import (
    InfiniteSceneGeneration,
    SceneGenConfig,
)
from test_torch_port_geometry import _agree, _poses
from torch_port_common import H, TINY, TINY_K, W, make_seed, port_model, t, tiny_jax_params

B = 2
OUTPUTS = ("depth", "features", "raw_depth", "raw_features", "extrapolation_mask")


def _inputs(n, seed=0, behind=False):
    """B=2 scenes of n sources at 32x32, the last source of scene 1
    padded; with `behind`, source 0 moved 11 units back, so that some of
    its points lie behind the target camera."""
    rng = np.random.default_rng(seed)
    feats = rng.uniform(-1, 1, (B, n, H, W, 3)).astype(np.float32)
    depths = rng.uniform(8, 14, (B, n, H, W)).astype(np.float32)
    ks = np.broadcast_to(np.asarray(TINY_K, np.float32), (B, n, 3, 3)).copy()
    r, tr = _poses(rng, B, n)
    if behind:
        tr[:, 0, 2] = -11.0
    masks = np.ones((B, n), np.float32)
    masks[1, n - 1] = 0.0
    t2s = np.broadcast_to(np.eye(4, dtype=np.float32), (B, n, 4, 4)).copy()
    t2s[..., :3, :3], t2s[..., :3, 3] = r, tr
    return feats, depths, ks, t2s, masks


def _both(kw, n, seed=0, behind=False):
    feats, depths, ks, t2s, masks = _inputs(n, seed, behind)
    ours = splat.render_projection_from_srcs(t(feats), t(depths), t(ks[:, 0]), t(ks), t(t2s), src_masks=t(masks), **kw)
    ref = j_render(jnp.asarray(feats), jnp.asarray(depths), jnp.asarray(ks[:, 0]), jnp.asarray(ks),
                   jnp.asarray(t2s), src_masks=jnp.asarray(masks), pallas=False, **kw)
    return ours, ref


@pytest.mark.parametrize("n,kw,behind", [
    (5, dict(splat_stride=2), False),
    (3, dict(splat_stride=2), False),
    (4, dict(splat_stride=2, collision="nearest_exact"), False),
    (3, dict(collision="nearest_exact"), False),
    (3, dict(collision="last"), False),
    (3, dict(collision="last"), True),
])
def test_splat_mode_matches_jax(n, kw, behind):
    ours, ref = _both(kw, n, behind=behind)
    for name in OUTPUTS:
        assert _agree(getattr(ours, name).numpy(), np.asarray(getattr(ref, name))) >= 0.999, name
    raw = ours.raw_depth.numpy()
    assert (raw != 0).mean() > 0.3  # the case really splats
    if behind:  # "last" lets points behind the camera win, as in JAX
        assert (raw < 0).any()


def test_strided_splat_fills_before_the_median():
    """At stride 2 with 3 sources a quarter of the phase cells has no
    source: raw_* keep those holes, and the merged image closes them."""
    ours, _ = _both(dict(splat_stride=2), 3)
    raw, merged = ours.raw_depth.numpy(), ours.depth.numpy()
    assert (raw == 0).mean() > 0.3 and (merged == 0).mean() < 0.05


@pytest.mark.parametrize("seed", [0, 1])
def test_fill_from_nearest_neighbor_bit_exact(seed):
    """On the same raw images (JAX's own strided splat of 3 sources, whose
    holes the fill closes, plus negative depths and exact ties between
    neighbours), the port's fill equals JAX's bit for bit."""
    _, ref = _both(dict(splat_stride=2), 3, seed)
    depth, feats = np.array(ref.raw_depth), np.array(ref.raw_features)
    depth[0, 5, 5], depth[0, 5, 7] = -1.0, 3.0  # a negative pixel is a hole too
    depth[1, 9, 10] = depth[1, 9, 12] = 2.5  # two equal neighbours of an emptied pixel
    depth[1, 9, 11] = 0.0
    got = splat.fill_from_nearest_neighbor(t(depth), t(feats))
    want = j_fill(jnp.asarray(depth), jnp.asarray(feats))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_last_priority_bit_exact():
    """The pixel-major write order of collision "last" and its inverse, as
    JAX computes them (render_projection_from_srcs, _zbuffer_scatter)."""
    n, hw = 5, H * W
    pri, inv = splat.last_priority(n, hw)
    i = jnp.arange(n * hw, dtype=jnp.int32)
    j_pri = (i % hw) * n + i // hw
    j_inv = jnp.zeros((n * hw,), jnp.int32).at[j_pri].set(i)
    np.testing.assert_array_equal(pri.numpy(), np.asarray(j_pri))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(j_inv))


@pytest.mark.parametrize("collision", ["nearest_exact", "last"])
def test_scatter_modes_bit_exact_on_the_same_points(collision):
    """The port's merge of the same projected points (the port's own
    projection, exact ties in z added) against JAX's per-image
    _zbuffer_scatter: raw depth and features bit-identical."""
    feats, depths, ks, t2s, masks = _inputs(3, 2, behind=True)
    nearest = collision != "last"
    pix, zs, valid = splat.project_points(t(depths), t(ks[:, 0]), t(ks), t(t2s), t(masks), nearest=nearest)
    zs = zs.clone()
    zs[:, 1::7] = zs[:, ::7][:, : zs[:, 1::7].shape[1]]  # equal-z pairs for the tie rule
    n = feats.shape[1]
    has_point, idx = splat._winners(pix, zs, valid, H, W, collision, n)
    pay = torch.cat([zs.reshape(-1, 1), t(feats).reshape(-1, 3)], dim=-1)
    won = torch.where(has_point[:, None], pay[idx], 0.0).reshape(B, H, W, 4)
    i = jnp.arange(n * H * W, dtype=jnp.int32)
    pri = (i % (H * W)) * n + i // (H * W) if collision == "last" else None
    for b in range(B):
        d, f = j_scatter(jnp.asarray(pix[b, :, 0].numpy()), jnp.asarray(pix[b, :, 1].numpy()),
                         jnp.asarray(zs[b].numpy()), jnp.asarray(feats[b].reshape(-1, 3)),
                         jnp.asarray(valid[b].numpy()), H, W, collision, pri)
        np.testing.assert_array_equal(won[b, ..., :1].numpy(), np.asarray(d))
        np.testing.assert_array_equal(won[b, ..., 1:].numpy(), np.asarray(f))
    assert bool(has_point.any()) and bool((won[..., 0] < 0).any()) == (collision == "last")


@pytest.fixture(scope="module")
def jax_params():
    return tiny_jax_params()


@pytest.mark.parametrize("kw", [
    dict(splat_stride=2, num_src=4), dict(collision="nearest_exact", num_src=3), dict(collision="last", num_src=3),
])
def test_mode_unroll_matches_jax(jax_params, kw):
    """A 3x3 unroll in each mode from the same seed and weights: rgb at atol
    1e-5 and depth at atol 1e-4 plus 1e-5 of the depth, the batched unroll
    test's tolerances (metric depth = 1/disparity amplifies the error of
    far pixels: a depth of 33.6 differs by 2.0e-4, 6.0e-6 of itself, on 1
    of 9216)."""
    cfg = dict(dataset="clevr-infinite", output_dim=(3, 3), topk=1, image_resolution=(H, W), **kw)
    rgb, depth = make_seed()
    seeds = [((0, 0), rgb, depth)]
    jgen = JGen(jax_params, TINY, JCfg(**cfg), seeds=seeds, intrinsics=TINY_K)
    j_rgb, j_depth = jgen.scene_expansion(jax.random.PRNGKey(0))
    gen = InfiniteSceneGeneration(port_model(jax_params, TINY), SceneGenConfig(**cfg), seeds, intrinsics=TINY_K,
                                  device="cpu")
    p_rgb, p_depth = gen.scene_expansion()
    np.testing.assert_allclose(p_rgb.numpy(), np.asarray(j_rgb), atol=1e-5)
    np.testing.assert_allclose(p_depth.numpy(), np.asarray(j_depth), atol=1e-4, rtol=1e-5)
