"""The PyTorch port's map-requery unroll (`SceneGenConfig(use_rgbd_integration=
True)`) on the CPU, held against the JAX package's `scene_expansion` run op
by op (under jax.disable_jit) on the TINY model at 32^2, over a 3x3 grid:
clevr-infinite, google_earth, and clevr-infinite with coherent_plane_depth,
each in f32 and in bf16, with the map auto-sized under a 0.1 GB cap and a
pool of 2^16 slots (tests/test_pipeline.py's map-requery settings). JAX's
pool splat takes its XLA scatter here (SGAM_TPU_TSDF_POOL_PALLAS=0);
tests/test_torch_port_mapping.py holds the port against its Pallas merge.

Why op by op: a jitted JAX program contracts multiply-adds into FMAs and
folds constant divisions into reciprocal multiplications, which moves the
rendered depth by an ULP, and the TINY model's codeword choice turns that
into a different frame (JAX's jitted first frame is 0.26 from its op-by-op
one). The port's arithmetic is JAX's op by op. JAX's model forward alone
runs jitted (its eager dispatch is most of the reference's time): the
port's model already matches JAX's jitted one at 1e-5
(tests/test_torch_port_pipeline.py).

Tolerances:
- f32: every frame's rgb at atol 1e-5 and its disparity (the codec's
  encoding of depth, in [-1, 1]) at atol 1e-5 (measured: at most 4.5e-6);
  the map's fusion telemetry equal, and its grid, pool and tables equal
  but for at most 1 in 1000 entries (an f32 ULP of generated depth can
  move a grid sum or a voxel id; measured: 8 and 4 grid values, no
  integer entry);
- bf16 (test_torch_port_bf16.py's gates): the first generated frame by the
  JAX package's bf16 test's gate (mean |d| < 0.05, max < 0.5); the whole
  unroll by `assert_bf16_close`: within twice JAX's bf16 unroll's
  distance from its f32 unroll, in the mean and the max (measured 0.81-1.03
  of that distance: generated frames are fused into the map, so two bf16
  roundings part more with each frame, as bf16 and f32 do); under
  coherent_plane_depth the depth is the plane's, equal in all runs."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu.geometry.warp import inverse_warp_multi_src as j_warp
from sgam_neurips22_tpu.mapping import tsdf as jtsdf
from sgam_neurips22_tpu.models.conditioning import get_x as j_get_x
from sgam_neurips22_tpu.pipeline import scene_generation as j_scene_generation
from sgam_neurips22_tpu.pipeline.scene_generation import (
    InfiniteSceneGeneration as JGen,
    SceneGenConfig as JCfg,
)
from sgam_neurips22_tpu_torch.geometry.codec import get_codec
from sgam_neurips22_tpu_torch.mapping.tsdf import FIELDS
from sgam_neurips22_tpu_torch.models.conditioning import get_x
from sgam_neurips22_tpu_torch.pipeline.scene_generation import (
    InfiniteSceneGeneration,
    SceneGenConfig,
)
from test_torch_port_bf16 import assert_bf16_close, bf16
from torch_port_common import H, TINY, TINY_K, W, port_model, tiny_jax_params

CASES = ("clevr", "google_earth", "coherent")
_J_FORWARD = jax.jit(j_scene_generation.forward,
                     static_argnames=("cfg", "use_vq", "topk", "sample_number", "topk_position0_bug"))


def _jitted_forward(params, cfg, x, **kw):
    """JAX's model forward, compiled, inside the op-by-op unroll."""
    with jax.disable_jit(False):
        return _J_FORWARD(params, cfg, x, **kw)
GE_TINY = dataclasses.replace(TINY, dataset="google_earth", depth_range=(0.099975586, 4.765625))


def _setup(case):
    """(model config, SceneGenConfig kwargs, intrinsics, seeds) of a case:
    its dataset's depth range for the seed depth (bench.py's), 3 sources."""
    ge = case == "google_earth"
    kw = dict(dataset="google_earth" if ge else "clevr-infinite", output_dim=(3, 3), num_src=3, topk=1,
              image_resolution=(H, W), use_rgbd_integration=True, tsdf_mem_cap_gb=0.1,
              tsdf_pool_capacity=1 << 16, coherent_plane_depth=case == "coherent")
    rng = np.random.default_rng(11)
    rgb = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
    depth = rng.uniform(*((0.5, 4.0) if ge else (8.0, 14.0)), (H, W)).astype(np.float32)
    return (GE_TINY if ge else TINY), kw, (None if ge else TINY_K), [((0, 0), rgb, depth)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: its CPU work is many small ops,
    and the tier-1 run's workers share the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """The TINY weights, for both datasets (their TINY configs differ in
    the depth range alone, not in any parameter's shape)."""
    p = tiny_jax_params()
    return {"clevr-infinite": p, "google_earth": p}


@pytest.fixture(scope="module")
def jax_unroll(params):
    """case, dtype -> (rgb [G, H, W, 3], disparity [G, H, W], the JAX
    generator) of JAX's unroll run op by op, each computed once."""
    memo = {}

    def run(case, dtype):
        if (case, dtype) not in memo:
            cfg, kw, k, seeds = _setup(case)
            with pytest.MonkeyPatch.context() as mp, jax.disable_jit(), warnings.catch_warnings():
                mp.setenv("SGAM_TPU_TSDF_POOL_PALLAS", "0")
                mp.setattr(j_scene_generation, "forward", _jitted_forward)
                warnings.simplefilter("ignore")
                gen = JGen(params[kw["dataset"]], bf16(cfg) if dtype == "bf16" else cfg, JCfg(**kw), seeds=seeds,
                           intrinsics=k)
                if kw["coherent_plane_depth"]:
                    gen.reset([((0, 0), seeds[0][1], gen.plane_depth_at(0))])
                rgb, depth = gen.scene_expansion(jax.random.PRNGKey(0))
            codec = get_codec(kw["dataset"])
            memo[case, dtype] = (np.asarray(rgb), codec.encode(torch.as_tensor(np.array(depth))).numpy(), gen)
        return memo[case, dtype]

    return run


def _port(params, case, dtype):
    cfg, kw, k, seeds = _setup(case)
    model = port_model(params[kw["dataset"]], bf16(cfg) if dtype == "bf16" else cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the auto volume's coarsened-voxel warning
        gen = InfiniteSceneGeneration(model, SceneGenConfig(**kw), seeds, intrinsics=k, device="cpu")
    if kw["coherent_plane_depth"]:
        gen.reset([((0, 0), seeds[0][1], gen.plane_depth_at(0))])
    rgb, depth = gen.scene_expansion()
    return rgb.numpy(), gen.codec.encode(depth).numpy(), gen


@pytest.mark.parametrize("case", CASES)
def test_map_requery_unroll_matches_jax(params, jax_unroll, case):
    j_rgb, j_disp, jgen = jax_unroll(case, "f32")
    rgb, disp, gen = _port(params, case, "f32")
    assert gen.grid.visited.all() and np.isfinite(rgb).all() and np.isfinite(disp).all()
    np.testing.assert_allclose(rgb, j_rgb, atol=1e-5)
    np.testing.assert_allclose(disp, j_disp, atol=1e-5)
    assert gen.fusion_stats() == jgen.fusion_stats()
    assert gen.fusion_stats()[1] > 0 and int(gen.volume.frame) == 9
    for f in FIELDS:
        ours, ref = getattr(gen.volume, f).numpy(), np.asarray(getattr(jgen.volume, f))
        assert ours.shape == ref.shape and np.mean(ours != ref) <= 1e-3, f
    if case == "coherent":  # every frame's depth is the plane's
        for idx in range(gen.grid.size):
            np.testing.assert_array_equal(gen.depth_buf[idx].numpy(), gen.plane_depth_at(idx))


@pytest.mark.parametrize("case", CASES)
def test_map_requery_unroll_bf16_matches_jax(params, jax_unroll, case):
    j16, j32 = jax_unroll(case, "bf16"), jax_unroll(case, "f32")
    p16 = _port(params, case, "bf16")
    for i, name in enumerate(("rgb", "disparity")):
        ours, ref, f32 = p16[i], j16[i], j32[i]
        d = np.abs(ours[1] - ref[1])  # the first generated frame, from the same seed and map
        assert d.mean() < 0.05 and d.max() < 0.5, (name, d.mean(), d.max())
        if case == "coherent" and name == "disparity":
            np.testing.assert_array_equal(ours, ref)
            np.testing.assert_array_equal(ours, f32)
            continue
        assert_bf16_close(ours, ref, f32, name)
        assert not np.array_equal(ours, f32)


def test_requery_conditioning_matches_jax(params):
    """One step's conditioning, from the port's own seed state: the target
    depth rendered from the map, the sources warped through it, and get_x's
    map-requery branch, bit-exact against the JAX functions run op by op on
    the same state."""
    _, kw, k, seeds = _setup("clevr")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gen = InfiniteSceneGeneration(port_model(params[kw["dataset"]], TINY), SceneGenConfig(**kw), seeds,
                                      intrinsics=k, device="cpu")
    plan = gen.build_plan()
    batch = gen.requery_batch(plan, 0)
    cond = get_x(batch, kw["dataset"])
    vol = jtsdf.TSDFVolume(**{f: jnp.asarray(getattr(gen.volume, f).numpy()) for f in FIELDS})
    ks = gen.ks.numpy()
    near, far = gen.near_far
    src = plan["src_idx"][0].numpy()
    with jax.disable_jit():
        depth = jtsdf.render_depth(vol, jtsdf.TSDFConfig(**dataclasses.asdict(gen.tsdf_cfg)), ks[0], plan["tgt_w2c"][0].numpy(), (H, W), near, far,
                                   pallas=False)
        warped = j_warp(gen.rgb_buf.numpy()[src][None], gen.depth_buf.numpy()[src][None], depth[None], ks[None],
                        ks[0][None], plan["t_tgt2srcs"][0].numpy()[None])
        ref = j_get_x({"dst_img": batch["dst_img"].numpy(), "dst_depth": batch["dst_depth"].numpy(),
                       "warped_tgt_features": warped, "warped_tgt_depth": depth[None]}, kw["dataset"])
    np.testing.assert_array_equal(batch["warped_tgt_depth"].numpy(), np.asarray(depth)[None])
    np.testing.assert_array_equal(cond.x.numpy(), np.asarray(ref.x))
    np.testing.assert_array_equal(cond.extrapolation_mask.numpy(), np.asarray(ref.extrapolation_mask))
    assert (batch["warped_tgt_depth"] > 0).all() and (batch["warped_tgt_features"] != 0).any(-1).float().mean() > 0.5


def test_map_requery_config(params):
    """Map re-query skips the splat's packed-key point budget (it never
    splats), the batched unroll runs it (tests/test_torch_port_map_batched.py
    holds it against JAX) with the splat renderer only, and the entry
    point's default device is the card."""
    SceneGenConfig(use_rgbd_integration=True, image_resolution=(512, 512))
    with pytest.raises(ValueError, match="2\\^19 point capacity"):
        SceneGenConfig(image_resolution=(512, 512))
    with pytest.raises(ValueError, match="claim-key capacity"):
        InfiniteSceneGeneration(port_model(params["clevr-infinite"], TINY),
                                SceneGenConfig(use_rgbd_integration=True, image_resolution=(1024, 1024),
                                               collision="nearest_exact"), [], device="cpu")
    _, kw, k, seeds = _setup("clevr")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gen = InfiniteSceneGeneration(port_model(params[kw["dataset"]], TINY), SceneGenConfig(**kw), seeds,
                                      intrinsics=k, device="cpu")
    rgb, depth = gen.scene_expansion_batched([seeds, seeds])
    assert tuple(rgb.shape) == (2, 9, H, W, 3) and tuple(depth.shape) == (2, 9, H, W)
    assert int(gen.batched_volume.frame) == 9 and torch.isfinite(rgb).all()
    raycast = InfiniteSceneGeneration(gen.model, SceneGenConfig(**kw, requery_method="raycast"), seeds,
                                      intrinsics=k, device="cpu")
    with pytest.raises(NotImplementedError, match="method='splat' only"):
        raycast.scene_expansion_batched([seeds, seeds])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            InfiniteSceneGeneration(gen.model, SceneGenConfig(**kw), seeds, intrinsics=k)
