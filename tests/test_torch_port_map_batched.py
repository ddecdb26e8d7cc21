"""The PyTorch port's batched map re-query (`scene_expansion_batched` with
`use_rgbd_integration=True`) on the CPU, held against the JAX package's
`scene_expansion_batched` run op by op (under jax.disable_jit) on a 3x3
grid at 32^2, 2 scenes each from its own seed frame, 3 sources, the map
auto-sized under a 0.1 GB cap with a pool of 2^16 slots a scene. JAX's
pool splat takes its XLA scatter (SGAM_TPU_TSDF_POOL_PALLAS=0).

Why three tests. The TINY model's f32 frames differ from JAX's by up to
1e-5 in disparity (up to 1.6e-4 of metric depth): the JAX model forward
runs jitted, and on the CPU the JAX package decodes a batch without flash
attention, the port with its flash path's plain version. Fused into the
map, such a difference moves a voxel id now and then, and the TINY model
turns the changed render into another frame: a free-running f32 unroll of
two scenes parts from JAX's at the second step of scene 0. So:
- the whole f32 unroll with the model replaced, on both sides, by the
  identity (a frame is its own conditioning: the warped target view and
  its depth): every frame and the batched volume's whole state (grid,
  pool_ids, cell_counts, inpool, claim, stats, frame) bit-exact against
  JAX's `_batched_volume`;
- each f32 step of the TINY model from JAX's own state before it (its
  buffers and volume carried over): both scenes' frames at atol 1e-5
  (rgb and disparity), and every integrate of the unroll (the seeds' and
  each step's, of JAX's frames into JAX's volume) bit-exact in every
  field, as test_torch_port_mapping.py holds integrate;
- the free-running bf16 unroll under test_torch_port_map_requery.py's
  gates (the first generated frame within mean |d| < 0.05 and max < 0.5
  of JAX's bf16, the whole unroll by `assert_bf16_close`: bf16 and f32
  part with every frame on both sides), per scene."""
import warnings
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu.pipeline import scene_generation as j_scene_generation
from sgam_neurips22_tpu.pipeline.scene_generation import (
    InfiniteSceneGeneration as JGen,
    SceneGenConfig as JCfg,
)
from sgam_neurips22_tpu_torch.geometry.codec import get_codec
from sgam_neurips22_tpu_torch.mapping import tsdf
from sgam_neurips22_tpu_torch.mapping.tsdf import FIELDS, volume_from_numpy, volume_scenes
from sgam_neurips22_tpu_torch.models.conditioning import get_x
from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration, SceneGenConfig
from test_torch_port_bf16 import assert_bf16_close, bf16
from test_torch_port_map_requery import _jitted_forward
from torch_port_common import H, TINY, TINY_K, W, port_model, tiny_jax_params

SCENES = 2
KW = dict(dataset="clevr-infinite", output_dim=(3, 3), num_src=3, topk=1, image_resolution=(H, W),
          use_rgbd_integration=True, tsdf_mem_cap_gb=0.1, tsdf_pool_capacity=1 << 16)


class Identity(torch.nn.Module):
    """The model stand-in of the whole-unroll test: xrec = its input."""

    def forward(self, x, **kw):
        return SimpleNamespace(xrec=x[:, None])


def _j_identity(params, cfg, x, **kw):
    return SimpleNamespace(xrec=x[:, None])


def _seeds_batch():
    rng = np.random.default_rng(21)
    return [[((0, 0), rng.uniform(-1, 1, (H, W, 3)).astype(np.float32),
              rng.uniform(8.0, 14.0, (H, W)).astype(np.float32))] for _ in range(SCENES)]


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
    return tiny_jax_params()


@pytest.fixture(scope="module")
def jax_batched(params):
    """model ("identity" or "bf16", f32 for the reference's own bf16
    distance) -> (rgb [S, G, H, W, 3], disparity [S, G, H, W], JAX's batched
    volume) of JAX's batched unroll run op by op, each computed once."""
    memo = {}

    def run(model):
        if model not in memo:
            with pytest.MonkeyPatch.context() as mp, jax.disable_jit(), warnings.catch_warnings():
                mp.setenv("SGAM_TPU_TSDF_POOL_PALLAS", "0")
                mp.setattr(j_scene_generation, "forward", _j_identity if model == "identity" else _jitted_forward)
                warnings.simplefilter("ignore")
                seeds = _seeds_batch()
                gen = JGen(params, bf16(TINY) if model == "bf16" else TINY, JCfg(**KW), seeds=seeds[0],
                           intrinsics=TINY_K)
                rgb, depth = gen.scene_expansion_batched(seeds, jax.random.PRNGKey(0))
            disp = get_codec(KW["dataset"]).encode(torch.as_tensor(np.array(depth))).numpy()
            memo[model] = (np.asarray(rgb), disp, gen._batched_volume)
        return memo[model]

    return run


def _port_gen(params, model):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the auto volume's coarsened-voxel warning
        gen = InfiniteSceneGeneration(port_model(params, bf16(TINY) if model == "bf16" else TINY),
                                      SceneGenConfig(**KW), _seeds_batch()[0], intrinsics=TINY_K, device="cpu")
    if model == "identity":
        gen.model = Identity()
    return gen


def _port(params, model):
    gen = _port_gen(params, model)
    rgb, depth = gen.scene_expansion_batched(_seeds_batch())
    return rgb.numpy(), gen.codec.encode(depth).numpy(), gen


def test_batched_map_unroll_matches_jax(params, jax_batched):
    j_rgb, j_disp, j_vol = jax_batched("identity")
    rgb, disp, gen = _port(params, "identity")
    assert rgb.shape == (SCENES, 9, H, W, 3) and np.isfinite(rgb).all() and np.isfinite(disp).all()
    np.testing.assert_array_equal(rgb, j_rgb)
    np.testing.assert_array_equal(disp, j_disp)
    vol = gen.batched_volume
    assert volume_scenes(vol, gen.tsdf_cfg) == SCENES and int(vol.frame) == 9
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(vol, f).numpy(), np.asarray(getattr(j_vol, f)), err_msg=f)
    assert vol.stats[0] > 0 and all(int(c) > 0 for c in vol.cell_counts.reshape(SCENES, -1).sum(1))
    # every scene its own frames, and the generator's own state untouched
    assert not np.array_equal(rgb[0, 1:], rgb[1, 1:])
    assert gen.volume is not vol and int(gen.volume.frame) == 1 and gen.curr == 1


def test_batched_map_steps_match_jax(params):
    gen = _port_gen(params, "f32")
    plan = gen.build_plan()
    frames, integrates = [], []
    core, integrate = JGen._map_requery_core_batched, j_scene_generation.integrate

    def port_state(volume):
        return volume_from_numpy({f: np.asarray(getattr(volume, f)) for f in FIELDS}, device="cpu")

    def core_and_port(self, params_, rgb_flat, depth_flat, volume, *args):
        out = core(self, params_, rgb_flat, depth_flat, volume, *args)
        with torch.inference_mode():
            batch = gen.requery_batch(plan, len(frames), torch.as_tensor(np.array(rgb_flat)),
                                      torch.as_tensor(np.array(depth_flat)), port_state(volume))
            frames.append((gen.decode_batch(get_x(batch, KW["dataset"])), out))
        return out

    def integrate_and_port(volume, cfg, depth, rgb, k, w2c):
        out = integrate(volume, cfg, depth, rgb, k, w2c)
        vol = tsdf.integrate(port_state(volume), gen.tsdf_cfg, torch.as_tensor(np.array(depth)), None,
                             torch.as_tensor(np.array(k)), torch.as_tensor(np.array(w2c)))
        integrates.append({f: np.array_equal(getattr(vol, f).numpy(), np.asarray(getattr(out, f))) for f in FIELDS})
        return out

    with pytest.MonkeyPatch.context() as mp, jax.disable_jit(), warnings.catch_warnings():
        mp.setenv("SGAM_TPU_TSDF_POOL_PALLAS", "0")
        mp.setattr(j_scene_generation, "forward", _jitted_forward)
        mp.setattr(JGen, "_map_requery_core_batched", core_and_port)
        mp.setattr(j_scene_generation, "integrate", integrate_and_port)
        warnings.simplefilter("ignore")
        seeds = _seeds_batch()
        JGen(params, TINY, JCfg(**KW), seeds=seeds[0], intrinsics=TINY_K).scene_expansion_batched(
            seeds, jax.random.PRNGKey(0))
    codec = get_codec(KW["dataset"])
    assert len(frames) == 8 and len(integrates) == 9 + 1  # JAX's reset fuses its own seed too
    for t, ((rgb, depth), (j_rgb, j_depth)) in enumerate(frames):
        assert rgb.shape == (SCENES, H, W, 3)
        np.testing.assert_allclose(rgb.numpy(), np.asarray(j_rgb), atol=1e-5, err_msg=f"step {t}")
        j_disp = codec.encode(torch.as_tensor(np.array(j_depth))).numpy()
        np.testing.assert_allclose(codec.encode(depth).numpy(), j_disp, atol=1e-5, err_msg=f"step {t}")
        assert not torch.equal(rgb[0], rgb[1])
    assert all(all(r.values()) for r in integrates), integrates


def test_batched_map_unroll_bf16_matches_jax(params, jax_batched):
    j16, j32 = jax_batched("bf16"), jax_batched("f32")
    p16 = _port(params, "bf16")
    for i, name in enumerate(("rgb", "disparity")):
        for s in range(SCENES):
            ours, ref, f32 = p16[i][s], j16[i][s], j32[i][s]
            d = np.abs(ours[1] - ref[1])  # the first generated frame, from the same seed and map
            assert d.mean() < 0.05 and d.max() < 0.5, (name, s, d.mean(), d.max())
            assert_bf16_close(ours, ref, f32, f"{name} scene {s}")
            assert not np.array_equal(ours, f32)
