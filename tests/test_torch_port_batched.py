"""The PyTorch port's batched splat unroll (S scenes at once) on the CPU,
held against the JAX `scene_expansion_batched` and against the port's own
batch-1 unroll; and the attention path it selects by batch size."""
import jax
import numpy as np
import pytest

from sgam_neurips22_tpu.pipeline.scene_generation import (
    InfiniteSceneGeneration as JGen,
    SceneGenConfig as JCfg,
)
from sgam_neurips22_tpu_torch.ops import attention
from sgam_neurips22_tpu_torch.pipeline.scene_generation import (
    InfiniteSceneGeneration,
    SceneGenConfig,
)
from torch_port_common import H, TINY, TINY_K, W, port_model, tiny_jax_params

GRID = (2, 2)
NUM_SRC = 2


@pytest.fixture(scope="module")
def jax_params():
    return tiny_jax_params()


def _seeds(n_scenes):
    """The seeds of tests/test_pipeline.py::test_batched_scene_expansion."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n_scenes):
        rgb = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
        depth = rng.uniform(8, 14, (H, W)).astype(np.float32)
        out.append([((0, 0), rgb, depth)])
    return out


def _port_gen(jax_params, seeds):
    cfg = SceneGenConfig(output_dim=GRID, num_src=NUM_SRC, topk=1, image_resolution=(H, W))
    return InfiniteSceneGeneration(port_model(jax_params, TINY), cfg, seeds, intrinsics=TINY_K, device="cpu")


def test_batched_matches_jax(jax_params):
    """3 scenes on a 2x2 grid: rgb at atol 1e-5 and depth at atol 1e-4,
    the tolerances of the batch-1 unroll test, plus 1e-5 of the depth for
    metric depth = 1/disparity, which amplifies the error of far pixels
    (a depth of 30 differs by 1.4e-4, 4.7e-6 of itself, on 2 of 12288)."""
    seeds_batch = _seeds(3)
    jcfg = JCfg(dataset="clevr-infinite", output_dim=GRID, num_src=NUM_SRC, topk=1, image_resolution=(H, W))
    jgen = JGen(jax_params, TINY, jcfg, seeds=seeds_batch[0], intrinsics=TINY_K)
    j_rgb, j_depth = jgen.scene_expansion_batched(seeds_batch, jax.random.PRNGKey(0))
    rgb, depth = _port_gen(jax_params, seeds_batch[0]).scene_expansion_batched(seeds_batch)
    assert tuple(rgb.shape) == (3, 4, H, W, 3) and tuple(depth.shape) == (3, 4, H, W)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(j_rgb), atol=1e-5, rtol=0)
    np.testing.assert_allclose(depth.numpy(), np.asarray(j_depth), atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(rgb[0, 0].numpy(), seeds_batch[0][0][1])
    assert not np.allclose(rgb[0, 1].numpy(), rgb[1, 1].numpy())


def test_batched_scene_matches_batch1_unroll(jax_params):
    """Scene s of the batched unroll (flash path, batch 3) is the batch-1
    unroll (plain attention) of scene s's seed, at the tolerances of
    test_batched_matches_jax."""
    seeds_batch = _seeds(3)
    rgb, depth = _port_gen(jax_params, seeds_batch[0]).scene_expansion_batched(seeds_batch)
    for s, seeds in enumerate(seeds_batch):
        one_rgb, one_depth = _port_gen(jax_params, seeds).scene_expansion()
        np.testing.assert_allclose(rgb[s].numpy(), one_rgb.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(depth[s].numpy(), one_depth.numpy(), atol=1e-4, rtol=1e-5)


def test_batched_rejects_mismatched_seed_coords(jax_params):
    seeds_batch = _seeds(2)
    gen = _port_gen(jax_params, seeds_batch[0])
    _, rgb, depth = seeds_batch[1][0]
    with pytest.raises(ValueError, match="same grid coords"):
        gen.scene_expansion_batched([seeds_batch[0], [((0, 1), rgb, depth)]])
    with pytest.raises(ValueError, match="no scene"):
        gen.scene_expansion_batched([])


@pytest.mark.parametrize("n_scenes,calls_per_step", [(1, 0), (2, 5)])
def test_flash_attention_runs_at_batch_two_and_up(jax_params, monkeypatch, n_scenes, calls_per_step):
    """TINY has 5 attention blocks: each goes through flash_attention once
    per step at S >= 2; S = 1 and the batch-1 unroll take the plain path."""
    calls = []
    flash = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention", lambda *a: calls.append(1) or flash(*a))
    seeds_batch = _seeds(n_scenes)
    gen = _port_gen(jax_params, seeds_batch[0])
    steps = len(gen.build_plan()["tgt"])
    gen.scene_expansion_batched(seeds_batch)
    assert len(calls) == calls_per_step * steps
    calls.clear()
    gen.scene_expansion()
    assert not calls
