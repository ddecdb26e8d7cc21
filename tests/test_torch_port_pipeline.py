"""The PyTorch port's host modules and its whole splat unroll, held against
the JAX package (the reference) on the CPU."""
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu.pipeline.ordering import ORDERS as J_ORDERS
from sgam_neurips22_tpu.pipeline.scene_generation import (
    InfiniteSceneGeneration as JGen,
    SceneGenConfig as JCfg,
)
from sgam_neurips22_tpu.pipeline.selection import select_sources as j_select
from sgam_neurips22_tpu.pipeline.trajectory import (
    default_intrinsics as j_intrinsics,
    prepare_grid as j_grid,
)
from sgam_neurips22_tpu_torch.geometry.codec import get_codec
from sgam_neurips22_tpu_torch.pipeline.ordering import ORDERS
from sgam_neurips22_tpu_torch.pipeline.scene_generation import (
    InfiniteSceneGeneration,
    SceneGenConfig,
)
from sgam_neurips22_tpu_torch.pipeline.selection import select_sources
from sgam_neurips22_tpu_torch.pipeline.trajectory import default_intrinsics, prepare_grid
from torch_port_common import H, TINY, TINY_K, W, make_seed, port_model, tiny_jax_params

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "unroll_3x3.npz")


@pytest.fixture(scope="module")
def jax_params():
    return tiny_jax_params()


@pytest.mark.parametrize("order", ["zigzag", "row_major", "column_major"])
@pytest.mark.parametrize("shape", [(3, 3), (4, 2), (25, 1)])
def test_orders_match_jax(order, shape):
    assert ORDERS[order](*shape) == J_ORDERS[order](*shape)


@pytest.mark.parametrize("dataset,res", [("clevr-infinite", (256, 256)), ("google_earth", (64, 96))])
def test_prepare_grid_matches_jax(dataset, res):
    np.testing.assert_array_equal(default_intrinsics(dataset, res), j_intrinsics(dataset, res))
    a, b = prepare_grid(dataset, (3, 4), 2.0), j_grid(dataset, (3, 4), 2.0)
    for f in ("R", "t", "K", "position", "visited"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(a.c2w(5), b.c2w(5))


def test_select_sources_matches_jax():
    a, b = prepare_grid("clevr-infinite", (4, 4)), j_grid("clevr-infinite", (4, 4))
    order = ORDERS["zigzag"](4, 4)
    for curr in range(1, len(order)):
        got = select_sources(a, order, curr, order[curr], 5, "clevr-infinite")
        assert got == j_select(b, order, curr, order[curr], 5, "clevr-infinite")
        a.visited[a.index(*order[curr])] = b.visited[b.index(*order[curr])] = True


def _port_unroll(jax_params, rows_cols=(3, 3)):
    cfg = SceneGenConfig(output_dim=rows_cols, num_src=3, topk=1, image_resolution=(H, W))
    rgb, depth = make_seed()
    gen = InfiniteSceneGeneration(
        port_model(jax_params, TINY), cfg, seeds=[((0, 0), rgb, depth)],
        intrinsics=TINY_K, device="cpu",
    )
    rgb_buf, depth_buf = gen.scene_expansion()
    return gen, rgb_buf.numpy(), depth_buf.numpy()


def test_port_unroll_reproduces_frozen_golden(jax_params):
    """The 3x3 splat unroll on the JAX tiny weights, carried across by the
    bridge, reproduces tests/goldens/unroll_3x3.npz at the tolerances of
    tests/test_pipeline.py (rgb 1e-5, depth 1e-4)."""
    g = np.load(GOLDEN)
    gen, rgb, depth = _port_unroll(jax_params)
    assert gen.grid.visited.all()
    np.testing.assert_allclose(rgb, g["rgb"], atol=1e-5)
    np.testing.assert_allclose(depth, g["depth"], atol=1e-4)


def test_port_unroll_matches_live_jax_unroll(jax_params):
    cfg = JCfg(dataset="clevr-infinite", output_dim=(3, 3), num_src=3, topk=1, image_resolution=(H, W))
    rgb, depth = make_seed()
    jgen = JGen(jax_params, TINY, cfg, seeds=[((0, 0), rgb, depth)], intrinsics=TINY_K)
    j_rgb, j_depth = jgen.scene_expansion(jax.random.PRNGKey(0))
    _, p_rgb, p_depth = _port_unroll(jax_params)
    np.testing.assert_allclose(p_rgb, np.asarray(j_rgb), atol=1e-5)
    np.testing.assert_allclose(p_depth, np.asarray(j_depth), atol=1e-4)


def test_google_earth_unroll_matches_jax():
    """A google_earth 3x3 unroll with the fields flagship_config gives that
    dataset (depth range, codec, 3 sources, its pose grid and intrinsics)
    at TINY widths, seeded with depths in bench.py's (0.5, 4.0): rgb at
    atol 1e-5 and depth at atol 1e-4 plus 1e-5 of the depth, the batched
    unroll test's tolerances."""
    from dataclasses import replace

    from sgam_neurips22_tpu.models import init_vqmodel
    from sgam_neurips22_tpu.serving import flagship_config as j_flagship_config

    full = j_flagship_config("google_earth")
    cfg = replace(TINY, dataset=full.dataset, depth_range=full.depth_range)
    params = init_vqmodel(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(11)
    seeds = [((0, 0), rng.uniform(-1, 1, (H, W, 3)).astype(np.float32),
              rng.uniform(0.5, 4.0, (H, W)).astype(np.float32))]
    kw = dict(dataset="google_earth", output_dim=(3, 3), topk=1, image_resolution=(H, W))
    j_rgb, j_depth = JGen(params, cfg, JCfg(**kw), seeds=seeds).scene_expansion(jax.random.PRNGKey(0))
    gen = InfiniteSceneGeneration(port_model(params, cfg), SceneGenConfig(**kw), seeds, device="cpu")
    assert gen.cfg.effective_num_src == 3 and gen.codec.depth_range == get_codec("google_earth").depth_range
    rgb, depth = gen.scene_expansion()
    np.testing.assert_allclose(rgb.numpy(), np.asarray(j_rgb), atol=1e-5)
    np.testing.assert_allclose(depth.numpy(), np.asarray(j_depth), atol=1e-4, rtol=1e-5)
    assert np.isfinite(depth.numpy()).all()


def test_plan_is_memoised_and_matches_jax(jax_params):
    cfg = SceneGenConfig(output_dim=(3, 3), num_src=3, image_resolution=(H, W))
    rgb, depth = make_seed()
    gen = InfiniteSceneGeneration(
        port_model(jax_params, TINY), cfg, seeds=[((0, 0), rgb, depth)],
        intrinsics=TINY_K, device="cpu",
    )
    plan = gen.build_plan()
    assert gen.build_plan() is plan
    jcfg = JCfg(dataset="clevr-infinite", output_dim=(3, 3), num_src=3, image_resolution=(H, W))
    jgen = JGen(jax_params, TINY, jcfg, seeds=[((0, 0), rgb, depth)], intrinsics=TINY_K)
    jplan = jgen.build_plan()
    np.testing.assert_array_equal(plan["tgt"], np.asarray(jplan["tgt"]))
    for k in ("src_idx", "src_mask", "r_rels", "t_rels"):
        np.testing.assert_array_equal(plan[k].numpy(), np.asarray(jplan[k]))


@pytest.mark.parametrize("kw,error", [
    (dict(image_resolution=(512, 512)), "2\\^19 point capacity.*nearest_exact"),  # 5 * 512^2 points
    (dict(image_resolution=(512, 512), splat_stride=2), None),  # 5 * 256^2: fits
    (dict(image_resolution=(512, 512), collision="nearest_exact"), None),  # unpacked: no capacity
    (dict(splat_stride=256), "splat_stride 256 >= image size"),
    (dict(collision="last", splat_stride=2), "splat_stride > 1 requires"),
    (dict(collision="first"), "unknown collision"),
])
def test_config_checks(kw, error):
    """SceneGenConfig validates as JAX's does: the packed z-buffer's 2^19
    capacity counts (h//s)(w//s) points a source and names nearest_exact as
    the way out, a stride as large as the image raises, and so does the
    strided splat with collision 'last'."""
    if error is None:
        assert SceneGenConfig(output_dim=(2, 2), **kw) and JCfg(output_dim=(2, 2), **kw)
    else:
        with pytest.raises(ValueError, match=error):
            SceneGenConfig(output_dim=(2, 2), **kw)
        if "collision" not in kw:  # JAX finds these two in the splat, at trace time
            with pytest.raises(ValueError):
                JCfg(output_dim=(2, 2), **kw)


def test_config_warns_below_full_phase_coverage(capsys):
    """Fewer than s^2 sources at stride s leaves phase cells to the fills:
    a warning, as JAX prints one; s^2 sources or more, none."""
    with pytest.warns(UserWarning, match="covers only 3/4 phase cells"):
        SceneGenConfig(dataset="google_earth", output_dim=(2, 2), splat_stride=2)
    JCfg(dataset="google_earth", output_dim=(2, 2), splat_stride=2)
    assert "covers only 3/4 phase cells" in capsys.readouterr().out
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        SceneGenConfig(output_dim=(2, 2), num_src=4, splat_stride=2)


def test_default_device_is_cuda(jax_params):
    """Entry points run on the card unless the caller asks for the CPU:
    without a GPU the generator raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the no-GPU refusal")
    rgb, depth = make_seed()
    cfg = SceneGenConfig(output_dim=(2, 2), num_src=2, image_resolution=(H, W))
    with pytest.raises(RuntimeError, match="cuda"):
        InfiniteSceneGeneration(port_model(jax_params, TINY), cfg, [((0, 0), rgb, depth)], intrinsics=TINY_K)
