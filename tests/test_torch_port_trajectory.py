"""The PyTorch port's trajectories on the CPU, held against the JAX package:
the spiral, the ring ("cylinder") and the pose file (`load_poses`,
`prepare_trajectory`, on a KITTI-360-style cam0_to_world.txt that the test
writes), the pose-file rule of `select_sources`, `_build_grid` for every
`trajectory_shape`, 4-frame spiral and pose-file unrolls on the TINY model
against JAX's, and the streamed unroll (`scene_expansion(fused=False)`)
against the port's whole-plan unroll.

Tolerances: poses, grids and source lists equal; the unrolls at the
batch-1 splat unroll's tolerances (tests/test_torch_port_pipeline.py: rgb
at atol 1e-5, depth at atol 1e-4, against JAX's jitted unroll); the
streamed unroll bit-exact against the whole-plan one (the same step
function on the same inputs, the plan uploaded a step at a time)."""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu.pipeline import trajectory as jtraj
from sgam_neurips22_tpu.pipeline.ordering import ORDERS as J_ORDERS
from sgam_neurips22_tpu.pipeline.scene_generation import (
    InfiniteSceneGeneration as JGen,
    SceneGenConfig as JCfg,
    _build_grid as j_build_grid,
)
from sgam_neurips22_tpu.pipeline.selection import select_sources as j_select
from sgam_neurips22_tpu_torch.pipeline import trajectory
from sgam_neurips22_tpu_torch.pipeline.ordering import ORDERS
from sgam_neurips22_tpu_torch.pipeline.scene_generation import (
    InfiniteSceneGeneration,
    SceneGenConfig,
    _build_grid,
)
from sgam_neurips22_tpu_torch.pipeline.selection import select_sources
from torch_port_common import H, TINY, TINY_K, W, make_seed, port_model, tiny_jax_params

FIELDS = ("rows", "cols", "R", "t", "K", "position", "visited", "trajectory_shape")


def write_pose_file(path, n=8, first=3) -> str:
    """A cam0_to_world.txt of n camera -> world poses (OpenCV) along the
    clevr-infinite grid's first row, with gaps in the frame indices and
    the lines out of order."""
    grid = trajectory.prepare_grid("clevr-infinite", (1, n), 2.0)
    idx = first + np.cumsum(np.arange(n) % 3 + 1)
    rows = [np.concatenate([[i], grid.c2w(k).reshape(-1)]) for k, i in enumerate(idx)]
    np.savetxt(path, np.stack(rows[::-1]), fmt="%.9f")
    return str(path)


def assert_grids_equal(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.fixture(scope="module")
def jax_params():
    return tiny_jax_params()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: its CPU work is many small ops,
    and the tier-1 run's workers share the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dataset", ["clevr-infinite", "google_earth"])
def test_spiral_and_ring_match_jax(dataset):
    k = trajectory.default_intrinsics(dataset, (64, 64))
    assert_grids_equal(trajectory.prepare_spiral(dataset, 9, 2.0, k), jtraj.prepare_spiral(dataset, 9, 2.0, k))
    assert_grids_equal(trajectory.prepare_spiral(dataset, 5), jtraj.prepare_spiral(dataset, 5))
    assert_grids_equal(trajectory.prepare_ring(dataset, 7, 3.0, intrinsics=k),
                       jtraj.prepare_ring(dataset, 7, 3.0, intrinsics=k))
    assert_grids_equal(trajectory.prepare_ring(dataset, 4, horizontal_offset=0.01),
                       jtraj.prepare_ring(dataset, 4, horizontal_offset=0.01))


def test_pose_file_matches_jax(tmp_path):
    path = write_pose_file(tmp_path / "cam0_to_world.txt")
    got, ref = trajectory.load_poses(path), jtraj.load_poses(path)
    assert sorted(got) == sorted(ref) and len(got) == 8
    for i in got:
        np.testing.assert_array_equal(got[i], ref[i])
    keys = sorted(got)
    for kw in (dict(n_frames=8), dict(n_frames=4, start_frame=keys[2]), dict(n_frames=3, intrinsics=TINY_K)):
        assert_grids_equal(trajectory.prepare_trajectory("clevr-infinite", path, **kw),
                           jtraj.prepare_trajectory("clevr-infinite", path, **kw))
    for fn in (trajectory.prepare_trajectory, jtraj.prepare_trajectory):
        with pytest.raises(ValueError, match="shorter"):
            fn("clevr-infinite", path, 6, start_frame=keys[3])


def test_select_sources_pose_file_matches_jax(tmp_path):
    path = write_pose_file(tmp_path / "cam0_to_world.txt")
    a = trajectory.prepare_trajectory("clevr-infinite", path, 8)
    b = jtraj.prepare_trajectory("clevr-infinite", path, 8)
    order = ORDERS["zigzag"](8, 1)
    assert order == J_ORDERS["zigzag"](8, 1)
    for curr in range(1, 8):
        got = select_sources(a, order, curr, order[curr], 3, "clevr-infinite")
        assert got == j_select(b, order, curr, order[curr], 3, "clevr-infinite")
        assert got == [(curr - 1 - i, 0) for i in range(3)]  # the previous rows, negative near the start


@pytest.mark.parametrize("shape", ["grid", "spiral", "cylinder", "trajectory"])
def test_build_grid_matches_jax(tmp_path, shape):
    path = write_pose_file(tmp_path / "cam0_to_world.txt")
    for dataset in ("clevr-infinite", "google_earth"):
        kw = dict(dataset=dataset, output_dim=(5, 2), trajectory_shape=shape, pose_file=path,
                  image_resolution=(48, 64))
        got = _build_grid(SceneGenConfig(**kw))
        assert_grids_equal(got, j_build_grid(JCfg(**kw)))
        assert_grids_equal(_build_grid(SceneGenConfig(**kw), TINY_K), j_build_grid(JCfg(**kw), TINY_K))
        assert (got.rows, got.cols) == ((5, 2) if shape == "grid" else (5, 1))
    with pytest.raises(NotImplementedError):
        _build_grid(dataclasses.replace(SceneGenConfig(), trajectory_shape="helix"))


def _cfg_kw(shape, path=None, frames=5):
    return dict(dataset="clevr-infinite", output_dim=(frames, 1), num_src=3, topk=1, image_resolution=(H, W),
                trajectory_shape=shape, pose_file=path)


@pytest.mark.parametrize("shape", ["spiral", "trajectory"])
def test_trajectory_unroll_matches_jax(jax_params, tmp_path, shape):
    """4 generated frames of the spiral and of the pose file (whose first
    steps read the zero frames at the trajectory's end as sources, as the
    reference does)."""
    path = write_pose_file(tmp_path / "cam0_to_world.txt") if shape == "trajectory" else None
    rgb, depth = make_seed()
    seeds = [((0, 0), rgb, depth)]
    jgen = JGen(jax_params, TINY, JCfg(**_cfg_kw(shape, path)), seeds=seeds, intrinsics=TINY_K)
    j_rgb, j_depth = jgen.scene_expansion(jax.random.PRNGKey(0))
    gen = InfiniteSceneGeneration(port_model(jax_params, TINY), SceneGenConfig(**_cfg_kw(shape, path)), seeds,
                                  intrinsics=TINY_K, device="cpu")
    p_rgb, p_depth = gen.scene_expansion()
    assert gen.grid.trajectory_shape == shape and p_rgb.shape == (5, H, W, 3) and gen.grid.visited.all()
    np.testing.assert_allclose(p_rgb.numpy(), np.asarray(j_rgb), atol=1e-5)
    np.testing.assert_allclose(p_depth.numpy(), np.asarray(j_depth), atol=1e-4)
    assert not np.allclose(p_rgb[1].numpy(), p_rgb[4].numpy())


@pytest.mark.parametrize("case", ["grid", "trajectory", "map", "topk"])
def test_streamed_unroll_equals_whole_plan(jax_params, tmp_path, case):
    """fused=False (a plan a step, planned when the step comes) gives the
    whole-plan unroll's frames and map, in the splat and map-requery modes
    and at topk 2 from one generator seed; the streamed unroll writes each
    frame as it is made when given an output_dir."""
    path = write_pose_file(tmp_path / "cam0_to_world.txt")
    kw = dict(dataset="clevr-infinite", output_dim=(2, 2), num_src=2, topk=2 if case == "topk" else 1,
              image_resolution=(H, W), use_rgbd_integration=case == "map", tsdf_mem_cap_gb=0.05,
              tsdf_pool_capacity=1 << 16)
    if case == "trajectory":
        kw.update(_cfg_kw("trajectory", path, frames=4))
    rgb, depth = make_seed()
    runs = []
    for fused in (True, False):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            gen = InfiniteSceneGeneration(port_model(jax_params, TINY), SceneGenConfig(**kw), [((0, 0), rgb, depth)],
                                          intrinsics=TINY_K, device="cpu",
                                          output_dir=None if fused else str(tmp_path / "out"))
            out = gen.scene_expansion(torch.Generator().manual_seed(11) if case == "topk" else None, fused=fused)
        runs.append((gen, [x.clone() for x in out]))
    (whole, (w_rgb, w_depth)), (streamed, (s_rgb, s_depth)) = runs
    assert torch.equal(s_rgb, w_rgb) and torch.equal(s_depth, w_depth)
    assert streamed.curr == whole.curr == 4 and streamed.grid.visited.all()
    if case == "map":
        for f in ("grid", "pool_ids", "cell_counts", "inpool", "claim", "stats", "frame"):
            assert torch.equal(getattr(streamed.volume, f), getattr(whole.volume, f)), f
    files = sorted((tmp_path / "out").iterdir())
    assert sum(p.name.startswith("im_") for p in files) == 4 and any(p.name == "merged_pcds.ply" for p in files)
