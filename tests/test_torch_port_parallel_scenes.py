"""The port's scene-sharded batched unroll (`scene_expansion_batched(...,
mesh=)`) and its multi-rank train CLI on the CPU, in spawned gloo ranks
that never import JAX (tests/torch_port_parallel_worker.py), beside
tests/test_torch_port_parallel.py (the train step's ranks; two files, so
that the tier-1 run's workers share the load):

- splat, 4 scenes over 2 ranks (2 a rank), the TINY model in f32: against
  JAX's run sharded over a 2-device mesh at the gates of
  tests/test_torch_port_batched.py (rgb atol 1e-5, depth atol 1e-4 + rtol
  1e-5) and against the port's unsharded run within 1e-6, the bound of
  JAX's own sharded test (tests/test_pipeline.py);
- splat, 2 scenes over 2 ranks (one a rank): each rank runs the flash
  path in every attention block, as the whole batch of 2 does; its frames
  match JAX's mesh run and the port's unsharded run at the same gates, and
  are bit-equal to each scene unrolled alone with flash on (a rank's own
  computation). The unsharded run's bound of 1e-6 does not hold here: the
  CPU's convolutions round differently at batch 1 and 2 (1.5e-6 in one
  3x3 conv, 5e-6 in the TINY model's output, with either attention path);
- the same at topk 4 from one generator seed: every scene's draws are the
  unsharded run's, so the frames agree within 1e-6;
- map re-query, 2 scenes over 2 ranks (4 with the TINY model, 2 a rank): with the identity model on a 2 x 1 grid (JAX's
  op-by-op map takes 24 s on 2 x 2; as
  tests/test_torch_port_map_batched.py, JAX run op by op) every frame and
  each rank's volume (its scene's slice of the grid and cell counts)
  bit-exact against JAX's mesh-sharded run and the port's unsharded run,
  and the stats summed over the ranks equal to the batch-global stats of
  both; with the TINY model in f32, the port's sharded frames within 1e-6
  of its unsharded ones;
- 3 scenes over 2 ranks raise JAX's message;
- the train CLI with --n_devices 2: one run directory written by rank 0
  alone, and a resume on both ranks; the emergency checkpoint of two
  ranks, rank 0's, and a resume from it.
"""
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

import torch_port_parallel_worker as worker
from sgam_neurips22_tpu.parallel.mesh import make_mesh as j_make_mesh
from sgam_neurips22_tpu.pipeline import scene_generation as j_scene_generation
from sgam_neurips22_tpu.pipeline.scene_generation import InfiniteSceneGeneration as JGen
from sgam_neurips22_tpu.pipeline.scene_generation import SceneGenConfig as JCfg
from sgam_neurips22_tpu_torch import train as t_train_cli
from sgam_neurips22_tpu_torch.core import checkpoint as t_checkpoint
from sgam_neurips22_tpu_torch.core.config import save_yaml
from sgam_neurips22_tpu_torch.core.config import wrap as t_wrap
from sgam_neurips22_tpu_torch.mapping.tsdf import volume_scenes
from sgam_neurips22_tpu_torch.parallel import distributed
from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration, SceneGenConfig
from test_torch_port_map_batched import _j_identity
from test_trainer import make_cfg
from torch_port_common import H, TINY, TINY_K, W, port_config, port_model, tiny_jax_params

RANKS = 2
SPLAT = dict(dataset="clevr-infinite", output_dim=(2, 2), num_src=2, topk=1, image_resolution=(H, W))
MAP = dict(SPLAT, num_src=3, use_rgbd_integration=True, tsdf_mem_cap_gb=0.02, tsdf_pool_capacity=1 << 14)
VOLUME_FIELDS = ("grid", "cell_counts")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeds(n, seed):
    rng = np.random.default_rng(seed)
    return [[((0, 0), rng.uniform(-1, 1, (H, W, 3)).astype(np.float32),
              rng.uniform(8, 14, (H, W)).astype(np.float32))] for _ in range(n)]


CASES = {  # name -> (SceneGenConfig kwargs, scenes, identity model, generator seed)
    "splat": (SPLAT, _seeds(4, 9), False, None),
    "splat_one_a_rank": (SPLAT, _seeds(2, 9), False, None),
    "splat_topk": (dict(SPLAT, topk=4), _seeds(4, 9), False, 5),
    "map_identity": (dict(MAP, output_dim=(2, 1)), _seeds(2, 21), True, None),
    "map": (MAP, _seeds(4, 21), False, None),
    "indivisible": (SPLAT, _seeds(3, 9), False, None),
}


def _port_unsharded(params, kw, seeds, identity, seed):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the auto volume's coarsened-voxel warning
        gen = InfiniteSceneGeneration(port_model(params, TINY), SceneGenConfig(**kw), seeds[0], intrinsics=TINY_K,
                                      device="cpu")
    if identity:
        gen.model = worker.Identity()
    rgb, depth = gen.scene_expansion_batched(seeds, None if seed is None else torch.Generator().manual_seed(seed))
    return rgb, depth, gen


def _jax_sharded(params, kw, seeds, identity):
    """JAX's run with the scene axis over a 2-device mesh; the map op by op."""
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if identity:
            mp.setenv("SGAM_TPU_TSDF_POOL_PALLAS", "0")
            mp.setattr(j_scene_generation, "forward", _j_identity)
        gen = JGen(params, TINY, JCfg(**kw), seeds=seeds[0], intrinsics=TINY_K)
        with jax.disable_jit(identity):
            rgb, depth = gen.scene_expansion_batched(seeds, jax.random.PRNGKey(0), mesh=j_make_mesh(RANKS))
    return np.asarray(rgb), np.asarray(depth), getattr(gen, "_batched_volume", None)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """rank -> case -> (rgb, depth, stats, volume fields) of the ranks' runs."""
    root = tmp_path_factory.mktemp("scenes")
    params = tiny_jax_params()
    spec = {name: {"model_cfg": port_config(TINY), "weights": port_model(params, TINY).state_dict(),
                   "cfg": SceneGenConfig(**kw), "seeds": seeds, "K": TINY_K, "identity": identity, "seed": seed,
                   "fields": VOLUME_FIELDS}
            for name, (kw, seeds, identity, seed) in CASES.items()}
    torch.save(spec, root / "spec.pt")
    distributed.launch(worker.scenes, RANKS, args=(str(root / "spec.pt"), str(root)), device="cpu", torch_threads=1)
    return params, [torch.load(root / f"scenes_rank{r}.pt", weights_only=False) for r in range(RANKS)]


def _same_on_every_rank(ranks, name):
    out = ranks[0][name]
    for r in range(1, RANKS):
        assert torch.equal(ranks[r][name]["rgb"], out["rgb"]) and torch.equal(ranks[r][name]["depth"], out["depth"])
    return out


def test_splat_sharded_matches_jax_mesh_and_unsharded(sharded):
    params, ranks = sharded
    kw, seeds, _, _ = CASES["splat"]
    out = _same_on_every_rank(ranks, "splat")
    assert tuple(out["rgb"].shape) == (4, 4, H, W, 3) and tuple(out["depth"].shape) == (4, 4, H, W)
    j_rgb, j_depth, _ = _jax_sharded(params, kw, seeds, False)
    np.testing.assert_allclose(out["rgb"].numpy(), j_rgb, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out["depth"].numpy(), j_depth, atol=1e-4, rtol=1e-5)
    rgb, depth, _ = _port_unsharded(params, kw, seeds, False, None)
    np.testing.assert_allclose(out["rgb"].numpy(), rgb.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(out["depth"].numpy(), depth.numpy(), atol=1e-6, rtol=1e-6)
    assert not torch.equal(out["rgb"][0, 1], out["rgb"][2, 1])


def test_one_scene_a_rank_takes_flash_and_matches_jax_mesh(sharded):
    params, ranks = sharded
    kw, seeds, _, _ = CASES["splat_one_a_rank"]
    out = _same_on_every_rank(ranks, "splat_one_a_rank")
    assert tuple(out["rgb"].shape) == (2, 4, H, W, 3)
    rgb, depth, gen = _port_unsharded(params, kw, seeds, False, None)
    for r in range(RANKS):  # TINY's 5 attention blocks, each step, at batch 1 in each rank
        assert ranks[r]["splat_one_a_rank"]["flash_calls"] == 5 * len(gen.build_plan()["tgt"])
    j_rgb, j_depth, _ = _jax_sharded(params, kw, seeds, False)
    for ref_rgb, ref_depth in ((j_rgb, j_depth), (rgb.numpy(), depth.numpy())):
        np.testing.assert_allclose(out["rgb"].numpy(), ref_rgb, atol=1e-5, rtol=0)
        np.testing.assert_allclose(out["depth"].numpy(), ref_depth, atol=1e-4, rtol=1e-5)
    with torch.inference_mode():
        for s, seed in enumerate(seeds):
            alone = gen._expand_batched([seed], None, flash=True)
            assert torch.equal(out["rgb"][s], alone[0][0]) and torch.equal(out["depth"][s], alone[1][0])
    assert not torch.equal(out["rgb"][0, 1], out["rgb"][1, 1])


def test_topk_sharded_draws_the_unsharded_noise(sharded):
    params, ranks = sharded
    kw, seeds, _, seed = CASES["splat_topk"]
    out = _same_on_every_rank(ranks, "splat_topk")
    rgb, depth, _ = _port_unsharded(params, kw, seeds, False, seed)
    np.testing.assert_allclose(out["rgb"].numpy(), rgb.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(out["depth"].numpy(), depth.numpy(), atol=1e-6, rtol=1e-6)
    plain, _, _ = _port_unsharded(params, CASES["splat"][0], seeds, False, None)
    assert not torch.equal(rgb, plain)  # the draws moved the frames


def test_map_sharded_bit_exact_with_identity_model(sharded):
    params, ranks = sharded
    kw, seeds, _, _ = CASES["map_identity"]
    out = _same_on_every_rank(ranks, "map_identity")
    j_rgb, j_depth, j_vol = _jax_sharded(params, kw, seeds, True)
    rgb, depth, gen = _port_unsharded(params, kw, seeds, True, None)
    vol = gen.batched_volume
    for ref_rgb, ref_depth in ((j_rgb, j_depth), (rgb.numpy(), depth.numpy())):
        np.testing.assert_array_equal(out["rgb"].numpy(), ref_rgb)
        np.testing.assert_array_equal(out["depth"].numpy(), ref_depth)
    assert volume_scenes(vol, gen.tsdf_cfg) == 2
    for ref_stats in (np.asarray(j_vol.stats), vol.stats.numpy()):
        for r in range(RANKS):
            np.testing.assert_array_equal(ranks[r]["map_identity"]["stats"].numpy(), ref_stats)
    for f in VOLUME_FIELDS:
        whole = np.asarray(getattr(j_vol, f))
        assert np.array_equal(whole, getattr(vol, f).numpy()), f
        per = whole.shape[0] // RANKS
        for r in range(RANKS):
            np.testing.assert_array_equal(ranks[r]["map_identity"]["volume"][f].numpy(), whole[r * per:(r + 1) * per],
                                          err_msg=f)


def test_map_sharded_matches_unsharded(sharded):
    params, ranks = sharded
    kw, seeds, _, _ = CASES["map"]
    out = _same_on_every_rank(ranks, "map")
    rgb, depth, gen = _port_unsharded(params, kw, seeds, False, None)
    np.testing.assert_allclose(out["rgb"].numpy(), rgb.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(out["depth"].numpy(), depth.numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(out["stats"].numpy(), gen.batched_volume.stats.numpy())


def test_indivisible_scene_count_raises(sharded):
    _, ranks = sharded
    for r in range(RANKS):
        assert ranks[r]["indivisible"] == {"error": "3 scenes do not shard over 2 devices"}


def _dataset(root, n=8):
    """tests/test_torch_port_trainer.py's codebook dataset: n 32^2 frames."""
    from PIL import Image

    rng = np.random.default_rng(0)
    scene = root / "train" / "scene"
    os.makedirs(scene)
    np.save(root / "K.npy", np.array([[20.0, 0, 15.5], [0, 20.0, 15.5], [0, 0, 1]]))
    paths = []
    for i in range(n):
        Image.fromarray(rng.uniform(0, 255, (H, W, 3)).astype(np.uint8)).save(scene / f"im_{i:05d}.png")
        np.save(scene / f"dm_{i:05d}.npy", rng.uniform(8, 14, (H, W)).astype(np.float32))
        paths.append(str(scene / f"im_{i:05d}.png"))
    (root / "train.txt").write_text("\n".join(paths))
    (root / "val.txt").write_text("\n".join(paths[:4]))
    return str(root)


def test_train_cli_two_ranks(tmp_path):
    """`train --n_devices 2 --device cpu` (the analogue of
    tests/test_multihost.py's two-process train.py): one run directory,
    written by rank 0 alone (one metrics line a logged step, the validation
    and test lines once each, checkpoints at the first and last steps);
    `-r` resumes it on both ranks for one more step."""
    base = str(tmp_path / "base.yaml")
    save_yaml(t_wrap(make_cfg(_dataset(tmp_path)).to_plain()), base)
    logs = tmp_path / "logs"
    common = ["--device", "cpu", "--n_devices", "2", "--max_steps", "1", "--no_wandb"]
    assert t_train_cli.main(["--base", base, "-l", str(logs), "-n", "dp", *common]) is None
    runs = os.listdir(logs)
    assert len(runs) == 1 and runs[0].endswith("_dp"), runs
    run = str(logs / runs[0])
    assert t_checkpoint.complete_steps(os.path.join(run, "checkpoints")) == [1, 2]
    lines = [json.loads(x) for x in open(os.path.join(run, "metrics.jsonl"))]
    train_lines = [x for x in lines if "aeloss" in x]
    assert [x["step"] for x in train_lines] == [0] and all(np.isfinite(v) for v in train_lines[0].values())
    assert sum("val/rec_loss" in x for x in lines) == 2  # validate and test, once each
    assert not [n for n in os.listdir(run) if n.endswith(".tmp")]
    assert t_train_cli.main(["-r", run, *common]) is None
    assert os.listdir(logs) == runs
    assert t_checkpoint.complete_steps(os.path.join(run, "checkpoints")) == [1, 2, 3]
    ck = torch.load(t_checkpoint.checkpoint_file(run), weights_only=False)
    assert ck["global_step"] == 3 and ck["kmeans"]["ptr"] == 3


def test_emergency_checkpoint_of_two_ranks(tmp_path):
    """Two ranks' Trainers: after two fit steps, the emergency save of a later
    step is rank 0's `emergency_state.ckpt` beside the checkpoints (which it
    leaves as they are), and a fresh Trainer resumes from it on both ranks,
    which agree on the state."""
    logdir = tmp_path / "run"
    spec = {"cfg": make_cfg(_dataset(tmp_path)).to_plain(), "logdir": str(logdir), "step": 7}
    torch.save(spec, tmp_path / "spec.pt")
    distributed.launch(worker.emergency, RANKS, args=(str(tmp_path / "spec.pt"),), device="cpu", torch_threads=1)
    outs = [torch.load(logdir / f"emergency_rank{r}.pt", weights_only=False) for r in range(RANKS)]
    assert (logdir / "emergency_state.ckpt").is_file()
    assert t_checkpoint.complete_steps(str(logdir / "checkpoints")) == [1, 2]
    for o in outs:
        assert o["resumed"] == 7 and o["checkpoints"] == [1, 2]
        assert torch.equal(o["codebook"], outs[0]["codebook"])
