"""The port's scene-generation CLI (`python -m sgam_neurips22_tpu_torch.generate`)
on the CPU (`--device cpu`), held against the JAX package's `generate.py`
run in the same process with the same flags, on a seed template in the
reference layout and a reference-layout `.ckpt` that the test writes from
one set of JAX parameters (`core/torch_convert.params_to_state_dict`, with a
loss tensor that both loaders drop).

Both CLIs run the TINY model in place of the flagship one (the test
patches each CLI's `flagship_config`) at 32^2, and under map re-query
their maps are auto-sized under a 0.05 GB cap (the test patches the cap
into each CLI's SceneGenConfig). JAX's splat runs jitted, as its CLI does;
its map re-query runs op by op with the model forward alone jitted, as in
test_torch_port_map_requery.py (a jitted map moves voxel ids by an ULP).

Tolerances: the same file names; the seed frame's files equal (the .npy
files byte for byte, the PNG's pixels); generated frames at the batch-1
unroll's tolerances (depth .npy at atol 1e-4 + 1e-5 of the depth, PNG
pixels within 1 level of 255: rgb at 1e-5 may round across a level);
merged_pcds.ply with the same vertex count, points within 1e-3 (world
units: depth at 1e-4 through the unprojection) and colours within 1
level; the map's PLY files with equal headers' element counts."""
import functools
import importlib.util
import os
import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from sgam_neurips22_tpu import serving as j_serving
from sgam_neurips22_tpu.core.torch_convert import params_to_state_dict
from sgam_neurips22_tpu.pipeline import scene_generation as j_scene_generation
from sgam_neurips22_tpu_torch import generate
from sgam_neurips22_tpu_torch.mapping.pointcloud import read_ply
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel
from sgam_neurips22_tpu_torch.serving import load_inference_params
from test_torch_port_map_requery import _jitted_forward
from test_torch_port_trajectory import write_pose_file
from torch_port_common import TINY, port_config, port_model, tiny_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: its CPU work is many small ops,
    and the tier-1 run's workers share the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_generate():
    """The repository's generate.py as a module."""
    spec = importlib.util.spec_from_file_location("jax_generate_cli", os.path.join(REPO, "generate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """(template dir, .ckpt path, pose file, the JAX params): one clevr
    template frame (ray depth) and the TINY weights in the reference layout."""
    root = tmp_path_factory.mktemp("generate_assets")
    rng = np.random.default_rng(12)
    tdir = root / "templates"
    os.makedirs(tdir)
    Image.fromarray(rng.integers(0, 256, (RES, RES, 3), dtype=np.uint8)).save(tdir / "im_00000_00_00.png")
    np.save(tdir / "dm_00000_00_00.npy", rng.uniform(8, 14, (RES, RES)).astype(np.float32))
    params = tiny_jax_params()
    flat = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    sd = {k: torch.as_tensor(np.array(v)) for k, v in flat.items()}
    sd["loss.discriminator.main.0.weight"] = torch.zeros(3)
    torch.save({"state_dict": sd, "global_step": 7}, root / "last.ckpt")
    return str(tdir), str(root / "last.ckpt"), write_pose_file(root / "cam0_to_world.txt"), params


def _flags(assets, out, *extra):
    tdir, ckpt, _, _ = assets
    return ["--dataset", "clevr-infinite", "--ckpt", ckpt, "--template_dir", tdir, "--output_dir", str(out),
            "--resolution", str(RES), "--num_src", "2", *extra]


def _run_jax(jax_generate, argv, map_requery=False):
    prev = jax.config.jax_default_matmul_precision
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_generate, "_enable_compilation_cache", lambda: None)
        mp.setattr(j_serving, "flagship_config", lambda dataset="clevr-infinite", compute_dtype="float32": TINY)
        mp.setattr(j_scene_generation, "SceneGenConfig",
                   functools.partial(j_scene_generation.SceneGenConfig, tsdf_mem_cap_gb=0.05))
        try:
            if map_requery:
                mp.setenv("SGAM_TPU_TSDF_POOL_PALLAS", "0")
                mp.setattr(j_scene_generation, "forward", _jitted_forward)
                with jax.disable_jit():
                    jax_generate.main(argv)
            else:
                jax_generate.main(argv)
        finally:
            jax.config.update("jax_default_matmul_precision", prev)


def _run_port(argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(generate, "flagship_config", lambda dataset, dtype: port_config(TINY))
        mp.setattr(generate, "SceneGenConfig", functools.partial(generate.SceneGenConfig, tsdf_mem_cap_gb=0.05))
        generate.main([*argv, "--device", "cpu"])


def _ply_counts(path):
    with open(path, "rb") as f:
        head = f.read(512).split(b"end_header")[0].decode()
    return [line for line in head.splitlines() if line.startswith("element")]


def _compare_outputs(jdir, pdir, seed_step=0):
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == names
    for name in names:
        ours, ref = os.path.join(pdir, name), os.path.join(jdir, name)
        seed = name.split("_")[1:2] == [f"{seed_step:05d}"]
        if name.endswith(".png"):
            a, b = np.asarray(Image.open(ours), np.int16), np.asarray(Image.open(ref), np.int16)
            assert np.abs(a - b).max() <= (0 if seed else 1), name
        elif name.endswith(".npy"):
            a, b = np.load(ours), np.load(ref)
            if seed or not name.startswith("dm_"):
                assert Path(ours).read_bytes() == Path(ref).read_bytes(), name
            else:
                np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-5, err_msg=name)
        elif name == "merged_pcds.ply":
            (a, ac), (b, bc) = read_ply(ours), read_ply(ref)
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=1e-3)
            assert np.abs(ac - bc).max() <= 1.0 / 255 + 1e-6
        else:
            assert _ply_counts(ours) == _ply_counts(ref), name
    return names


@pytest.mark.parametrize("case", ["grid", "spiral", "trajectory"])
def test_generate_cli_matches_jax(jax_generate, assets, tmp_path, case):
    extra = ["--rows", "2", "--cols", "2"] if case == "grid" else ["--rows", "4", "--trajectory", case]
    if case == "trajectory":
        extra += ["--pose_file", assets[2]]
    _run_jax(jax_generate, _flags(assets, tmp_path / "jax", *extra))
    _run_port(_flags(assets, tmp_path / "port", *extra))
    names = _compare_outputs(tmp_path / "jax", tmp_path / "port")
    assert sum(n.startswith("im_") for n in names) == 4 and "merged_pcds.ply" in names


def test_generate_cli_map_requery_matches_jax(jax_generate, assets, tmp_path):
    extra = ["--rows", "2", "--cols", "2", "--use_rgbd_integration"]
    _run_jax(jax_generate, _flags(assets, tmp_path / "jax", *extra), map_requery=True)
    _run_port(_flags(assets, tmp_path / "port", *extra))
    names = _compare_outputs(tmp_path / "jax", tmp_path / "port")
    assert {"merged_pcds.ply", "rgbd_integrated_mesh.ply", "rgbd_integrated_trimesh.ply"} <= set(names)


def test_generate_cli_options(assets, tmp_path):
    """--batch_seeds writes <output_dir>_seed<k>; with map re-query it
    exits as generate.py does; --config reads its YAML (a missing file
    raises; tests/test_torch_port_trainer.py runs --config on a trained
    run against generate.py)."""
    _run_port(_flags(assets, tmp_path / "batch", "--rows", "2", "--cols", "1", "--batch_seeds"))
    files = os.listdir(str(tmp_path / "batch") + "_seed0")
    assert sum(n.startswith("im_") for n in files) == 2 and "merged_pcds.ply" in files
    with pytest.raises(SystemExit, match="splat conditioning"):
        _run_port(_flags(assets, tmp_path / "x", "--batch_seeds", "--use_rgbd_integration"))
    with pytest.raises(FileNotFoundError, match="model.yaml"):
        _run_port(_flags(assets, tmp_path / "y", "--config", "model.yaml"))


def test_load_inference_params(assets, tmp_path):
    """The reference .ckpt loads into the port as the JAX weights do
    (loss tensors dropped); a tensor of another shape keeps the model's
    own; the JAX package's .pkl and a directory without a port checkpoint
    (an orbax one) raise."""
    _, ckpt, _, params = assets
    model = VQModel(port_config(TINY))
    load_inference_params(ckpt, model)
    ref = port_model(params, TINY).state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in model.state_dict().items())
    sd = torch.load(ckpt, weights_only=False)["state_dict"]
    sd["quantize.embedding.weight"] = torch.zeros(3, 3)
    del sd["decoder.conv_out.bias"]
    torch.save(sd, tmp_path / "bare.ckpt")
    fresh = VQModel(port_config(TINY))
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    load_inference_params(str(tmp_path / "bare.ckpt"), fresh)
    after = fresh.state_dict()
    for k in ("quantize.embedding.weight", "decoder.conv_out.bias"):
        assert torch.equal(after[k], before[k])
    assert torch.equal(after["encoder.conv_in.weight"], ref["encoder.conv_in.weight"])
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump({}, f)
    for path in (str(tmp_path / "params.pkl"), str(tmp_path)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            load_inference_params(path, fresh)
    with pytest.raises(FileNotFoundError):
        load_inference_params(str(tmp_path / "missing.ckpt"), fresh)
