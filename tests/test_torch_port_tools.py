"""The port's JAX-free weight and data tools against the JAX package's:

- `core.state_dict.load_tree_pickle`: a `jnp`-leaf LPIPS pickle written by
  tools/convert_lpips.py, a `jax.Array`-leaf `model.pkl` and a bfloat16
  leaf load in a subprocess where `jax` (and jaxlib, orbax, tensorstore and
  the JAX package) cannot be imported; their tensors equal `from_jax_params`
  of the numpy trees; without ml_dtypes the bfloat16 leaf raises a message
  that names it;
- `convert_lpips` (run in that subprocess): its tree is leaf-equal to the
  JAX tool's on synthetic VGG16 and LPIPS-head state dicts made from a
  numpy seed, and the prefix-less `features` keys map the same;
- `pack_dataset` (run in that subprocess): its shards are byte-equal to
  tools/pack_dataset.py's for the codebook phase with and without depth
  and for the pair phase's frame store, at a resolution other than the
  PNGs' (the LANCZOS branch), and `DataModule(packed="auto")` reads them
  into the PNG path's batches.
"""
import os
import pickle
import runpy
import shutil
import subprocess
import sys

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sgam_neurips22_tpu.models import init_vqmodel
from sgam_neurips22_tpu_torch.convert_lpips import lpips_from_torch
from sgam_neurips22_tpu_torch.core.state_dict import from_jax_params
from sgam_neurips22_tpu_torch.training.data import datamodule as t_dm
from sgam_neurips22_tpu_torch.training.data import packed as t_packed
from test_torch_port_data import _smooth_image, _write_scene
from torch_port_common import TINY, port_config, to_numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = (24, 28)  # the PNGs are 32^2: every frame takes the LANCZOS branch
BLOCKED = ("jax", "jaxlib", "orbax", "tensorstore", "sgam_neurips22_tpu")
PACKS = {  # case -> (dataset dir, pack_dataset flags after --dataset_dir, files written per split)
    "codebook_depth": ("codebook_depth", ["--dataset", "clevr-infinite"], ("{split}_{h}x{w}.sgpk",)),
    "codebook_no_depth": ("codebook_no_depth", ["--dataset", "clevr-infinite", "--no_depth"],
                          ("{split}_{h}x{w}.sgpk",)),
    "pair": ("pair", ["--dataset", "clevr-infinite", "--phase", "pair"],
             ("{split}_frames_{h}x{w}.sgpk", "{split}_frames_{h}x{w}.sgpk.idx.json")),
}

# run with jax and the JAX package unimportable: the port's tools and readers
PORT_SIDE = """
import sys
for name in {blocked!r}:
    sys.modules[name] = None
import torch
root = sys.argv[1]
from sgam_neurips22_tpu_torch import convert_lpips, pack_dataset
from sgam_neurips22_tpu_torch.core.state_dict import from_jax_params, load_into, load_tree_pickle
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel
from sgam_neurips22_tpu_torch.serving import load_inference_params
from sgam_neurips22_tpu_torch.training.lpips import LPIPS
convert_lpips.main(["--vgg", root + "/vgg16.pth", "--lin", root + "/vgg.pth", "--out", root + "/port_lpips.pkl"])
for case, (ddir, flags, _) in {packs!r}.items():
    pack_dataset.main(["--dataset_dir", root + "/" + ddir, *flags, "--resolution", "{h}", "{w}"])
out = {{"lpips": load_into(LPIPS(), from_jax_params(load_tree_pickle(root + "/jax_lpips.pkl"))).state_dict(),
       "model": load_inference_params(root + "/model.pkl", VQModel(torch.load(root + "/cfg.pt",
                                                                               weights_only=False))).state_dict(),
       "bf16": from_jax_params(load_tree_pickle(root + "/bf16.pkl"))}}
sys.modules["ml_dtypes"] = None
try:
    load_tree_pickle(root + "/bf16.pkl")
except ImportError as e:
    out["no_ml_dtypes"] = str(e)
out["jax_imported"] = [m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m] is not None]
torch.save(out, root + "/port_side.pt")
"""


def _codebook_dir(root, seed):
    rng = np.random.default_rng(seed)
    scene = root / "train" / "scene"
    os.makedirs(scene)
    np.save(root / "K.npy", np.array([[20.0, 0, 15.5], [0, 20.0, 15.5], [0, 0, 1]]))
    paths = []
    for i in range(5):
        Image.fromarray(_smooth_image(rng)).save(scene / f"im_{i:05d}.png")
        np.save(scene / f"dm_{i:05d}.npy", rng.uniform(8, 14, (32, 32)).astype(np.float32))
        paths.append(str(scene / f"im_{i:05d}.png"))
    (root / "train.txt").write_text("\n".join(paths))
    (root / "val.txt").write_text("\n".join(paths[:3]))


def _pair_dir(root):
    rng = np.random.default_rng(3)
    os.makedirs(root)
    np.save(root / "K.npy", np.array([[20.0, 0, 15.5], [0, 20.0, 15.5], [0, 0, 1]]))
    for split in ("train", "val"):
        _write_scene(root / split / "scene_0000", 4, rng, "clevr-infinite")


def _run_jax_tool(script, argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [script, *argv])
        runpy.run_path(os.path.join(REPO, "tools", script), run_name="__main__")


@pytest.fixture(scope="module")
def tools(tmp_path_factory):
    """The JAX tools' outputs (kept under jax/) and the port side's, run
    in one subprocess with JAX unimportable."""
    root = tmp_path_factory.mktemp("tools")
    h, w = RES
    for case, (ddir, flags, files) in PACKS.items():
        (_pair_dir if case == "pair" else lambda r: _codebook_dir(r, 0))(root / ddir)
        _run_jax_tool("pack_dataset.py", ["--dataset_dir", str(root / ddir), *flags, "--resolution", str(h), str(w)])
        os.makedirs(root / "jax" / case)
        for split in ("train", "val"):
            for f in files:
                name = f.format(split=split, h=h, w=w)
                shutil.move(root / ddir / name, root / "jax" / case / name)
    _, vgg, lin = chip_smoke.lpips_torch_files(torch, np, root)  # root/vgg16.pth, root/vgg.pth
    _run_jax_tool("convert_lpips.py", ["--vgg", str(root / "vgg16.pth"), "--lin", str(root / "vgg.pth"),
                                       "--out", str(root / "jax_lpips.pkl")])
    params = init_vqmodel(jax.random.PRNGKey(4), TINY)
    with open(root / "model.pkl", "wb") as f:
        pickle.dump(params, f)  # jax.Array leaves
    bf16 = {"convs": [{"weight": jnp.asarray(np.linspace(-3, 3, 24).reshape(2, 3, 2, 2), jnp.bfloat16)}]}
    with open(root / "bf16.pkl", "wb") as f:
        pickle.dump(bf16, f)
    torch.save(port_config(TINY), root / "cfg.pt")
    code = PORT_SIDE.format(blocked=BLOCKED, packs=PACKS, h=h, w=w)
    r = subprocess.run([sys.executable, "-c", code, str(root)], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    port = torch.load(root / "port_side.pt", weights_only=False)
    return root, port, params, bf16, vgg, lin


def test_port_side_imports_no_jax(tools):
    _, port, _, _, _, _ = tools
    assert port["jax_imported"] == []


def test_pickles_with_jax_leaves_load_without_jax(tools):
    root, port, params, bf16, _, _ = tools
    with open(root / "jax_lpips.pkl", "rb") as f:
        jax_tree = pickle.load(f)
    assert isinstance(jax_tree["convs"][0]["weight"], jax.Array)  # the JAX tool's leaves are jnp arrays
    for got, tree in ((port["lpips"], jax_tree), (port["model"], params)):
        want = from_jax_params(to_numpy_tree(tree))
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], torch.from_numpy(np.array(v))), k
    widened = np.asarray(bf16["convs"][0]["weight"]).astype(np.float32).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(port["bf16"]["convs.0.weight"], widened)
    assert port["bf16"]["convs.0.weight"].dtype == np.float32
    assert "ml_dtypes" in port["no_ml_dtypes"] and "bfloat16" in port["no_ml_dtypes"]


def test_convert_lpips_matches_the_jax_tool(tools):
    root, _, _, _, vgg, lin = tools
    with open(root / "jax_lpips.pkl", "rb") as f:
        want = pickle.load(f)
    with open(root / "port_lpips.pkl", "rb") as f:
        got = pickle.load(f)
    assert list(got) == list(want) == ["convs", "lins"]
    for part in ("convs", "lins"):
        assert len(got[part]) == len(want[part])
        for g, w in zip(got[part], want[part]):
            assert list(g) == list(w)
            for k in w:
                assert isinstance(g[k], np.ndarray) and g[k].dtype == np.float32
                np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    bare = lpips_from_torch({k[len("features."):]: v for k, v in vgg.items()}, lin).state_dict()
    mapped = from_jax_params(got)
    for k, v in lpips_from_torch(vgg, lin).state_dict().items():
        assert torch.equal(bare[k], v) and torch.equal(torch.from_numpy(mapped[k]), v), k


@pytest.mark.parametrize("case", sorted(PACKS))
def test_pack_dataset_bytes_match_the_jax_tool(tools, case):
    root, _, _, _, _, _ = tools
    ddir, _, files = PACKS[case]
    h, w = RES
    for split in ("train", "val"):
        for f in files:
            name = f.format(split=split, h=h, w=w)
            assert (root / ddir / name).read_bytes() == (root / "jax" / case / name).read_bytes(), name


@pytest.mark.parametrize("case", sorted(PACKS))
def test_packed_datamodule_batches_equal_the_png_path(tools, case):
    root, _, _, _, _, _ = tools
    ddir, flags, _ = PACKS[case]
    kw = dict(batch_size=2, dataset="clevr-infinite", dataset_dir=str(root / ddir), image_resolution=list(RES))
    kw.update(phase="conditional_generation" if case == "pair" else "codebook",
              **({"use_depth": False} if "--no_depth" in flags else {}))
    png = t_dm.DataModule(packed=False, **kw)
    dm = t_dm.DataModule(packed="auto", **kw)
    if case == "pair":
        assert dm.train_ds.frame_store is not None and png.train_ds.frame_store is None
    else:
        assert isinstance(dm.train_ds, t_packed.PackedCodebookDataset)
    n = 0
    for loader in ("train_loader", "val_loader"):
        for a, b in zip(getattr(dm, loader)(), getattr(png, loader)()):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
            n += 1
    assert n >= 2
