"""The port's checkpoint-parity tool (`sgam_neurips22_tpu_torch/parity_check.py`)
against the JAX tool (`tools/parity_check.py`), on the CPU, on the TINY
config of torch_port_common at a 64^2 input, with a `.ckpt` written from
JAX params through `core/torch_convert.params_to_state_dict`:

- JAX's `compute_stages` records a golden; the port's `--compare` exits 0
  and every stage is within the JAX tool's TOLERANCES;
- the port's `--record` file passes JAX's `compare_stages`;
- the cross-check (the port's stages against its torch-functional oracle)
  exits 0, and the oracle's stages equal the JAX tool's oracle's;
- a decoder weight perturbed in a copy of the `.ckpt` makes `--compare`
  exit 1 on decoder-side stages only; two swapped codewords make indices
  fail, with the rows that differ reported;
- the port's `torch_functional` equals the JAX package's bit for bit;
- in a subprocess where `jax` and the JAX package cannot be imported, the
  port's parity_check and convert_exr import and run.

The tool's own random input is 256^2 (as JAX's), which TINY's attention at
128^2 tokens would make heavy, so the modes that draw an input have
`load_test_input` patched to the 64^2 frame.
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from sgam_neurips22_tpu.core.torch_convert import params_to_state_dict
from sgam_neurips22_tpu.models.vqgan import torch_functional as j_tfn
from sgam_neurips22_tpu_torch import parity_check as pc
from sgam_neurips22_tpu_torch.models.vqgan import torch_functional as t_tfn
from torch_port_common import TINY, port_config, tiny_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 64
DECODER_STAGES = {"decode", "frame_rgb", "frame_depth"}


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_parity_check", os.path.join(REPO, "tools", "parity_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_ckpt(path, sd):
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(root, JAX tool, JAX params, state_dict, input, JAX golden path), at
    one torch thread, as the blocked subprocess runs (another thread count
    sums CPU convolutions in another order)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("parity")
    jtool = _jax_tool()
    params = tiny_jax_params()
    sd = params_to_state_dict(params)
    _write_ckpt(root / "tiny.ckpt", sd)
    dd = TINY.ddconfig
    cfg = {"model": {"params": {
        "ddconfig": {"ch": dd.ch, "out_ch": dd.out_ch, "ch_mult": list(dd.ch_mult),
                     "num_res_blocks": dd.num_res_blocks, "attn_resolutions": list(dd.attn_resolutions),
                     "in_channels": dd.in_channels, "resolution": dd.resolution, "z_channels": dd.z_channels},
        "n_embed": TINY.n_embed, "embed_dim": TINY.embed_dim, "phase": TINY.phase}},
        "data": {"params": {"dataset": TINY.dataset, "depth_range": list(TINY.depth_range)}}}
    (root / "tiny.yaml").write_text(yaml.safe_dump(cfg))
    x = np.random.default_rng(0).uniform(-1, 1, (1, RES, RES, dd.in_channels)).astype(np.float32)
    golden = jtool.compute_stages(params, TINY, x, "clevr-infinite")
    np.savez_compressed(root / "jax_golden.npz", **golden)
    yield root, jtool, params, sd, x, root / "jax_golden.npz"
    torch.set_num_threads(threads)


def _port(root, *flags, ckpt="tiny.ckpt"):
    return pc.run([str(root / ckpt), "--config", str(root / "tiny.yaml"), "--device", "cpu", *flags])


def _failed(rows):
    return {stage for stage, _, _, ok in rows if not ok}


def test_compare_against_the_jax_golden(case):
    root, _, _, _, _, golden = case
    code, rep = _port(root, "--compare", str(golden))
    assert code == 0
    assert {r[0] for r in rep["rows"]} == set(pc.TOLERANCES)
    for stage, diff, tol, ok in rep["rows"]:
        assert ok and diff <= pc.TOLERANCES[stage], (stage, diff)


def test_config_matches_the_jax_tool(case):
    root = case[0]
    assert pc.model_config(str(root / "tiny.yaml")) == port_config(TINY)
    assert pc.TOLERANCES == case[1].TOLERANCES


def test_port_record_passes_jax_compare(case, monkeypatch):
    root, jtool, params, _, x, _ = case
    monkeypatch.setattr(pc, "load_test_input", lambda args, cfg: x)
    code, rep = _port(root, "--record", str(root / "port_golden.npz"))
    assert code == 0
    mine = dict(np.load(root / "port_golden.npz"))
    assert set(mine) == set(pc.TOLERANCES) | {"input"}
    assert mine["indices"].dtype == np.int32 and mine["encode"].shape[0] == 1  # NHWC, as JAX's
    rows = jtool.compare_stages(jtool.compute_stages(params, TINY, mine["input"]), mine)
    assert len(rows) == len(pc.TOLERANCES) and all(ok for *_, ok in rows), rows


def test_cross_check_exits_zero(case, monkeypatch, capsys):
    root, _, _, _, x, _ = case
    monkeypatch.setattr(pc, "load_test_input", lambda args, cfg: x)
    code, rep = _port(root)
    assert code == 0
    assert [r[0] for r in rep["rows"]] == ["encode", "pre_quant", "indices", "quantized", "decode"]
    assert rep["index_rows_differ"] == 0
    assert "all stages within tolerance" in capsys.readouterr().out


def test_oracle_stages_equal_the_jax_tools(case):
    root, jtool, _, _, x, _ = case
    args = type("Args", (), {"ckpt": str(root / "tiny.ckpt")})()
    want = jtool.torch_oracle_stages(args, TINY, x)
    got = pc.torch_oracle_stages(str(root / "tiny.ckpt"), port_config(TINY), x)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_torch_functional_equals_the_jax_packages(case, part):
    _, _, _, sd, x, _ = case
    sub = {k[len(part) + 1:]: v for k, v in sd.items() if k.startswith(part + ".")}
    dd = TINY.ddconfig
    if part == "encoder":
        inp = np.random.default_rng(1).uniform(-1, 1, (1, RES, RES, dd.in_channels)).astype(np.float32)
    else:
        inp = np.random.default_rng(1).standard_normal((1, RES // 2, RES // 2, dd.z_channels)).astype(np.float32)
    fn = f"torch_{part}"
    want = getattr(j_tfn, fn)(j_tfn.t(inp), sub, dd)
    got = getattr(t_tfn, fn)(t_tfn.t(inp), sub, port_config(TINY).ddconfig)
    assert torch.equal(got, want)


def test_planted_decoder_fault_fails_decoder_stages_only(case):
    root, _, _, sd, _, golden = case
    bad = dict(sd)
    bad["decoder.conv_in.weight"] = sd["decoder.conv_in.weight"] * np.float32(1.01)
    _write_ckpt(root / "planted.ckpt", bad)
    code, rep = _port(root, "--compare", str(golden), ckpt="planted.ckpt")
    assert code == 1
    assert "decode" in _failed(rep["rows"]) and _failed(rep["rows"]) <= DECODER_STAGES


def test_swapped_codewords_fail_indices(case, capsys):
    root, _, _, sd, _, golden = case
    used = int(np.load(golden)["indices"].reshape(-1)[0])
    other = (used + 1) % TINY.n_embed
    emb = sd["quantize.embedding.weight"].copy()
    emb[[used, other]] = emb[[other, used]]
    _write_ckpt(root / "swapped.ckpt", {**sd, "quantize.embedding.weight": emb})
    code, rep = _port(root, "--compare", str(golden), ckpt="swapped.ckpt")
    assert code == 1
    assert "indices" in _failed(rep["rows"])
    assert "quantized" not in _failed(rep["rows"])  # the same vectors, under other indices
    assert rep["index_rows_differ"] > 0 and rep["index_near_ties"] is False
    assert f"indices: {rep['index_rows_differ']} of" in capsys.readouterr().out


# the port's two tools with jax and the JAX package unimportable
BLOCKED_SIDE = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sgam_neurips22_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np, torch
torch.set_num_threads(1)
from sgam_neurips22_tpu_torch import convert_exr, parity_check
root = sys.argv[1]
x = np.load(root + "/x.npy")
parity_check.load_test_input = lambda args, cfg: x
base = [root + "/tiny.ckpt", "--config", root + "/tiny.yaml", "--device", "cpu"]
codes = [parity_check.main(base + ["--record", root + "/blocked.npz"]),
         parity_check.main(base + ["--compare", root + "/jax_golden.npz"]),
         parity_check.main(base)]
convert_exr.main([root + "/exr", "--out", root + "/exr_out"])
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sgam_neurips22_tpu")]
print("CODES", codes, "IMPORTED", bad)
"""


def test_tools_run_without_jax(case, monkeypatch):
    root, _, _, _, x, _ = case
    from test_torch_port_exr import smooth, write_exr

    np.save(root / "x.npy", x)
    os.makedirs(root / "exr", exist_ok=True)
    rng = np.random.default_rng(3)
    write_exr(root / "exr" / "render_0000.exr",
              {f"View Layer.Combined.{c}": smooth(rng, 12, 10, np.float16) for c in "RGB"}
              | {"View Layer.Depth.Z": smooth(rng, 12, 10, np.float32)}, "ZIP")
    r = subprocess.run([sys.executable, "-c", BLOCKED_SIDE, str(root)], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "CODES [0, 0, 0] IMPORTED []" in r.stdout
    assert sorted(os.listdir(root / "exr_out")) == ["dm_00000.npy", "im_00000.png"]
    monkeypatch.setattr(pc, "load_test_input", lambda args, cfg: x)
    assert _port(root, "--record", str(root / "in_process.npz"))[0] == 0
    blocked, here = dict(np.load(root / "blocked.npz")), dict(np.load(root / "in_process.npz"))
    assert set(blocked) == set(here) and all(np.array_equal(blocked[k], here[k]) for k in here)
