"""The port's AOT export (`sgam_neurips22_tpu_torch/export_aot.py`) on the
CPU, on tests/test_export_aot.py's TINY config (32^2 images):

- against JAX's: `tools/export_aot.export_step` writes JAX's artifact, which
  runs on JAX's parameters, batch and key; the port's artifact, loaded with
  those parameters (`load_step(path, state_dict=from_jax_params(...))`),
  runs on the same batch: RGB at atol 1e-5, depth at atol and rtol 1e-5
  (the gates of test_torch_port_serving's `build_inference_step` test), at
  topk 1 and at topk 4, where the port takes as its noise input the
  Gumbel noise JAX's forward draws from its key
  (`jax.random.gumbel(key, (P, 1, 4))`, test_torch_port_topk's recipe);
- against the eager port: the loaded program equals `build_inference_step`'s
  fn bit for bit, in f32 and bf16, at topk 1 and 4 (one noise given to both);
- its graph keeps the hand kernels as the custom ops `torch.ops.sgam.*`
  (the z-buffer, and the codeword search at topk 1), and no constant is an
  inference tensor;
- a subprocess in which `jax`, the JAX package and the port's `models`,
  `pipeline`, `serving` and `training` cannot be imported loads the
  artifact with JAX's weights and gives the same outputs;
- platforms (JAX's `--platforms`): the f32 topk-1 artifact is exported for
  cpu and cuda and loaded with device="cpu" (so the eager-step test holds
  it), its record reads back, a move to another device leaves nothing on
  the CPU, and a CPU-only artifact asked for cuda is refused, naming its
  platforms.
"""
import copy
import os
import subprocess
import sys
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from jax import export as jexport
from torch.export.passes import move_to_device_pass

from sgam_neurips22_tpu.serving import build_inference_step as j_build_inference_step
from sgam_neurips22_tpu_torch.core.state_dict import from_jax_params
from sgam_neurips22_tpu_torch.export_aot import (
    INPUTS,
    artifact_platforms,
    export_step,
    gumbel_shape,
    load_step,
)
from sgam_neurips22_tpu_torch.serving import build_inference_step
from test_export_aot import TINY
from torch_port_common import port_config, port_model, to_numpy_tree

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from export_aot import export_step as j_export_step  # noqa: E402  (tools/export_aot.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = TINY.ddconfig.resolution * 4  # the export's image size, as JAX's
BLOCKED = ("jax", "jaxlib", "sgam_neurips22_tpu", "sgam_neurips22_tpu_torch.models",
           "sgam_neurips22_tpu_torch.pipeline", "sgam_neurips22_tpu_torch.serving",
           "sgam_neurips22_tpu_torch.training")

# run where BLOCKED cannot be imported: load the artifact, call it on the saved inputs
LOAD_SIDE = """
import sys


class Blocked:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in {blocked!r}):
            raise ImportError(f"{{name}} is blocked")
        return None


sys.meta_path.insert(0, Blocked())
import torch
torch.set_num_threads(1)  # as the test's process: another thread count sums CPU convolutions in another order
from sgam_neurips22_tpu_torch.export_aot import load_step
path, root = sys.argv[1:]
step = load_step(path, state_dict=torch.load(root + "/weights.pt"))
outputs = step(*torch.load(root + "/inputs.pt"))
imported = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in {blocked!r})]
torch.save({{"outputs": outputs, "imported": imported}}, root + "/load_side.pt")
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: its CPU work is many small ops,
    and the tier-1 run's workers share the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's build_inference_step example (params, batch, key)."""
    _, (params, batch, key) = j_build_inference_step(TINY, image_size=SIZE)
    return params, batch, key


def _config(dtype: str):
    """TINY with its activations in `dtype` (JAX's config)."""
    return replace(TINY, ddconfig=replace(TINY.ddconfig, compute_dtype=dtype))


def _noise(key, topk: int):
    """The Gumbel noise [P, 1, topk] that JAX's categorical draw adds to the logits."""
    shape = gumbel_shape(port_config(TINY), topk, SIZE)
    return torch.as_tensor(np.asarray(jax.random.gumbel(key, shape)))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory, jax_side):
    """{(dtype, topk): (path, ExportedProgram, port config, inputs, outputs)}
    of the port's export: the outputs of the loaded program on JAX's
    weights, on the example batch and, at topk 4, JAX's noise."""
    params, _, key = jax_side
    root = tmp_path_factory.mktemp("export")
    sd = from_jax_params(to_numpy_tree(params))
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = port_config(_config(dtype))
        _, (_, batch, _) = build_inference_step(cfg, image_size=SIZE, device="cpu")
        for topk in (1, 4):
            path = str(root / f"step_{dtype}_{topk}.pt2")
            platforms = ["cpu", "cuda"] if (dtype, topk) == ("float32", 1) else None  # one two-platform artifact
            exported = export_step(cfg, path, device="cpu", topk=topk, platforms=platforms)
            inputs = [batch[name] for name in INPUTS] + ([_noise(key, topk)] if topk > 1 else [])
            step = load_step(path, state_dict=sd, device="cpu" if platforms else None)
            out[dtype, topk] = (path, exported, cfg, inputs, step(*inputs))
    return out


@pytest.mark.parametrize("topk", [1, 4])
def test_export_matches_jax_export(tmp_path, jax_side, artifacts, topk):
    params, batch, key = jax_side
    path = str(tmp_path / "step.jaxexport")
    j_export_step(TINY, path, platforms=["cpu"], topk=topk)
    with open(path, "rb") as f:
        j_rgb, j_depth = jexport.deserialize(f.read()).call(params, batch, key)
    _, _, _, inputs, (rgb, depth) = artifacts["float32", topk]
    for name, x in zip(INPUTS, inputs):  # the port's example batch is JAX's
        np.testing.assert_array_equal(x.numpy(), np.asarray(batch[name]), err_msg=name)
    assert rgb.shape == (1, SIZE, SIZE, 3) and depth.shape == (1, SIZE, SIZE)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(j_rgb), atol=1e-5)
    np.testing.assert_allclose(depth.numpy(), np.asarray(j_depth), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("topk", [1, 4])
def test_loaded_program_equals_eager_step(jax_side, artifacts, dtype, topk):
    _, _, cfg, inputs, got = artifacts[dtype, topk]
    fn, (_, batch, _) = build_inference_step(cfg, topk=topk, image_size=SIZE, device="cpu")
    model = port_model(jax_side[0], _config(dtype))  # JAX's weights, as the program's
    want = fn(model, batch, None, inputs[-1] if topk > 1 else None)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.isfinite(x).all() for x in got)


@pytest.mark.parametrize("topk", [1, 4])
def test_graph_keeps_the_kernel_ops(artifacts, topk):
    _, exported, _, _, _ = artifacts["float32", topk]
    targets = {n.target for n in exported.graph.nodes if n.op == "call_function"}
    assert torch.ops.sgam.zbuffer_min.default in targets
    assert (torch.ops.sgam.nearest_codeword.default in targets) == (topk == 1)  # topk 4 draws from plain distances
    assert not any(t.is_inference() for t in exported.constants.values() if isinstance(t, torch.Tensor))


def test_loads_without_the_model_code(tmp_path, jax_side, artifacts):
    path, _, _, inputs, want = artifacts["float32", 4]
    torch.save(inputs, tmp_path / "inputs.pt")
    torch.save({k: torch.as_tensor(v) for k, v in from_jax_params(to_numpy_tree(jax_side[0])).items()},
               tmp_path / "weights.pt")
    code = LOAD_SIDE.format(blocked=BLOCKED)
    r = subprocess.run([sys.executable, "-c", code, path, str(tmp_path)], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    side = torch.load(tmp_path / "load_side.pt")
    assert side["imported"] == []
    assert all(torch.equal(a, b) for a, b in zip(side["outputs"], want))


def test_platforms_are_recorded_and_a_device_outside_them_is_refused(artifacts):
    """The f32 topk-1 artifact was exported for cpu and cuda (and loaded
    with device="cpu" by the fixture: test_loaded_program_equals_eager_step
    holds it to the eager step), the others for the CPU alone, the device
    they were traced on. Moved to another device (`meta`, as this build has
    no card), no tensor or device of the program stays on the CPU. A
    CPU-only artifact asked for the card is refused by its record, before
    the program is loaded or a card is looked for."""
    assert artifact_platforms(artifacts["float32", 1][0]) == ["cpu", "cuda"]
    assert artifact_platforms(artifacts["float32", 4][0]) == ["cpu"]
    moved = move_to_device_pass(copy.deepcopy(artifacts["float32", 1][1]), "meta")
    assert not any("cpu" in str(n.args) + str(n.kwargs) for n in moved.graph.nodes)
    assert {t.device.type for t in [*moved.state_dict.values(), *moved.constants.values()]} == {"meta"}
    with pytest.raises(ValueError, match=r"exported for platforms \['cpu'\], not 'cuda'"):
        load_step(artifacts["float32", 4][0], device="cuda")
