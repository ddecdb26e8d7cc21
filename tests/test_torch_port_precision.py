"""generate's --matmul_precision in the port (`core.device`) on the CPU.

JAX's `jax_default_matmul_precision` changes nothing on XLA:CPU, and the
port's modes change only the CUDA backends' TF32 flags: generate's output
files are byte-equal in all four modes (the TINY model at 32^2, as in
test_torch_port_generate.py, which holds the port's `float32` run to
JAX's generate.py), and so is the top-k codeword draw, whose distances
are pinned to full f32 as JAX pins them. The mode is process-wide and
sticks: no `resolve_device` call undoes it, `generate.main` restores the
caller's mode when it returns, and `float32`, every other entry point's
mode, leaves torch's backend flags as the port left them before the mode
existed (TF32 off through the `allow_tf32` flags, in a fresh process)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from sgam_neurips22_tpu_torch.core import device
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel
from sgam_neurips22_tpu_torch.models.vqgan.quantize import quantize_topk
from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration, SceneGenConfig
from test_torch_port_generate import RES, _run_port, one_torch_thread  # noqa: F401
from torch_port_common import TINY, make_seed, port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = """
import json, torch
def read(get):
    try:
        return repr(get())
    except Exception as e:
        return type(e).__name__
def flags():
    return {name: read(get) for name, get in (
        ("matmul.allow_tf32", lambda: torch.backends.cuda.matmul.allow_tf32),
        ("cudnn.allow_tf32", lambda: torch.backends.cudnn.allow_tf32),
        ("matmul.fp32_precision", lambda: torch.backends.cuda.matmul.fp32_precision),
        ("cudnn.conv.fp32_precision", lambda: torch.backends.cudnn.conv.fp32_precision),
        ("mkldnn.fp32_precision", lambda: torch.backends.mkldnn.fp32_precision),
        ("float32_matmul_precision", torch.get_float32_matmul_precision))}
"""


@pytest.fixture
def mode_restored():
    yield
    device.set_matmul_precision("float32")


def _tf32():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def test_generate_is_byte_equal_in_every_mode(tmp_path, mode_restored):
    """Seeded random weights (no --ckpt) on a seed template of the reference layout."""
    rng = np.random.default_rng(12)
    tdir = tmp_path / "templates"
    tdir.mkdir()
    Image.fromarray(rng.integers(0, 256, (RES, RES, 3), dtype=np.uint8)).save(tdir / "im_00000_00_00.png")
    np.save(tdir / "dm_00000_00_00.npy", rng.uniform(8, 14, (RES, RES)).astype(np.float32))
    outputs, during = {}, []
    unroll = InfiniteSceneGeneration.scene_expansion

    def recorded(self, *args, **kwargs):  # the mode and flags while generate unrolls
        during.append((device.matmul_precision(), _tf32()))
        return unroll(self, *args, **kwargs)

    for mode in device.MATMUL_PRECISIONS:
        out = tmp_path / mode
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(InfiniteSceneGeneration, "scene_expansion", recorded)
            _run_port(["--template_dir", str(tdir), "--output_dir", str(out), "--resolution", str(RES),
                       "--num_src", "2", "--rows", "2", "--cols", "1", "--matmul_precision", mode])
        tf32 = mode in ("default", "bfloat16")
        assert during[-1] == (mode, (tf32, tf32))
        assert device.matmul_precision() == "float32" and _tf32() == (False, False)  # restored on return
        outputs[mode] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
    assert len(outputs["float32"]) == 9  # two frames' four files and merged_pcds.ply
    for mode in device.MATMUL_PRECISIONS:
        assert outputs[mode] == outputs["float32"], mode


def test_topk_draw_is_equal_in_every_mode(mode_restored):
    g = torch.Generator().manual_seed(0)
    cb, z = torch.randn(64, 16, generator=g), torch.randn(2, 4, 4, 16, generator=g)
    draws = {}
    for mode in device.MATMUL_PRECISIONS:
        device.set_matmul_precision(mode)
        draws[mode] = quantize_topk(cb, z, topk=4, generator=torch.Generator().manual_seed(1))
    for mode in device.MATMUL_PRECISIONS:
        assert all(torch.equal(a, b) for a, b in zip(draws[mode], draws["float32"])), mode


def test_the_mode_sticks_through_resolve_device(mode_restored):
    assert device.matmul_precision() == "float32" and _tf32() == (False, False)
    for mode, tf32 in (("default", True), ("bfloat16", True), ("highest", False), ("float32", False)):
        device.set_matmul_precision(mode)
        assert _tf32() == (tf32, tf32)
        device.resolve_device("cpu")
        model = VQModel(port_config(TINY))
        InfiniteSceneGeneration(model, SceneGenConfig(output_dim=(2, 1), image_resolution=(32, 32)),
                                [((0, 0), *make_seed())], device="cpu")  # resolves its device
        assert device.matmul_precision() == mode and _tf32() == (tf32, tf32), mode
    with pytest.raises(ValueError, match="'tf32' is not one of"):
        device.set_matmul_precision("tf32")


def test_float32_leaves_the_backend_flags_as_before():
    """In a fresh process: the flags after the two assignments that
    `resolve_device` made before the modes, then after `resolve_device` in
    the float32 mode, which must change none of them."""
    code = (FLAGS + "torch.backends.cuda.matmul.allow_tf32 = False\ntorch.backends.cudnn.allow_tf32 = False\n"
            "before = flags()\nfrom sgam_neurips22_tpu_torch.core.device import resolve_device\n"
            "resolve_device('cpu')\nprint(json.dumps([before, flags()]))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=REPO)
    before, now = json.loads(proc.stdout.strip().splitlines()[-1])
    assert now == before
    assert now["matmul.allow_tf32"] == now["cudnn.allow_tf32"] == "False"
