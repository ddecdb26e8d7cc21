"""The port's loader on a JAX trainer's orbax checkpoints: a one-step TINY
JAX trainer run (tests/test_trainer.py's make_cfg) saved to orbax makes
`load_inference_params` (shared by generate, serve and the trainer's warm
start) raise the command that exports it, with the run's paths filled in,
for the run directory, its `checkpoints/` and one step directory; the
trainer's warm start raises the same. After `tools/export_torch_ckpt.py`
the port loads the `.ckpt`, and its weights equal `from_jax_params` of the
restored tree."""
import os
import runpy
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from sgam_neurips22_tpu.core.checkpoint import restore_raw_from_path
from sgam_neurips22_tpu_torch.core.config import wrap as t_wrap
from sgam_neurips22_tpu_torch.core.state_dict import from_jax_params
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel, VQModelConfig
from sgam_neurips22_tpu_torch.serving import load_inference_params
from sgam_neurips22_tpu_torch.training import trainer as t_trainer
from test_trainer import make_cfg
from torch_port_common import to_numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dataset(root):
    """tests/test_trainer.py's codebook dataset: 8 random 32^2 frames."""
    rng = np.random.default_rng(0)
    scene = root / "train" / "scene"
    os.makedirs(scene)
    np.save(root / "K.npy", np.array([[20.0, 0, 15.5], [0, 20.0, 15.5], [0, 0, 1]]))
    paths = []
    for i in range(8):
        Image.fromarray(rng.uniform(0, 255, (32, 32, 3)).astype(np.uint8)).save(scene / f"im_{i:05d}.png")
        np.save(scene / f"dm_{i:05d}.npy", rng.uniform(8, 14, (32, 32)).astype(np.float32))
        paths.append(str(scene / f"im_{i:05d}.png"))
    (root / "train.txt").write_text("\n".join(paths))
    (root / "val.txt").write_text("\n".join(paths[:4]))
    return str(root)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """(run directory, its latest step, the model config) of a one-step
    TINY JAX trainer run saved to orbax."""
    from sgam_neurips22_tpu.training.trainer import Trainer

    root = tmp_path_factory.mktemp("orbax")
    cfg = make_cfg(_dataset(root / "data"))
    logdir = str(root / "run")
    tr = Trainer(cfg, logdir, use_wandb=False, max_steps=1, install_signals=False)
    tr.fit(epochs=1)
    tr.ckpt.wait()
    step = int(tr.state["step"])
    tr.metrics.close()
    model_cfg = VQModelConfig.from_config(t_wrap(cfg.to_plain()).model.params.to_plain(), cfg.data.params.to_plain())
    return logdir, step, model_cfg


def test_orbax_run_raises_the_export_command(jax_run, tmp_path):
    logdir, step, model_cfg = jax_run
    model = VQModel(model_cfg)
    out = os.path.join(logdir, "exported_last.ckpt")
    for path, extra in ((logdir, ""), (os.path.join(logdir, "checkpoints"), ""),
                        (os.path.join(logdir, "checkpoints", str(step)), f" --step {step}")):
        with pytest.raises(ValueError) as e:
            load_inference_params(path, model)
        assert f"python tools/export_torch_ckpt.py {logdir} --out {out}{extra}" in str(e.value), path
    cfg = t_wrap(make_cfg(str(tmp_path)).to_plain())
    cfg.model.params.ckpt_path = logdir
    with pytest.raises(ValueError, match="tools/export_torch_ckpt.py"):
        t_trainer.Trainer(cfg, str(tmp_path / "warm"), use_wandb=False, device="cpu", install_signals=False)


def test_exported_orbax_run_loads_the_jax_weights(jax_run, monkeypatch, capsys):
    logdir, _, model_cfg = jax_run
    out = os.path.join(logdir, "exported_last.ckpt")
    monkeypatch.setattr(sys, "argv", ["export_torch_ckpt.py", logdir, "--out", out])
    runpy.run_path(os.path.join(REPO, "tools", "export_torch_ckpt.py"), run_name="__main__")
    assert "wrote" in capsys.readouterr().out
    model = load_inference_params(out, VQModel(model_cfg))
    want = from_jax_params(to_numpy_tree(restore_raw_from_path(logdir)["params"]))
    got = model.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        assert torch.equal(got[name], torch.as_tensor(np.asarray(value))), name
