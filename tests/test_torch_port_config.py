"""The port's config system (`core/config.py`), registry and targets against
the JAX package's: every YAML under configs/ loads to the same plain tree,
dotlist overrides take the same YAML typing, a saved config loads back as
it was (also through JAX's loader), and the registry targets build model
and loss configurations equal to JAX's field by field. All exact."""
import dataclasses
import glob
import os

import pytest
import yaml

import sgam_neurips22_tpu.targets  # noqa: F401  (registers JAX's targets)
import sgam_neurips22_tpu_torch.targets  # noqa: F401  (registers the port's)
from sgam_neurips22_tpu.core import config as j_config
from sgam_neurips22_tpu.core import registry as j_registry
from sgam_neurips22_tpu.training import trainer as j_trainer
from sgam_neurips22_tpu_torch.core import config as t_config
from sgam_neurips22_tpu_torch.core import registry as t_registry
from sgam_neurips22_tpu_torch.training import trainer as t_trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))
# JAX DDConfig fields the port has no field for: the port picks flash
# attention by batch, and the other three must hold these values
PORT_ABSENT_DD = {"flash_attention", "double_z", "dropout", "resamp_with_conv"}


def test_configs_found():
    assert len(CONFIGS) == 4


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_load_configs_matches_jax(path):
    got = t_config.load_configs([path]).to_plain()
    assert got == j_config.load_configs([path]).to_plain()
    with open(path) as f:
        assert got == yaml.safe_load(f)


def test_merge_and_dotlist_match_jax():
    base, over = CONFIGS[0], CONFIGS[1]
    dotlist = ["model.base_learning_rate=1e-4", "data.params.depth_range=[7,16]", "model.params.ddconfig.remat=true",
               "model.params.ckpt_path=null", "data.params.dataset_dir=/x/y", "new.key.path=3", "a=b=c"]
    got = t_config.load_configs([base, over], dotlist)
    want = j_config.load_configs([base, over], dotlist)
    assert got.to_plain() == want.to_plain()
    # YAML 1.1 (PyYAML, on both sides) reads 1e-4 as a string, 1.0e-4 as a float
    assert got.model.base_learning_rate == "1e-4"
    assert t_config.apply_dotlist(t_config.ConfigDict(), ["lr=1.0e-4"]).lr == 1e-4
    assert t_trainer.train_config_from_yaml(got).learning_rate == 1e-4
    assert got.data.params.depth_range == [7, 16]
    assert got.model.params.ddconfig.remat is True and got.model.params.ckpt_path is None
    assert got.get_path("new.key.path") == 3 and got.a == "b=c" and got.get_path("no.such", 5) == 5
    with pytest.raises(ValueError, match="key=value"):
        t_config.apply_dotlist(t_config.ConfigDict(), ["novalue"])


@pytest.mark.parametrize("path", CONFIGS[:2], ids=lambda p: os.path.relpath(p, REPO))
def test_yaml_round_trip(path, tmp_path):
    cfg = t_config.load_configs([path], ["data.params.dataset_dir=/data/x"])
    out = str(tmp_path / "config.yaml")
    t_config.save_yaml(cfg, out)
    assert t_config.load_yaml(out).to_plain() == cfg.to_plain()
    assert j_config.load_yaml(out).to_plain() == cfg.to_plain()
    copy = cfg.copy()
    copy.model.params.n_embed = 1
    assert cfg.model.params.n_embed != 1


def _same_fields(port_obj, jax_obj, absent=()):
    j = dataclasses.asdict(jax_obj) if dataclasses.is_dataclass(jax_obj) else jax_obj._asdict()
    p = dataclasses.asdict(port_obj) if dataclasses.is_dataclass(port_obj) else port_obj._asdict()
    for k, v in j.items():
        if k in absent:
            continue
        assert p[k] == v, k
    return set(j) - set(p)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_registry_targets_match_jax(path):
    cfg = t_config.load_configs([path])
    model_node = {"target": cfg.model.target, "params": {**cfg.model.params, "data_config": cfg.data.params}}
    jm = j_registry.instantiate_from_config(model_node)
    tm = t_registry.instantiate_from_config(model_node)
    assert _same_fields(tm.ddconfig, jm.ddconfig, PORT_ABSENT_DD) == PORT_ABSENT_DD
    jm_top = {f.name: getattr(jm, f.name) for f in dataclasses.fields(jm) if f.name != "ddconfig"}
    assert {k: getattr(tm, k) for k in jm_top} == jm_top
    loss_node = cfg.model.params.lossconfig
    assert dataclasses.asdict(t_registry.instantiate_from_config(loss_node)) == dataclasses.asdict(
        j_registry.instantiate_from_config(loss_node))
    for alias in ("sgam.generative_sensing_module.model.VQModel", "data.utils.utils.DataModuleFromConfig",
                  "sgam.generative_sensing_module.modules.losses.vqperceptual.VQLPIPSWithDiscriminator"):
        assert alias in t_registry.known_targets()
    with pytest.raises(KeyError, match="unknown target"):
        t_registry.get("no.such.Target")


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_train_config_from_yaml_matches_jax(path):
    overrides = ["model.params.lr_scheduler_config.warm_up_steps=5", "model.params.lr_scheduler_config.lr_max=0.5"]
    for dotlist in ([], overrides):
        cfg = t_config.load_configs([path], dotlist)
        got, want = t_trainer.train_config_from_yaml(cfg), j_trainer.train_config_from_yaml(cfg)
        assert got.learning_rate == want.learning_rate and got.use_vq == want.use_vq
        assert got.splat_collision == want.splat_collision
        assert got.accumulate_grad_batches == want.accumulate_grad_batches
        assert dataclasses.asdict(got.online_kmeans) == dataclasses.asdict(want.online_kmeans)
        assert (got.lr_scheduler is None) == (want.lr_scheduler is None) == (not dotlist)
        if dotlist:
            assert dataclasses.asdict(got.lr_scheduler) == dataclasses.asdict(want.lr_scheduler)
        assert dataclasses.asdict(got.loss) == dataclasses.asdict(want.loss)


def test_unsupported_ddconfig_values_raise():
    from sgam_neurips22_tpu_torch.models.vqgan.autoencoder import DDConfig

    for key, val in (("double_z", True), ("dropout", 0.1), ("resamp_with_conv", False)):
        with pytest.raises(ValueError, match=key):
            DDConfig.from_dict({key: val})
