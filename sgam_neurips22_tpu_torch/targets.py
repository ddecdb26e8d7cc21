"""Registry targets: the names YAML `target:` nodes use — port of
`sgam_neurips22_tpu/targets.py`. The aliases are the reference's dotted
import paths, so its YAML files load unmodified. Importing this module
registers the model and loss factories and, through
`training/data/datamodule.py`, the DataModule."""
from __future__ import annotations

import sgam_neurips22_tpu_torch.training.data.datamodule  # noqa: F401  (registers DataModule)
from sgam_neurips22_tpu_torch.core.registry import register
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModelConfig
from sgam_neurips22_tpu_torch.training.losses import LossConfig


@register("sgam_neurips22_tpu.VQModel", "sgam.generative_sensing_module.model.VQModel")
def make_vqmodel_config(**params) -> VQModelConfig:
    """YAML node -> VQModelConfig (the weights are made apart from it)."""
    data_config = params.pop("data_config", None)
    return VQModelConfig.from_config(params, data_config)


@register(
    "sgam_neurips22_tpu.VQLPIPSWithDiscriminator",
    "sgam.generative_sensing_module.modules.losses.vqperceptual.VQLPIPSWithDiscriminator",
)
def make_loss_config(**params) -> LossConfig:
    return LossConfig.from_dict(params)
