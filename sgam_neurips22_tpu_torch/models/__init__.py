"""The JAX package's `models` names. Its functions of (params, cfg, ...)
are methods of `VQModel` here (`decode`, `decode_features`,
`encode_prequant`, `forward`, `get_last_layer`); `init_vqmodel` is
`VQModel(cfg)` with `core.state_dict.random_state_dict`. `decode_code` is
also a function of the model, as JAX's is of its params."""
from sgam_neurips22_tpu_torch.models.conditioning import Conditioning, get_x
from sgam_neurips22_tpu_torch.models.vqgan.autoencoder import DDConfig
from sgam_neurips22_tpu_torch.models.vqgan.model import (
    ForwardResult,
    VQModel,
    VQModelConfig,
    decode_code,
)
