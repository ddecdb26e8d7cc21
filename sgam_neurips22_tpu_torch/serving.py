"""The flagship model configuration — port of `flagship_config` in
`sgam_neurips22_tpu/serving.py` (clevr-infinite only)."""
from __future__ import annotations

from sgam_neurips22_tpu_torch.models.vqgan.autoencoder import DDConfig
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModelConfig


def flagship_config(dataset: str = "clevr-infinite") -> VQModelConfig:
    """Full-size conditional-generation config (reference
    configs/conditional_generation/clevr-infinite.yaml): ch 128, ch_mult
    (1,1,2,2,4), attention at tracked resolution 16, codebook 16384x256,
    clevr-infinite's depth range (7, 16)."""
    if dataset != "clevr-infinite":
        raise NotImplementedError(f"flagship_config({dataset!r}): only clevr-infinite is ported")
    dd = DDConfig(
        ch=128, out_ch=4, ch_mult=(1, 1, 2, 2, 4), num_res_blocks=2,
        attn_resolutions=(16,), resolution=64, z_channels=256, in_channels=4,
    )
    return VQModelConfig(
        ddconfig=dd, n_embed=16384, embed_dim=256,
        phase="conditional_generation", dataset="clevr-infinite", depth_range=(7.0, 16.0),
    )
